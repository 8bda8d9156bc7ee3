"""CLIP-style ViT vision tower (pre-LN, quick-GELU, CLS token) in PyTorch.

Counterpart of ``multimodal_unlearning_tpu/models/vit.py``.  The JAX
forward pads the 577-token sequence to 640 with a validity mask because
Mosaic needs lane-aligned blocks; the port's flash kernel takes any length,
so the sequence runs unpadded (the masked columns added exactly 0).
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.config import VitConfig
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models.params import ParamTree
from multimodal_unlearning_tpu_torch.ops.attention import flash_attention

__all__ = ["VitConfig", "Vit", "layer_norm", "quick_gelu", "patchify"]


def _promote(dtype):
    return torch.promote_types(dtype, torch.float32)


def layer_norm(x, scale, bias, eps):
    x32 = x.to(_promote(x.dtype))
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x.to(_promote(x.dtype))).to(x.dtype)


def patchify(pixel_values, patch_size: int):
    """[B, H, W, 3] -> [B, N, P*P*3] as a pure reshape (feeds one matmul)."""
    B, H, W, C = pixel_values.shape
    nh, nw = H // patch_size, W // patch_size
    x = pixel_values.reshape(B, nh, patch_size, nw, patch_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, nh, nw, P, P, C]
    return x.reshape(B, nh * nw, patch_size * patch_size * C)


class Vit(ParamTree):
    """Vision-tower parameters at the JAX tree's paths."""

    def __init__(self, cfg: VitConfig, *, device=None, dtype=torch.float32):
        dev = resolve_device(device)
        h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        p3 = cfg.patch_size * cfg.patch_size * 3
        ln = {"scale": (L, h), "bias": (L, h)}
        super().__init__({
            "patch_embed": (p3, h),
            "class_embed": (h,),
            "pos_embed": (cfg.seq_len, h),
            "pre_ln": {"scale": (h,), "bias": (h,)},
            "layers": {
                "ln1": ln,
                "q_proj": (L, h, h), "q_bias": (L, h),
                "k_proj": (L, h, h), "k_bias": (L, h),
                "v_proj": (L, h, h), "v_bias": (L, h),
                "o_proj": (L, h, h), "o_bias": (L, h),
                "ln2": ln,
                "fc1": (L, h, i), "fc1_bias": (L, i),
                "fc2": (L, i, h), "fc2_bias": (L, h),
            },
            "post_ln": {"scale": (h,), "bias": (h,)},
        }, device=dev, dtype=dtype)
        self.cfg = cfg

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Vit":
        lp = self.layers
        self.patch_embed.normal_(0.0, self.patch_embed.shape[-2] ** -0.5, generator=generator)
        self.class_embed.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for w_name, b_name in (("q_proj", "q_bias"), ("k_proj", "k_bias"), ("v_proj", "v_bias"),
                               ("o_proj", "o_bias"), ("fc1", "fc1_bias"), ("fc2", "fc2_bias")):
            w = getattr(lp, w_name)
            w.normal_(0.0, w.shape[-2] ** -0.5, generator=generator)
            getattr(lp, b_name).zero_()
        for ln in (self.pre_ln, lp.ln1, lp.ln2, self.post_ln):
            ln.scale.fill_(1.0)
            ln.bias.zero_()
        return self

    def _block(self, x, layer, attn_impl):
        cfg, lp = self.cfg, self.layers
        B, S, H = x.shape
        nh = cfg.num_heads
        hd = H // nh
        h = layer_norm(x, lp.ln1.scale[layer], lp.ln1.bias[layer], cfg.layer_norm_eps)

        def heads(w, b):
            return (h @ w[layer].to(h.dtype) + b[layer]).view(B, S, nh, hd).transpose(1, 2)

        q = heads(lp.q_proj, lp.q_bias)
        k = heads(lp.k_proj, lp.k_bias)
        v = heads(lp.v_proj, lp.v_bias)
        attn = flash_attention(q, k, v, None, causal=False, impl=attn_impl)
        attn = attn.transpose(1, 2).reshape(B, S, H)
        x = x + attn @ lp.o_proj[layer].to(h.dtype) + lp.o_bias[layer]
        h = layer_norm(x, lp.ln2.scale[layer], lp.ln2.bias[layer], cfg.layer_norm_eps)
        h = quick_gelu(h @ lp.fc1[layer].to(h.dtype) + lp.fc1_bias[layer])
        return x + h @ lp.fc2[layer].to(h.dtype) + lp.fc2_bias[layer]

    def forward(self, pixel_values, *, feature_layer: int = -2, attn_impl: str = "auto",
                compute_dtype=torch.bfloat16):
        """Encode [B, H, W, 3] images; returns [B, 1 + N, H] hidden states at
        ``feature_layer`` (HF hidden_states indexing: -1 after the last
        block, -2 after the penultimate one, LLaVA's choice).  All layers
        run, as in the JAX package."""
        cfg = self.cfg
        B = pixel_values.shape[0]
        patches = patchify(pixel_values.to(compute_dtype), cfg.patch_size)
        x = patches @ self.patch_embed.to(compute_dtype)
        cls = self.class_embed.to(compute_dtype).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(compute_dtype)
        x = layer_norm(x, self.pre_ln.scale, self.pre_ln.bias, cfg.layer_norm_eps)

        L = cfg.num_layers
        # hidden_states[0] = embeddings, hidden_states[i] = after block i-1
        h_index = (L + 1 + feature_layer) if feature_layer < 0 else feature_layer
        captured = x
        for layer in range(L):
            x = self._block(x, layer, attn_impl)
            if layer == h_index - 1:
                captured = x
        return x if h_index >= L else captured

