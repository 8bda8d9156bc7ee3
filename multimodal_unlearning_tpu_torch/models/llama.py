"""Llama-family decoder (RMSNorm + RoPE + SwiGLU + GQA) in PyTorch.

Counterpart of ``multimodal_unlearning_tpu/models/llama.py`` for serving,
dense weights only.  Parameters keep the JAX layout (``models/params.py``):
``[in, out]`` weights stacked on a leading L dimension.  The forward loops
over the layers where the JAX package scans them.

Modes of ``forward``:
  no cache: ``kv_cache=None``; causal attention over the padded batch with
    ``attention_mask`` as key validity.
  prefill: ``kv_cache`` a [L,B,Hkv,S,D] slab written at column offset 0;
    attention reads the just-computed local k/v, identical to reading the
    slab back.
  decode: one token per row; ``cache_offset`` a [B] tensor of per-row cache
    columns; attention reads the stacked cache through ``kv_valid_mask``
    (ops/decode_attention.py).

Unlike the JAX package, the cache is updated in place: the dict passed in
is the dict returned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_unlearning_tpu_torch.config import LlamaConfig
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models.params import ParamTree
from multimodal_unlearning_tpu_torch.ops.attention import flash_attention
from multimodal_unlearning_tpu_torch.ops.decode_attention import decode_attention
from multimodal_unlearning_tpu_torch.ops.rope import apply_rope_bsd, rope_table

__all__ = ["LlamaConfig", "Llama", "init_params", "rms_norm", "dense", "init_kv_cache",
           "positions_from_mask"]


def _promote(dtype):
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x, weight, eps):
    # upcast, normalise, cast back, then multiply by the weight (HF
    # LlamaRMSNorm order)
    x32 = x.to(_promote(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def dense(x, w):
    return x @ w.to(x.dtype)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Dense KV cache {"k", "v"} of [L, B, Hkv, max_len, D] zeros."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise NotImplementedError(f"KV cache dtype {dtype} is not ported (dense float only)")
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _cache_write(cache, k, v, layer, offset):
    """Write [B,H,S,D] k/v into layer ``layer`` of the stacked cache at
    column ``offset`` (an int), or per row at ``offset[b]`` (a [B] tensor)."""
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        return _cache_write_per_row(cache, k, v, layer, offset)
    offset = int(offset)
    S = k.shape[2]
    cache["k"][layer, :, :, offset:offset + S] = k.to(cache["k"].dtype)
    cache["v"][layer, :, :, offset:offset + S] = v.to(cache["v"].dtype)
    return cache


def _cache_write_per_row(cache, k, v, layer, offset):
    """Row b's C tokens land at columns offset[b] .. offset[b]+C-1 (C == 1
    is the continuous-batching decode step)."""
    rows = torch.arange(k.shape[0], device=k.device)
    for c in range(k.shape[2]):
        cache["k"][layer, rows, :, offset + c] = k[:, :, c].to(cache["k"].dtype)
        cache["v"][layer, rows, :, offset + c] = v[:, :, c].to(cache["v"].dtype)
    return cache


def positions_from_mask(attention_mask):
    """Absolute positions under left/right padding: cumsum of validity."""
    return torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)


class Llama(ParamTree):
    """Decoder parameters at the JAX tree's paths (embed_tokens, layers.*,
    norm, lm_head) plus the f32 rope tables."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=torch.float32):
        dev = resolve_device(device)
        h, i, d, L = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.num_layers
        kvh = cfg.num_kv_heads * d
        super().__init__({
            "embed_tokens": (cfg.vocab_size, h),
            "layers": {
                "input_layernorm": (L, h),
                "q_proj": (L, h, h),
                "k_proj": (L, h, kvh),
                "v_proj": (L, h, kvh),
                "o_proj": (L, h, h),
                "post_attention_layernorm": (L, h),
                "gate_proj": (L, h, i),
                "up_proj": (L, h, i),
                "down_proj": (L, i, h),
            },
            "norm": (h,),
            "lm_head": (h, cfg.vocab_size),
        }, device=dev, dtype=dtype)
        self.cfg = cfg
        cos, sin = rope_table(cfg.max_position_embeddings, d, cfg.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Llama":
        """Random init with the JAX package's distributions: weights
        N(0, 1/fan_in), embeddings N(0, 0.02^2), norms 1."""
        lp = self.layers
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj"):
            w = getattr(lp, name)
            w.normal_(0.0, w.shape[-2] ** -0.5, generator=generator)
        lp.input_layernorm.fill_(1.0)
        lp.post_attention_layernorm.fill_(1.0)
        self.embed_tokens.normal_(0.0, 0.02, generator=generator)
        self.norm.fill_(1.0)
        self.lm_head.normal_(0.0, self.lm_head.shape[-2] ** -0.5, generator=generator)
        return self

    def _block(self, x, layer, cos_p, sin_p, kv_cache, cache_offset, kv_mask, decoding,
               attn_impl):
        cfg, lp = self.cfg, self.layers
        B, S, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        h = rms_norm(x, lp.input_layernorm[layer], cfg.rms_norm_eps)
        q = dense(h, lp.q_proj[layer]).view(B, S, nh, hd).transpose(1, 2)
        k = dense(h, lp.k_proj[layer]).view(B, S, nkv, hd).transpose(1, 2)
        v = dense(h, lp.v_proj[layer]).view(B, S, nkv, hd).transpose(1, 2)
        q = apply_rope_bsd(q, cos_p, sin_p)
        k = apply_rope_bsd(k, cos_p, sin_p)
        if kv_cache is not None:
            # the cache is written BEFORE attention: decode reads it back
            _cache_write(kv_cache, k, v, layer, cache_offset)
        if decoding:
            attn = decode_attention(q, kv_cache, layer, kv_mask, impl=attn_impl)
        else:
            attn = flash_attention(
                q, k.to(q.dtype), v.to(q.dtype),
                kv_mask if kv_mask.shape[1] == S else kv_mask[:, :S],
                causal=True, impl=attn_impl)
        attn = attn.transpose(1, 2).reshape(B, S, nh * hd)
        x = x + dense(attn, lp.o_proj[layer])
        h = rms_norm(x, lp.post_attention_layernorm[layer], cfg.rms_norm_eps)
        gate = dense(h, lp.gate_proj[layer])
        up = dense(h, lp.up_proj[layer])
        ff = F.silu(gate.to(_promote(gate.dtype))).to(x.dtype) * up
        return x + dense(ff, lp.down_proj[layer])

    def forward(self, input_ids=None, *, inputs_embeds=None, attention_mask=None,
                positions=None, kv_cache=None, cache_offset=0, kv_valid_mask=None,
                attn_impl: str = "auto", compute_dtype=torch.bfloat16, logits_dtype=None,
                last_logit_only: bool = False) -> dict:
        """Returns {"logits": [B, S or 1, V], "kv_cache": the cache or None}."""
        cfg = self.cfg
        if logits_dtype is None:
            logits_dtype = _promote(compute_dtype)
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens[input_ids]
        x = inputs_embeds.to(compute_dtype)
        B, S, _ = x.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=x.device)
        if positions is None:
            if kv_cache is None:
                # HF plain-forward convention: arange regardless of padding
                positions = torch.arange(S, device=x.device).expand(B, S)
            else:
                # generation: mask-aware positions, as HF generate
                positions = positions_from_mask(attention_mask)
        positions = positions.long()
        cos_p, sin_p = self.rope_cos[positions], self.rope_sin[positions]  # [B, S, D]

        decoding = kv_cache is not None and S == 1
        if kv_cache is not None and not decoding and not (
                isinstance(cache_offset, int) and cache_offset == 0):
            raise NotImplementedError(
                "a multi-token pass into the cache must start at column 0 (chunked "
                "prefill and speculative verify are not ported)")
        kv_mask = kv_valid_mask if kv_valid_mask is not None else attention_mask
        for layer in range(cfg.num_layers):
            x = self._block(x, layer, cos_p, sin_p, kv_cache, cache_offset, kv_mask,
                            decoding, attn_impl)
        return self._epilogue(x, logits_dtype, last_logit_only, kv_cache)

    def _epilogue(self, x, logits_dtype, last_logit_only, kv_cache):
        """Final norm + LM head; f32 logits after a head in the compute dtype."""
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        xh = x[:, -1:] if last_logit_only else x
        logits = dense(xh, self.lm_head).to(logits_dtype)
        return {"logits": logits, "kv_cache": kv_cache}


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None, *,
                device=None, dtype=torch.float32) -> Llama:
    """A randomly initialised decoder on ``device`` (the card by default)."""
    model = Llama(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=model.norm.device).manual_seed(0)
    return model.init_params(generator)
