"""Qwen2-VL / Qwen2.5-VL in PyTorch: a NaViT vision tower with a
PatchMerger, and a Qwen2 decoder (``models/llama.py`` with q/k/v biases)
under 3-D M-RoPE.

Counterpart of ``multimodal_unlearning_tpu/models/qwen2_vl.py``:

- the tower takes pre-patchified pixels [B, N, C*T*P*P] (the
  Qwen2VLImageProcessor flatten order, ``data/processor.qwen_patchify``)
  at one static (t, h, w) grid per batch, with 2-D rotary embeddings over
  the merge-block patch order;
- version "2": LayerNorm and a quick-GELU MLP, every block attends over the
  whole grid (kernel B1, head dim 80 at Qwen2-VL-2B, no mask);
- version "2.5": RMSNorm and a biased SwiGLU MLP; every block but
  ``fullatt_block_indexes`` attends within windows of ``window_size``
  pixels: the patches are permuted into window order once
  (``_window_partition``, a numpy function of the grid), a windowed block
  folds the windows into the batch (B1 at [B*W, heads, Lw, 80] with a
  per-window mask, ragged windows right-padded) and the merger's output is
  put back in raster order;
- the PatchMerger (norm, 2x2 group, two-layer exact-GELU MLP) carries the
  model's ``projector`` LoRA adapters;
- ``mrope_positions`` gives the decoder's [3, B, S] positions and each
  row's ``rope_delta``; a caller that continues with 2-D positions (decode,
  chunk passes) adds ``rope_delta`` to them, so text after an image
  continues at the image's extent, not at the token count.

A frozen tower's blocks run without building a graph and only the merger
runs under autograd, so that its adapters get gradients; a tower whose
leaves require gradients (``LoRA.r=0`` with ``freeze_vision_module=false``)
builds one, and its attention's backward runs kernels B2 and B3 at head dim
80.  The tower is not rematerialised, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_unlearning_tpu_torch.config import QwenVisionConfig, QwenVLConfig
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import llama
from multimodal_unlearning_tpu_torch.models.llava import splice_image_embeds
from multimodal_unlearning_tpu_torch.models.params import ParamTree, trains
from multimodal_unlearning_tpu_torch.models.vit import layer_norm, quick_gelu
from multimodal_unlearning_tpu_torch.ops.attention import flash_attention
from multimodal_unlearning_tpu_torch.utils.quantize import embed_lookup, is_qtensor

__all__ = ["QwenVisionConfig", "QwenVLConfig", "QwenVisionTower", "QwenVL", "init_params",
           "vision_forward", "mrope_positions"]


def _vision_rope(cfg: QwenVisionConfig, grid: tuple, device):
    """(cos, sin) [N, head_dim] f32 for the merge-block patch order."""
    t, h, w = grid
    ms = cfg.spatial_merge_size
    # patch order: (t, h_block, w_block, merge_h, merge_w)
    hb, wb = np.meshgrid(np.arange(h // ms), np.arange(w // ms), indexing="ij")
    a, b = np.meshgrid(np.arange(ms), np.arange(ms), indexing="ij")
    h_ids = np.tile((hb[:, :, None, None] * ms + a[None, None]).reshape(-1), t)
    w_ids = np.tile((wb[:, :, None, None] * ms + b[None, None]).reshape(-1), t)
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.concatenate([np.outer(h_ids, inv_freq), np.outer(w_ids, inv_freq)], axis=-1)
    emb = torch.from_numpy(np.concatenate([freqs, freqs], axis=-1).astype(np.float32))
    return emb.cos().to(device), emb.sin().to(device)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _window_partition(cfg: QwenVisionConfig, grid: tuple):
    """Qwen2.5-VL's window partition (HF ``get_window_index``), a function
    of the static grid.  Returns ``(patch_perm, gather, gmask, inv_scatter,
    inv_perm, uniform)``:

    - patch_perm [N]: takes the patches (merge-block order) into window
      order; the merge_size^2 patches of a merge unit move together;
    - gather [W, Lw]: each window's indices into the permuted sequence,
      right-padded with its last valid index;
    - gmask [W, Lw]: 1 where ``gather`` holds a real patch;
    - inv_scatter [N]: the flat (w*Lw + l) slot of each permuted patch, so a
      windowed block's output returns to the permuted order by one gather;
    - inv_perm [U]: the merged tokens' inverse permutation, applied after
      the PatchMerger to restore raster order;
    - uniform: every window is full (``gather`` is a reshape)."""
    t, h, w = grid
    ms = cfg.spatial_merge_size
    lh, lw = h // ms, w // ms
    vit_win = cfg.window_size // ms // cfg.patch_size
    unit = ms * ms
    idx = np.arange(t * lh * lw).reshape(t, lh, lw)
    pad_h, pad_w = (-lh) % vit_win, (-lw) % vit_win
    idx_p = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
    idx_p[:, :lh, :lw] = idx
    nwh, nww = (lh + pad_h) // vit_win, (lw + pad_w) // vit_win
    idx_p = (idx_p.reshape(t, nwh, vit_win, nww, vit_win).transpose(0, 1, 3, 2, 4)
             .reshape(t * nwh * nww, vit_win * vit_win))
    seqlens = (idx_p != -100).sum(axis=1)  # merge units per window
    flat = idx_p.reshape(-1)
    perm = flat[flat != -100]  # [U] merge units in window order
    lens = seqlens[seqlens > 0] * unit  # patches per non-empty window
    U, Wn, Lw = perm.shape[0], lens.shape[0], int(lens.max())
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    gather = np.zeros((Wn, Lw), np.int64)
    gmask = np.zeros((Wn, Lw), np.int32)
    for i in range(Wn):
        gather[i, :lens[i]] = np.arange(starts[i], starts[i] + lens[i])
        gather[i, lens[i]:] = starts[i] + lens[i] - 1
        gmask[i, :lens[i]] = 1
    inv_scatter = np.empty(U * unit, np.int64)
    pos = np.arange(Wn)[:, None] * Lw + np.arange(Lw)[None, :]
    inv_scatter[gather[gmask == 1]] = pos[gmask == 1]
    patch_perm = (perm[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    uniform = bool(gmask.all()) and Wn * Lw == U * unit
    return patch_perm, gather, gmask, inv_scatter, np.argsort(perm), uniform


class QwenVisionTower(ParamTree):
    """The tower's parameters at the JAX tree's paths: ``patch_embed``,
    ``blocks.*`` (stacked on the depth) and ``merger.*``."""

    def __init__(self, cfg: QwenVisionConfig, *, device=None, dtype=torch.float32):
        dev = resolve_device(device)
        E, L, M = cfg.embed_dim, cfg.depth, cfg.mlp_hidden
        blocks = {"q_proj": (L, E, E), "q_bias": (L, E), "k_proj": (L, E, E), "k_bias": (L, E),
                  "v_proj": (L, E, E), "v_bias": (L, E), "o_proj": (L, E, E), "o_bias": (L, E)}
        if cfg.version == "2.5":
            blocks.update({"ln1": {"scale": (L, E)}, "ln2": {"scale": (L, E)},
                           "gate": (L, E, M), "gate_bias": (L, M), "up": (L, E, M),
                           "up_bias": (L, M), "down": (L, M, E), "down_bias": (L, E)})
            merger_ln = {"scale": (E,)}
        else:
            ln = {"scale": (L, E), "bias": (L, E)}
            blocks.update({"ln1": ln, "ln2": dict(ln), "fc1": (L, E, M), "fc1_bias": (L, M),
                           "fc2": (L, M, E), "fc2_bias": (L, E)})
            merger_ln = {"scale": (E,), "bias": (E,)}
        md = cfg.merge_dim
        super().__init__({
            "patch_embed": (cfg.patch_dim, E),
            "blocks": blocks,
            "merger": {"ln_q": merger_ln, "fc1": (md, md), "fc1_bias": (md,),
                       "fc2": (md, cfg.out_hidden_size), "fc2_bias": (cfg.out_hidden_size,)},
        }, device=dev, dtype=dtype)
        self.cfg = cfg

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "QwenVisionTower":
        """The JAX package's distributions: weights N(0, 1/fan_in), biases
        0, norm scales 1."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias" or leaf.endswith("_bias"):
                p.zero_()
            else:
                p.normal_(0.0, p.shape[-2] ** -0.5, generator=generator)
        return self


def vision_forward(tower: QwenVisionTower, cfg: QwenVisionConfig, patches, *, grid: tuple,
                   attn_impl: str = "auto", compute_dtype=torch.bfloat16, merger_lora=None,
                   lora_scale: float = 0.0, lora_ids=None):
    """Encode pre-patchified images [B, N, patch_dim] (one image per row,
    all at the static ``grid``) -> merged features [B, N // merge^2,
    out_hidden_size].  The blocks run under autograd when a leaf of the
    patch embedding or the blocks requires a gradient, else without; the
    merger (and its ``merger_lora`` adapters ``{"fc1", "fc2"}``, or a bank
    of them selected per row by ``lora_ids``) always with it."""
    B, N, _ = patches.shape
    E, nh, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    is25 = cfg.version == "2.5"
    windowed = is25 and cfg.window_size > 0
    dev = patches.device
    cos, sin = _vision_rope(cfg, grid, dev)
    if windowed:
        patch_perm, gather, gmask, inv_scatter, inv_perm, uniform = _window_partition(cfg, grid)
        perm_t = torch.from_numpy(patch_perm).to(dev)
        cos, sin = cos[perm_t], sin[perm_t]
        Wn, Lw = gather.shape
        gather_t = torch.from_numpy(gather).to(dev)
        inv_scatter_t = torch.from_numpy(inv_scatter).to(dev)
        wmask = torch.from_numpy(gmask).to(dev)[None].expand(B, Wn, Lw).reshape(B * Wn, Lw)
    bp = tower.blocks

    def rope(q):  # [B, nh, N, hd]: an f32 rotation, as HF's vision path
        q32 = q.to(torch.float32)
        return (q32 * cos + _rotate_half(q32) * sin).to(q.dtype)

    def norm(h, ln, layer):
        if is25:
            return llama.rms_norm(h, ln.scale[layer], eps)
        return layer_norm(h, ln.scale[layer], ln.bias[layer], eps)

    def win_attn(q, k, v):
        if uniform:  # the windows tile the permuted sequence: a reshape
            def gw(z):
                return z.reshape(B, nh, Wn, Lw, hd).transpose(1, 2).reshape(B * Wn, nh, Lw, hd)
        else:  # ragged windows: a gather, right padding masked
            def gw(z):
                return z[:, :, gather_t].transpose(1, 2).reshape(B * Wn, nh, Lw, hd)
        ow = flash_attention(gw(q), gw(k), gw(v), wmask, causal=False, impl=attn_impl)
        ow = ow.reshape(B, Wn, nh, Lw, hd).transpose(1, 2).reshape(B, nh, Wn * Lw, hd)
        return ow if uniform else ow[:, :, inv_scatter_t]

    def block(x, layer):
        h = norm(x, bp.ln1, layer)

        def heads(w, b):
            return (h @ w[layer].to(h.dtype) + b[layer]).reshape(B, N, nh, hd).transpose(1, 2)

        q = rope(heads(bp.q_proj, bp.q_bias))
        k = rope(heads(bp.k_proj, bp.k_bias))
        v = heads(bp.v_proj, bp.v_bias)
        if windowed and layer not in cfg.fullatt_block_indexes:
            attn = win_attn(q, k, v)
        else:
            attn = flash_attention(q, k, v, None, causal=False, impl=attn_impl)
        attn = attn.transpose(1, 2).reshape(B, N, E)
        x = x + attn @ bp.o_proj[layer].to(h.dtype) + bp.o_bias[layer]
        h = norm(x, bp.ln2, layer)
        if is25:  # biased SwiGLU
            g = h @ bp.gate[layer].to(h.dtype) + bp.gate_bias[layer]
            u = h @ bp.up[layer].to(h.dtype) + bp.up_bias[layer]
            return x + (F.silu(g) * u) @ bp.down[layer].to(h.dtype) + bp.down_bias[layer]
        h = quick_gelu(h @ bp.fc1[layer].to(h.dtype) + bp.fc1_bias[layer])
        return x + h @ bp.fc2[layer].to(h.dtype) + bp.fc2_bias[layer]

    with torch.set_grad_enabled(torch.is_grad_enabled() and trains(tower, skip="merger")):
        x = patches.to(compute_dtype) @ tower.patch_embed.to(compute_dtype)
        if windowed:
            x = x[:, perm_t]
        for layer in range(cfg.depth):
            x = block(x, layer)

    m = tower.merger

    def dense(z, name):
        y = z @ getattr(m, name).to(z.dtype) + getattr(m, f"{name}_bias")
        ab = merger_lora.get(name) if merger_lora is not None else None
        return llama.apply_lora_delta(y, z, ab, lora_scale, lora_ids)

    if is25:
        y = llama.rms_norm(x, m.ln_q.scale, eps)
    else:
        y = layer_norm(x, m.ln_q.scale, m.ln_q.bias, eps)
    y = y.reshape(B, N // cfg.spatial_merge_size ** 2, cfg.merge_dim)
    y = dense(y, "fc1")
    y = F.gelu(y.to(torch.promote_types(y.dtype, torch.float32)), approximate="none").to(
        x.dtype)
    y = dense(y, "fc2")
    if windowed:  # the merged tokens back in raster order
        y = y[:, torch.from_numpy(inv_perm).to(dev)]
    return y


def mrope_positions(input_ids, attention_mask, image_token_id: int, grid_merged: tuple):
    """3-D rope positions [3, B, S] and each row's ``rope_delta`` [B] (HF
    ``get_rope_index``, one contiguous image span a row; a row without an
    image gets three equal streams and delta 0).  The image's tokens take
    (t, h, w) grid positions from the span's start; text after it continues
    at the start plus max(t, Hm, Wm)."""
    t, Hm, Wm = grid_merged
    valid = attention_mask.to(torch.long)
    is_img = (input_ids == image_token_id) & (valid == 1)
    n_img = is_img.long().sum(dim=1, keepdim=True)
    cum_img = torch.cumsum(is_img.long(), dim=1)
    n_before = ((cum_img == 0) & (valid == 1)).long().sum(dim=1, keepdim=True)
    pos1d = torch.cumsum(valid, dim=1) - 1
    idx_in_img = torch.clamp(cum_img - 1, min=0)
    per_frame = Hm * Wm
    t_id = idx_in_img // per_frame
    h_id = (idx_in_img % per_frame) // Wm
    w_id = idx_in_img % Wm
    after_pos = n_before + max(Hm, Wm, t) + (pos1d - (n_before + n_img))
    text_pos = torch.where((cum_img > 0) & ~is_img, after_pos, pos1d)
    pos_t = torch.where(is_img, n_before + t_id, text_pos)
    pos_h = torch.where(is_img, n_before + h_id, text_pos)
    pos_w = torch.where(is_img, n_before + w_id, text_pos)
    positions = torch.clamp(torch.stack([pos_t, pos_h, pos_w]), min=0)
    max_pos = torch.where(valid[None] == 1, positions, -1).amax(dim=(0, 2))
    rope_delta = max_pos + 1 - valid.sum(dim=1)
    return positions, rope_delta


class QwenVL(nn.Module):
    """language_model (a Qwen2 decoder: ``llama.Llama`` with q/k/v biases
    and M-RoPE) and vision_tower (``QwenVisionTower``, the merger inside)
    at the JAX tree's paths."""

    def __init__(self, cfg: QwenVLConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.language_model = llama.Llama(cfg.decoder, device=dev, dtype=dtype)
        self.vision_tower = QwenVisionTower(cfg.vision, device=dev, dtype=dtype)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "QwenVL":
        self.language_model.init_params(generator)
        self.vision_tower.init_params(generator)
        return self

    def forward(self, input_ids, *, pixel_values=None, attention_mask=None, positions=None,
                kv_cache=None, cache_offset=0, kv_valid_mask=None,
                lora: dict | None = None, lora_scale: float = 0.0, lora_ids=None,
                capture_layer: int | None = None, remat: bool = False,
                remat_policy: str | None = None, attn_impl: str = "auto",
                compute_dtype=torch.bfloat16, logits_dtype=None, last_logit_only: bool = False,
                chunk_decode: bool = False) -> dict:
        """VLM forward; ``input_ids`` hold the expanded image-token span and
        ``pixel_values`` are the patches [B, N, patch_dim] at the fixed
        resolution's grid.  Without ``positions`` the M-RoPE positions come
        from the ids and the mask, and the output carries ``rope_delta`` [B];
        2-D ``positions`` (decode, chunk passes) already hold the row's
        ``rope_delta`` and feed all three streams.  ``lora``:
        ``{"language_model": ..., "projector": ...}``, the projector's
        adapters applied in the merger; a bank of them with ``lora_ids`` [B]
        (multi-LoRA serving)."""
        cfg = self.cfg
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=input_ids.device)
        grid = cfg.default_grid
        ms = cfg.vision.spatial_merge_size
        lm = self.language_model
        et = lm.embed_tokens
        embeds = (embed_lookup(et, input_ids) if is_qtensor(et) else et[input_ids]).to(
            compute_dtype)
        if pixel_values is not None:
            image_embeds = vision_forward(
                self.vision_tower, cfg.vision, pixel_values, grid=grid, attn_impl=attn_impl,
                compute_dtype=compute_dtype,
                merger_lora=None if lora is None else lora.get("projector"),
                lora_scale=lora_scale, lora_ids=lora_ids)
            embeds = splice_image_embeds(embeds, image_embeds, input_ids == cfg.image_token_id)
        out_delta = None
        if positions is None:
            positions, out_delta = mrope_positions(
                input_ids, attention_mask, cfg.image_token_id, (grid[0], grid[1] // ms,
                                                                grid[2] // ms))
        out = lm(inputs_embeds=embeds, attention_mask=attention_mask, positions=positions,
                 kv_cache=kv_cache, cache_offset=cache_offset, kv_valid_mask=kv_valid_mask,
                 lora=lora if lora is None else lora.get("language_model"),
                 lora_scale=lora_scale, lora_ids=lora_ids, capture_layer=capture_layer,
                 remat=remat, remat_policy=remat_policy, attn_impl=attn_impl,
                 compute_dtype=compute_dtype, logits_dtype=logits_dtype,
                 last_logit_only=last_logit_only, chunk_decode=chunk_decode)
        if out_delta is not None:
            out["rope_delta"] = out_delta
        return out


def init_params(cfg: QwenVLConfig, generator: torch.Generator | None = None, *,
                device=None, dtype=torch.float32) -> QwenVL:
    """A randomly initialised Qwen2-VL on ``device`` (the card by default)."""
    model = QwenVL(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=model.language_model.norm.device).manual_seed(0)
    return model.init_params(generator)
