"""Rotary position embeddings (Llama-style, half-rotation layout).

Counterpart of ``multimodal_unlearning_tpu/ops/rope.py``: HF's
rotate_half convention, tables in f32 (HF registers ``inv_freq`` as an
f32 buffer and runs its rotary with autocast off).
"""

from __future__ import annotations

import torch


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               dtype=torch.float32, device=None):
    """(cos, sin) tables of shape [max_len, head_dim]; ``inv_freq`` is
    always computed in f32, the angles in ``dtype``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=dtype, device=device)
    freqs = torch.outer(t, inv_freq.to(dtype))  # [L, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [L, D]
    return emb.cos(), emb.sin()


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope_bsd(x, cos_bsd, sin_bsd):
    """x: [B, H, S, D]; cos_bsd/sin_bsd: [B, S, D] per-token tables.  The
    product runs in the tables' (f32) precision and casts back to x's type."""
    c = cos_bsd[:, None, :, :]
    s = sin_bsd[:, None, :, :]
    return (x * c + _rotate_half(x) * s).to(x.dtype)


def mrope_select(cos, sin, positions, mrope_section, head_dim: int):
    """Qwen2-VL's multimodal RoPE: each rotary channel takes its angle from
    one of three position streams.

    cos/sin: [max_len, D] tables; positions: [3, B, S] (temporal, height,
    width); ``mrope_section`` gives each stream's channel count over the
    first half of D, and the second half repeats the first (HF's
    apply_multimodal_rotary_pos_emb).  Returns ([B, S, D], [B, S, D]): a
    gather per channel, which picks exactly the value the JAX package's
    one-hot product picks."""
    half = head_dim // 2
    seg = torch.repeat_interleave(torch.arange(len(mrope_section)),
                                  torch.tensor(mrope_section))[:half]
    if seg.numel() < half:  # jnp.repeat's total_repeat_length pads with the last stream
        seg = torch.cat([seg, seg[-1:].expand(half - seg.numel())])
    seg = torch.cat([seg, seg]).to(positions.device)  # stream of each channel [D]
    chan = torch.arange(head_dim, device=positions.device)
    pos = positions[seg]  # [D, B, S]: each channel's stream
    cos_sel = cos[pos, chan[:, None, None]].permute(1, 2, 0)
    sin_sel = sin[pos, chan[:, None, None]].permute(1, 2, 0)
    return cos_sel, sin_sel
