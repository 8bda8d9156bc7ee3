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
