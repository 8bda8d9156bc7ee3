"""Stochastic decoding: temperature / top-k / top-p (nucleus) sampling.

Counterpart of ``multimodal_unlearning_tpu/evaluation/sampling.py``, shared
by ``evaluation/generate.py`` and the serving engine.  Token ``i`` of a
stream seeded ``s`` is drawn with the key ``fold_in(fold_in(key0, s), i)``,
a function of (seed, output index) alone, so a request samples the same
stream solo through ``greedy_generate`` and through the engine, whatever
its slot, admission order or chunk boundaries.

The keys and the noise are the JAX package's bit for bit: this module
carries its own copy of the threefry2x32 hash that ``jax.random`` runs
(``jax_threefry_partitionable``, the JAX default), on int64 tensors holding
uint32 values (torch has no uint32 arithmetic), on the logits' device:

- ``PRNGKey(0)`` is the pair (0, 0); ``fold_in(key, d)`` hashes the counter
  pair (0, d) under ``key``;
- ``categorical(key, logits)`` is ``argmax(gumbel + logits)``, the Gumbel
  noise ``-log(-log(u))`` of ``u = uniform(key, [V], minval=tiny)``, whose
  32 random bits for entry j are the two words of the hash of the counter
  pair (0, j), xor-ed; the top 23 of them become the mantissa of a float in
  [1, 2), less 1.

Every step stays on the device: nothing here waits for it.  The JAX
package computes all of this with XLA ops, so these are plain torch ops
too.  The keys, the bits and the uniforms equal JAX's exactly, and the
logits go through the same f32 steps in the same order; only ``log`` rounds
its last bits differently from XLA's (the noise differs by a few 1e-7), so
a sampled token can differ only where two candidates lie that close.
"""

from __future__ import annotations

import torch

__all__ = ["row_keys", "fold_in", "random_bits", "uniform", "gumbel", "process_logits",
           "sample_token", "sample_folded"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of counter words ``x0``/``x1``
    under key words ``k0``/``k1``: int64 tensors of uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(keys, data):
    """``jax.random.fold_in`` of keys [..., 2] (int64 words) with integer
    ``data`` (a tensor broadcast against the keys' leading shape, taken as
    uint32): the hash of the counter pair (0, data)."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    y0, y1 = _threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def row_keys(seeds, device=None):
    """Per-row keys [B, 2] of int seeds [B]: ``fold_in(PRNGKey(0), s)``."""
    seeds = torch.as_tensor(seeds, device=device).to(torch.int64).reshape(-1)
    base = torch.zeros((seeds.shape[0], 2), dtype=torch.int64, device=seeds.device)
    return fold_in(base, seeds)


def random_bits(keys, n: int):
    """32 random bits per entry, [B, n] int64: ``jax.random.bits(key,
    (n,))`` for each row's key of ``keys`` [B, 2]."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = _threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(keys, n: int):
    """``jax.random.uniform(key, (n,), minval=tiny)`` per row, [B, n] f32."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, _TINY)


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,))`` (mode "low") per row, [B, n] f32."""
    return -torch.log(-torch.log(uniform(keys, n)))


def process_logits(logits, temperature, top_k: int = 0, top_p=1.0):
    """Scale by temperature, then keep only the top-k tokens and the top-p
    (nucleus) mass.  ``logits`` [B, V]; ``top_k`` 0 is off; ``top_p`` >= 1
    skips the sort.  Top-p keeps a token while the mass before it in the
    descending order is below ``top_p`` (HF semantics: the argmax always
    survives)."""
    x = logits.to(torch.float32)
    # a true f32 division by a tensor (CUDA would multiply by the
    # reciprocal of a Python scalar)
    t = torch.full((), max(float(temperature), 1e-6), dtype=torch.float32, device=x.device)
    x = x / t
    if top_k and top_k > 0:
        kth = torch.topk(x, int(top_k), dim=-1).values[..., -1:]
        x = torch.where(x < kth, float("-inf"), x)
    if float(top_p) >= 1.0:
        return x
    srt = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    # the smallest kept logit per row; +inf where dropped so min() ignores them
    cutoff = torch.where(before < float(top_p), srt, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(x < cutoff, float("-inf"), x)


def sample_token(keys, out_idx, logits, temperature, top_k: int = 0, top_p=1.0):
    """One token per row [B] (int64): ``keys`` [B, 2] (``row_keys``),
    ``out_idx`` [B] the output positions (the fold index), ``logits``
    [B, V]."""
    masked = process_logits(logits, temperature, top_k, top_p)
    return sample_folded(fold_in(keys, out_idx), masked)


def sample_folded(step_keys, masked):
    """``categorical`` of processed logits ``masked`` [B, V] under keys
    [B, 2] already folded with their output index."""
    return torch.argmax(gumbel(step_keys, masked.shape[-1]) + masked, dim=-1)
