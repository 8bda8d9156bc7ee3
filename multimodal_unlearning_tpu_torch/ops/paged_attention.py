"""Paged KV-cache attention: kernels B6, B6q, B7 and B7q and their plain
PyTorch versions.

Counterpart of ``multimodal_unlearning_tpu/ops/paged_attention.py``.  A
paged cache is one pool of fixed-size pages shared by every row plus a
per-row block table:

    k, v      [L, Hkv, NP, P, D]   bf16 (or f32 on the CPU), or int8 with
    k_s, v_s  [L, Hkv, NP, 1, P]   f32 scales, one per position and kv-head
    table     [B, MP] int32        page ids; logical column c of row b lives
                                   at pool page table[b, c // P], offset c % P

and validity ``kv_valid`` [B, MP*P] is indexed by LOGICAL column, so the
dense cache's masks apply unchanged.

- ``paged_decode_attention``: one query token per row.  On a CUDA tensor
  the kernel ``csrc/flash_decode.cu`` in its paged instance: B6 on a bf16
  pool, B6q on an int8 one.
- ``paged_chunk_decode_attention``: C query tokens per row at logical
  columns ``offset[b]..offset[b]+C-1``.  On a CUDA tensor
  ``csrc/chunk_decode.cu`` in its paged instance: B7 on a bf16 pool, B7q on
  an int8 one.

On a CPU tensor (or with ``impl="plain"``) the plain version runs: the
layer's pages gathered into a contiguous logical view (``gather_layer_kv``,
int8 pools dequantized exactly), then the dense plain attention.  Pages
past a row's extent and all-invalid gap pages contribute nothing on every
route; a row that sees no column gives 0.

On an NVIDIA H100 80GB HBM3 at its 700 W power limit (``chip_smoke.py``,
device time): B6 takes 0.020 ms on 8 rows with 1,909 valid columns of a
32-head pool (bound 0.0094 ms, bytes; B4 on the same columns the same), B7
0.086 ms at the speculative verify round (B 8, C 5; bound 0.053 ms), each
within ~10% of the dense kernel and equal to it bit for bit; the gather +
plain attention takes 2-3 ms.
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.ops.attention import mha_reference
from multimodal_unlearning_tpu_torch.ops.decode_attention import (
    DECODE_GROUPS, _check_cache, _launch_args, _route, chunk_attention_reference,
    chunk_visibility, decode_scratch, split_scratch, valid_columns)

__all__ = ["is_paged", "gather_layer_kv", "paged_decode_attention",
           "paged_chunk_decode_attention"]


def is_paged(cache) -> bool:
    return isinstance(cache, dict) and "table" in cache


def gather_layer_kv(cache, layer, dtype):
    """Layer ``layer``'s K and V gathered through the block table into a
    contiguous [B, Hkv, MP*P, D] view in logical column order, in
    ``dtype``; an int8 pool is dequantized per position in f32 first
    (x_int * s), as the dense cache's plain version does."""
    table = cache["table"].long()  # [B, MP]
    k, v = cache["k"][layer][:, table], cache["v"][layer][:, table]  # [H, B, MP, P, D]
    H, B, MP, P, D = k.shape
    k = k.transpose(0, 1).reshape(B, H, MP * P, D)
    v = v.transpose(0, 1).reshape(B, H, MP * P, D)
    if k.dtype == torch.int8:
        # scales [H, NP, 1, P] -> [B, H, MP*P], one per logical column
        ks = cache["k_s"][layer][:, table].transpose(0, 1).reshape(B, H, MP * P)
        vs = cache["v_s"][layer][:, table].transpose(0, 1).reshape(B, H, MP * P)
        k = k.to(torch.float32) * ks[..., None]
        v = v.to(torch.float32) * vs[..., None]
    return k.to(dtype), v.to(dtype)


def _page_counts(kv_valid, page: int):
    """[B] number of leading pages covering every valid column of each row."""
    B, S = kv_valid.shape
    MP = S // page
    vpage = (kv_valid.reshape(B, MP, page) > 0).any(dim=2)  # [B, MP]
    idx = torch.arange(1, MP + 1, dtype=torch.int32, device=kv_valid.device)
    return torch.where(vpage, idx[None, :], 0).amax(dim=1).to(torch.int32)


def _paged_launch_args(q, cache, layer, kv_valid=None):
    """Checks shared by the paged kernels; returns (k, v, k_s, v_s, table,
    valid) with the scales None for a bf16 pool (valid None when kv_valid
    is: the one-token kernel takes a narrowed mask, ``valid_columns``)."""
    k, v, k_s, v_s = _launch_args(q, cache, layer)
    B, Hq, _, D = q.shape
    L, Hkv, NP, P, Dc = k.shape
    table = cache["table"]
    if Dc != D or Hq % Hkv or D not in (64, 128):
        raise ValueError(f"paged attention: unsupported shapes q {tuple(q.shape)} pool "
                         f"{tuple(k.shape)} (head dim 64 or 128, Hq % Hkv == 0)")
    if table.ndim != 2 or table.shape[0] != B or table.dtype != torch.int32:
        raise ValueError(f"the block table must be int32 [B, MP] with B = {B}, got "
                         f"{table.dtype} {tuple(table.shape)}")
    MP = table.shape[1]
    if kv_valid is not None and (tuple(kv_valid.shape) != (B, MP * P)
                                 or kv_valid.device != q.device):
        raise ValueError(f"kv_valid must be [B, MP*P] = {(B, MP * P)} on {q.device}")
    tensors = (k, v, table) if k_s is None else (k, v, k_s, v_s, table)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged kernels read the pool and the table in place: they must be "
                         "contiguous")
    return k, v, k_s, v_s, table, (None if kv_valid is None
                                   else kv_valid.to(torch.int32).contiguous())


def _decode_cuda(q, cache, layer, kv_valid, sm_scale):
    k, v, k_s, v_s, table, _ = _paged_launch_args(q, cache, layer)
    B, Hq, _, D = q.shape
    L, Hkv, NP, P, _ = k.shape
    if Hq // Hkv not in DECODE_GROUPS:
        raise ValueError(f"paged_decode: GQA group {Hq // Hkv} "
                         f"({'/'.join(map(str, DECODE_GROUPS))})")
    MP = table.shape[1]
    valid, S, vstride = valid_columns(q, kv_valid, MP * P)
    q = q.contiguous()
    o = torch.empty_like(q)
    # the dense call's plan over the same logical columns
    per, splits, ws, counters = decode_scratch(q, Hkv, S)
    scales = () if k_s is None else (k_s.data_ptr(), v_s.data_ptr())
    kernels.run("paged_decode" if k_s is None else "paged_decode_q8", q.device, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), *scales, valid.data_ptr(), table.data_ptr(),
                o.data_ptr(), None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), L, B, Hq, Hkv, NP, P, MP, D,
                int(layer), S, vstride, per, splits, float(sm_scale))
    return o


def paged_decode_attention(q, cache, layer, kv_valid, *, sm_scale: float | None = None,
                           impl: str = "auto"):
    """One-token attention against layer ``layer`` of a PAGED KV cache.

    Args:
      q: [B, Hq, 1, D] query (RoPE already applied).
      cache: {"k", "v", "table"[, "k_s", "v_s"]} -- pools [L, Hkv, NP, P, D],
        block table [B, MP] int32 (the current token already written
        through it).
      layer: int.
      kv_valid: [B, S] LOGICAL validity mask (1 = attend) over the first
        S <= MP*P columns; the columns past S are not attended.
      impl: "auto" (the kernel on CUDA, the plain version on the CPU) or
        "plain".
    Returns [B, Hq, 1, D] in q's dtype.
    """
    if q.shape[2] != 1:
        raise ValueError("paged_decode_attention is single-token")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _route(q, impl, "paged_decode_attention"):
        _check_cache(cache)
        k, v = gather_layer_kv(cache, layer, q.dtype)
        S = kv_valid.shape[-1]
        return mha_reference(q, k[:, :, :S], v[:, :, :S], kv_valid, causal=False,
                             sm_scale=sm_scale)
    return _decode_cuda(q, cache, layer, kv_valid, sm_scale)


def _chunk_cuda(q, cache, layer, kv_valid, offset, sm_scale):
    k, v, k_s, v_s, table, valid = _paged_launch_args(q, cache, layer, kv_valid)
    B, Hq, C, D = q.shape
    L, Hkv, NP, P, _ = k.shape
    if tuple(offset.shape) != (B,) or offset.device != q.device:
        raise ValueError(f"offset must be [B] on {q.device}")
    q = q.contiguous()
    off = offset.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    # the dense call's plan over the same logical columns
    splits, per, ws = split_scratch(q, Hkv, table.shape[1] * P)
    name = "paged_chunk" if k_s is None else "paged_chunk_q8"
    fn = kernels.launcher(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if k_s is None else k_s.data_ptr(),
                 None if v_s is None else v_s.data_ptr(), valid.data_ptr(), off.data_ptr(),
                 table.data_ptr(), o.data_ptr(), None if ws is None else ws.data_ptr(), B, Hq,
                 Hkv, C, NP, P, table.shape[1], D, int(layer), per, splits, float(sm_scale),
                 stream)
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return o


def paged_chunk_decode_attention(q, cache, layer, kv_valid, offset, *,
                                 sm_scale: float | None = None, impl: str = "auto"):
    """C-token verify-chunk attention against layer ``layer`` of a PAGED KV
    cache: row b's queries sit at logical columns ``offset[b] ..
    offset[b]+C-1`` (already written through the table); query c sees the
    valid prefix plus the chunk's columns up to its own, by logical column.

    Args as ``decode_attention.chunk_decode_attention``; cache as
    ``paged_decode_attention``.  Returns [B, Hq, C, D] in q's dtype.
    """
    B, Hq, C, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    if _route(q, impl, "paged_chunk_decode_attention"):
        _check_cache(cache)
        k, v = gather_layer_kv(cache, layer, q.dtype)
        return chunk_attention_reference(q, k, v, chunk_visibility(kv_valid, offset, C),
                                         sm_scale)
    return _chunk_cuda(q, cache, layer, kv_valid, offset, sm_scale)
