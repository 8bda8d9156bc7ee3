"""Flash-decode and verify-chunk attention: kernels B4, B4q, B5, B5q and
their plain PyTorch versions.

Counterpart of ``multimodal_unlearning_tpu/ops/decode_attention.py``, dense
caches: bf16 (or f32 on the CPU) ``{"k", "v"}`` [L, B, Hkv, Smax, D], or
int8 ``{"k", "v", "k_s", "v_s"}`` with f32 scales [L, B, Hkv, 1, Smax], one
per position and kv-head (position on the LAST axis).

- ``decode_attention``: one query token per row.  On a CUDA tensor the
  kernel ``csrc/flash_decode.cu`` indexes the layer inside the stacked
  cache (no slab is copied out): B4 on a bf16 cache, B4q on an int8 one,
  B4's f32 instance for an f32 query on an f32 cache (ECO's decode steps;
  every other CUDA route takes bf16 or int8 only).
  It cuts each row's columns into runs by ``decode_split_plan``, one block
  each, and merges the runs' partials in the same launch (the same
  arithmetic as ``chunk_attention_split_reference`` at C = 1).  The mask
  may be narrower than the cache, [B, S] with S <= Smax (the serving engine
  narrows it to the columns its slots can have reached): columns at and
  past S are not attended, and the kernel never reads them.
- ``chunk_decode_attention``: C query tokens per row at per-row cache
  columns ``offset[b]..offset[b]+C-1`` (the speculative verify round, and
  chunked-prefill / prefix-suffix passes).  On a CUDA tensor the kernel
  ``csrc/chunk_decode.cu`` reads the layer through strides (a slot's or a
  slab's columns may be a view): B5 on a bf16 cache, B5q on an int8 one.
  For few rows (G*C <= 32, the verify round) it splits the columns across
  blocks by ``chunk_split_plan`` and merges the splits in the same call;
  ``chunk_attention_split_reference`` is that arithmetic, plainly.

A paged cache (a ``"table"`` key: pools [L, Hkv, NP, P, D] and a block
table, ``ops/paged_attention.py``) routes both functions to their paged
counterparts, kernels B6/B6q and B7/B7q, as the JAX package does.

On a CPU tensor (or with ``impl="plain"``) the plain version runs: the JAX
package's XLA branches, the layer's slab dequantized (int8: ``_dequant``)
and cast to q's dtype, then plain attention.  Where the scales stay outside
the products in the kernels, the plain version forms the dequantized slab;
the two agree to the rounding of that slab.

A row that sees no column gives 0 on every route (the documented rule for
fully-masked rows).  The JAX Pallas decode kernels return the mean of V
there instead; the serving engine decodes idle slots with such rows and
throws their output away, so no token depends on it.
"""

from __future__ import annotations

import functools

import torch

from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.ops.attention import IMPLS, NEG_INF, mha_reference

__all__ = ["decode_attention", "chunk_decode_attention", "chunk_attention_reference",
           "chunk_attention_split_reference", "chunk_split_plan", "decode_split_plan",
           "dequant_layer"]

CHUNK_TILE = 64         # cache columns per tile of csrc/chunk_decode.cu
CHUNK_SPLIT_ROWS = 32   # rows G*C up to which the kernel splits the columns
CHUNK_SPLIT_WARPS = 4   # f32 partials per split there (the kernel's warps)
_SPLIT_BLOCKS_PER_SM = 4
_SPLIT_MIN_TILES = 4    # fewest tiles a split should hold
DECODE_BLOCKS_PER_SM = 2   # the one-token kernel's split plan aims at this many blocks per SM
DECODE_MIN_RUN = 512       # ... with runs of at least this many columns
DECODE_RUN_ALIGN = 64      # ... in multiples of this many columns
DECODE_GROUPS = (1, 2, 4, 6, 8)  # the GQA groups csrc/flash_decode.cu instantiates


def _check_cache(cache):
    """True for an int8 cache, False for a float one; raises for any other
    set of keys.  A paged cache carries its block table as one more key."""
    keys = set(cache) - {"table"}
    if keys == {"k", "v"}:
        if cache["k"].dtype == torch.int8:
            raise ValueError("an int8 cache needs its scales k_s and v_s")
        return False
    if keys == {"k", "v", "k_s", "v_s"} and cache["k"].dtype == torch.int8:
        return True
    raise ValueError(
        f"cache with keys {sorted(cache)}: {{'k','v'}} (float) or {{'k','v','k_s','v_s'}} "
        "(int8), each with a 'table' key when paged")


def dequant_layer(cache, layer, dtype):
    """Layer ``layer``'s [B, Hkv, Smax, D] K and V slabs in ``dtype``; an
    int8 cache is dequantized per position, x_int * s (the JAX
    ``_dequant``), in f32 first."""
    k, v = cache["k"][layer], cache["v"][layer]
    if k.dtype == torch.int8:
        k = k.to(torch.float32) * cache["k_s"][layer].transpose(-1, -2)
        v = v.to(torch.float32) * cache["v_s"][layer].transpose(-1, -2)
    return k.to(dtype), v.to(dtype)


def valid_columns(q, kv_valid, Smax: int):
    """The one-token kernels' view of a mask ``kv_valid`` [B, S] over the
    first S <= Smax columns: (int32 mask with contiguous columns, S, its row
    stride).  A narrowed view of an int32 [B, Smax] mask is taken in place."""
    B = q.shape[0]
    if kv_valid.ndim != 2 or kv_valid.shape[0] != B or not 0 < kv_valid.shape[1] <= Smax \
            or kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be [B, S] with B = {B}, 0 < S <= {Smax}, on "
                         f"{q.device}; got {tuple(kv_valid.shape)} on {kv_valid.device}")
    valid = kv_valid.to(torch.int32)
    if valid.stride(1) != 1:
        valid = valid.contiguous()
    return valid, valid.shape[1], valid.stride(0)


def _launch_args(q, cache, layer, f32=False):
    """Shared checks of the CUDA routes; returns (k, v, k_s, v_s) with the
    scales None for a float cache.  ``f32``: the route also takes an f32
    query beside an f32 cache (the one-token kernel's f32 instance)."""
    quantized = _check_cache(cache)
    k, v = cache["k"], cache["v"]
    f32_pair = f32 and q.dtype == torch.float32 and k.dtype == torch.float32
    if not f32_pair and (q.dtype != torch.bfloat16
                         or k.dtype not in (torch.bfloat16, torch.int8)) or v.dtype != k.dtype:
        raise TypeError(f"the decode kernels take a bf16 query and a bf16 or int8 cache"
                        f"{' (or f32 and f32)' if f32 else ''}, got {q.dtype} and "
                        f"{k.dtype}/{v.dtype}")
    if any(t.device != q.device for t in cache.values()):
        raise ValueError("q and the cache must be on one device")
    if v.shape != k.shape or (quantized and (
            cache["k_s"].shape != k.shape[:3] + (1, k.shape[3])
            or cache["v_s"].shape != cache["k_s"].shape
            or cache["k_s"].dtype != torch.float32 or cache["v_s"].dtype != torch.float32)):
        raise ValueError("k, v (and the f32 scales [L,B,Hkv,1,Smax]) must agree in shape")
    if not 0 <= int(layer) < k.shape[0]:
        raise IndexError(f"layer {layer} out of range for a {k.shape[0]}-layer cache")
    if quantized:
        return k, v, cache["k_s"], cache["v_s"]
    return k, v, None, None


@functools.lru_cache(maxsize=1024)
def decode_split_plan(B: int, Hkv: int, G: int, Smax: int, sm_count: int) -> tuple[int, int]:
    """(splits, per): how the one-token decode kernel (B4/B4q/B6/B6q) cuts
    the logical columns [0, Smax) it looks at (the mask's width) of each
    (batch row, kv-head) into ``splits`` runs of ``per`` columns, one block
    each, the last run possibly shorter, none empty.

    The engine's rows are ragged, so one block per row leaves the card idle
    behind the longest row's blocks; the runs aim at B x Hkv x splits of
    about ``DECODE_BLOCKS_PER_SM`` blocks per SM, each run at least
    ``DECODE_MIN_RUN`` columns (the last block of a row merges the runs'
    partials, about 2 us of latency on an NVIDIA H100 80GB HBM3 at 700 W,
    ``PERF.md``, which a shorter run does not earn back), ``per`` a multiple
    of ``DECODE_RUN_ALIGN``.  A pure function
    of shapes -- no ``kv_valid`` is read, nothing waits on the device -- so a
    dense and a paged call of one shape get one plan, in logical columns.
    ``G`` (the GQA group) does not change the plan."""
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // (B * Hkv))
    splits = max(1, min(want, Smax // DECODE_MIN_RUN))
    per = -(-Smax // splits)
    per = min(Smax, -(-per // DECODE_RUN_ALIGN) * DECODE_RUN_ALIGN)
    return -(-Smax // per), per


def decode_scratch(q, Hkv, S):
    """The one-token kernel's plan for q [B, Hq, 1, D] against the first S
    logical columns, with its f32 partials and per-(row, kv-head) counters
    where it splits (None otherwise): (per, splits, ws, counters)."""
    B, Hq, _, D = q.shape
    splits, per = decode_split_plan(B, Hkv, Hq // Hkv, S, sm_count(q.device))
    if splits == 1:
        return per, 1, None, None
    ws, counters = kernels.fold_buffers("decode", q.device, splits * B * Hq * (D + 2), B * Hkv)
    return per, splits, ws, counters


def _decode_cuda(q, cache, layer, kv_valid, sm_scale):
    k_cache, v_cache, k_s, v_s = _launch_args(q, cache, layer, f32=True)
    B, Hq, _, D = q.shape
    L, Bc, Hkv, Smax, Dc = k_cache.shape
    if (Bc, Dc) != (B, D) or Hq % Hkv or Hq // Hkv not in DECODE_GROUPS or D not in (64, 128):
        raise ValueError(f"flash_decode: unsupported shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)} (head dim 64 or 128, GQA group "
                         f"{'/'.join(map(str, DECODE_GROUPS))})")
    valid, S, vstride = valid_columns(q, kv_valid, Smax)
    tensors = (k_cache, v_cache) if k_s is None else (k_cache, v_cache, k_s, v_s)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode reads the stacked cache in place: it must be contiguous")
    q = q.contiguous()
    o = torch.empty_like(q)
    per, splits, ws, counters = decode_scratch(q, Hkv, S)
    scales = () if k_s is None else (k_s.data_ptr(), v_s.data_ptr())
    name = ("flash_decode_q8" if k_s is not None else
            "flash_decode_f32" if q.dtype == torch.float32 else "flash_decode")
    kernels.run(name, q.device, q.data_ptr(),
                k_cache.data_ptr(), v_cache.data_ptr(), *scales, valid.data_ptr(), o.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), L, B, Hq, Hkv, Smax, D,
                int(layer), S, vstride, per, splits, float(sm_scale))
    return o


def _route(q, impl, what):
    """True for the plain version (a CPU tensor or ``impl="plain"``), False
    for the kernel (a CUDA tensor); raises for any other device."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise RuntimeError(f"{what} has no kernel for device {q.device}")
    return False


def decode_attention(q, cache, layer, kv_valid, *, sm_scale: float | None = None,
                     impl: str = "auto"):
    """One-token attention against layer ``layer`` of the stacked KV cache.

    Args:
      q: [B, Hq, 1, D] query (RoPE already applied).
      cache: {"k", "v"[, "k_s", "v_s"]} -- [L, B, Hkv, Smax, D] stacked
        cache, the current token already written; an int8 cache carries f32
        scales [L, B, Hkv, 1, Smax].
      layer: int -- which layer's slab to attend against.
      kv_valid: [B, S] validity mask (1 = attend) over the first S <= Smax
        columns; the columns past S are not attended.
      impl: "auto" (the kernel on CUDA, the plain version on the CPU) or
        "plain".
    Returns [B, Hq, 1, D] in q's dtype.
    """
    if "table" in cache:  # paged pool + block table
        from multimodal_unlearning_tpu_torch.ops.paged_attention import paged_decode_attention

        return paged_decode_attention(q, cache, layer, kv_valid, sm_scale=sm_scale, impl=impl)
    if q.shape[2] != 1:
        raise ValueError("decode_attention is single-token")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _route(q, impl, "decode_attention"):
        _check_cache(cache)
        S = kv_valid.shape[-1]
        k, v = dequant_layer(_cols_of(cache, S), layer, q.dtype)
        return mha_reference(q, k, v, kv_valid, causal=False, sm_scale=sm_scale)
    return _decode_cuda(q, cache, layer, kv_valid, sm_scale)


def _cols_of(cache, S: int) -> dict:
    """The dense cache's first S columns (views; the scales keep their
    position last)."""
    if S == cache["k"].shape[3]:
        return cache
    return {n: t[..., :S] if n in ("k_s", "v_s") else t[:, :, :, :S] for n, t in cache.items()}


def chunk_visibility(kv_valid, offset, C: int):
    """[B, C, Smax] bool: query c of row b sees column j iff
    ``kv_valid[b, j] || offset[b] <= j <= offset[b] + c``."""
    col = torch.arange(kv_valid.shape[1], device=kv_valid.device)
    off = offset.to(col.device).long()[:, None, None]
    c = torch.arange(C, device=col.device)[None, :, None]
    in_chunk = (col[None, None, :] >= off) & (col[None, None, :] <= off + c)
    return (kv_valid[:, None, :] > 0) | in_chunk


def chunk_attention_reference(q, k, v, visible, sm_scale):
    """Plain attention of q [B, Hq, C, D] over k, v [B, Hkv, Sk, D] with a
    [B, C, Sk] visibility mask, in f32 (f64 stays f64); a row that sees
    nothing gives 0.  Returns q's dtype."""
    group = q.shape[1] // k.shape[1]
    acc_t = torch.promote_types(q.dtype, torch.float32)
    k = k.to(acc_t).repeat_interleave(group, dim=1) if group > 1 else k.to(acc_t)
    v = v.to(acc_t).repeat_interleave(group, dim=1) if group > 1 else v.to(acc_t)
    s = torch.einsum("bhcd,bhsd->bhcs", q.to(acc_t) * sm_scale, k)
    vis = visible[:, None]
    s = torch.where(vis, s, torch.full((), NEG_INF, dtype=acc_t, device=s.device))
    p = torch.where(vis.any(dim=-1, keepdim=True), torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhcs,bhsd->bhcd", p, v).to(q.dtype)


def chunk_split_plan(B: int, Hkv: int, M: int, Smax: int, sm_count: int) -> tuple[int, int]:
    """(splits, per): how the chunk kernel cuts the columns [0, Smax) of each
    (batch row, kv-head) into ``splits`` runs of ``per`` logical columns
    each, ``per`` a multiple of the kernel's 64-column tile, the last run
    possibly shorter, none empty.  ``M`` = G*C query rows per kv-head.

    Long chunks (M > 32) take one split: their row tiles fill the card.
    Short ones (the verify round) split the columns so that the B x Hkv x
    splits blocks come to about four per SM, with at least four tiles per
    split.  A pure function of its arguments: the dense and the paged call
    of one shape get one plan, in logical columns."""
    tiles = -(-Smax // CHUNK_TILE)
    splits = 1
    if M <= CHUNK_SPLIT_ROWS:
        want = -(-_SPLIT_BLOCKS_PER_SM * sm_count // (B * Hkv))
        splits = max(1, min(want, tiles // _SPLIT_MIN_TILES))
    per_tiles = -(-tiles // splits)
    return -(-tiles // per_tiles), per_tiles * CHUNK_TILE


def chunk_attention_split_reference(q, k, v, visible, sm_scale, plan, k_scale=None,
                                    v_scale=None):
    """The split-and-combine arithmetic of the chunk kernel, plainly: each
    run of ``plan = (splits, per)`` columns gives its partial (running max m,
    sum l, unnormalised o) of the rows' visible columns, and the runs merge
    by the log-sum-exp rule, o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s
    over the runs that saw a column; a row that sees nothing gives 0.

    q [B, Hq, C, D], k/v [B, Hkv, Sk, D], visible [B, C, Sk].  With
    ``k_scale``/``v_scale`` [B, Hkv, Sk] (an int8 cache: k and v hold the
    integers) the scales stay outside both products, as in the kernel:
    s = (q.k_int) k_s, and p v_s multiplies v_int while l sums p.  In f32
    (f64 stays f64); returns q's dtype.  Tests only."""
    splits, per = plan
    group = q.shape[1] // k.shape[1]
    acc_t = torch.promote_types(q.dtype, torch.float32)

    def heads(t):  # [B, Hkv, ...] -> [B, Hq, ...]
        t = t.to(acc_t)
        return t.repeat_interleave(group, dim=1) if group > 1 else t

    kf, vf = heads(k), heads(v)
    s = torch.einsum("bhcd,bhsd->bhcs", q.to(acc_t), kf)
    if k_scale is not None:
        s = s * heads(k_scale)[:, :, None, :]
    s = s * sm_scale
    vis = visible[:, None].expand_as(s)
    neg = torch.full((), float("-inf"), dtype=acc_t, device=s.device)
    parts = []
    for sp in range(splits):
        cols = slice(sp * per, min((sp + 1) * per, s.shape[-1]))
        ss, vv = torch.where(vis[..., cols], s[..., cols], neg), vis[..., cols]
        m = ss.amax(dim=-1, keepdim=True)
        p = torch.where(vv, torch.exp(ss - torch.where(vv.any(-1, keepdim=True), m, 0.0)), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        pv = p if v_scale is None else p * heads(v_scale)[:, :, None, cols]
        parts.append((m, l, torch.einsum("bhcs,bhsd->bhcd", pv, vf[:, :, cols])))
    top = torch.stack([torch.where(l > 0, m, neg) for m, l, _ in parts]).amax(dim=0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    o = torch.zeros_like(parts[0][2])
    l_sum = torch.zeros_like(parts[0][1])
    for m, l, o_s in parts:
        w = torch.where(l > 0, torch.exp(m - top), 0.0)
        o = o + w * o_s
        l_sum = l_sum + w * l
    return torch.where(l_sum > 0, o / torch.where(l_sum > 0, l_sum, 1.0), 0.0).to(q.dtype)


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    idx = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if idx is None else idx)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_scratch(q, Hkv, Smax):
    """The chunk kernel's plan for q [B, Hq, C, D] against Smax columns and,
    where it merges partials, their f32 scratch (partials x B*Hq*C x (D+2)):
    short chunks give one partial per split and warp, long ones one per
    split."""
    B, Hq, C, D = q.shape
    M = (Hq // Hkv) * C
    splits, per = chunk_split_plan(B, Hkv, M, Smax, sm_count(q.device))
    parts = splits * CHUNK_SPLIT_WARPS if M <= CHUNK_SPLIT_ROWS else splits
    ws = None
    if parts > 1:
        ws = torch.empty(parts * B * Hq * C * (D + 2), dtype=torch.float32, device=q.device)
    return splits, per, ws


def _cache_strides(t, D):
    """(sL, sB, sH, sS) of a cache view whose head dim is contiguous, with
    16-byte aligned rows (what the kernel's vector loads need)."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:4]) \
            or D % 16:
        raise ValueError("chunk_decode reads the cache through strides: the head dim must be "
                         "contiguous and each row 16-byte aligned")
    return t.stride()[:4]


def _chunk_cuda(q, cache, layer, kv_valid, offset, sm_scale):
    k, v, k_s, v_s = _launch_args(q, cache, layer)
    B, Hq, C, D = q.shape
    L, Bc, Hkv, Smax, Dc = k.shape
    if (Bc, Dc) != (B, D) or Hq % Hkv or D not in (64, 128):
        raise ValueError(f"chunk_decode: unsupported shapes q {tuple(q.shape)} cache "
                         f"{tuple(k.shape)} (head dim 64 or 128, Hq % Hkv == 0)")
    if k.stride() != v.stride():
        raise ValueError("k and v must share one layout")
    strides = _cache_strides(k, D)
    _cache_strides(v, D)
    tstrides = (0, 0, 0)
    if k_s is not None:
        if k_s.stride() != v_s.stride() or k_s.stride(-1) != 1:
            raise ValueError("the scales must share one layout with positions contiguous")
        tstrides = k_s.stride()[:3]
    if tuple(kv_valid.shape) != (B, Smax) or tuple(offset.shape) != (B,) \
            or kv_valid.device != q.device or offset.device != q.device:
        raise ValueError(f"kv_valid must be [B, Smax] = {(B, Smax)} and offset [B] on {q.device}")
    q = q.contiguous()
    valid = kv_valid.to(torch.int32).contiguous()
    off = offset.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    splits, per, ws = split_scratch(q, Hkv, Smax)
    name = "chunk_decode" if k_s is None else "chunk_decode_q8"
    fn = kernels.launcher(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if k_s is None else k_s.data_ptr(),
                 None if v_s is None else v_s.data_ptr(), valid.data_ptr(), off.data_ptr(),
                 o.data_ptr(), None if ws is None else ws.data_ptr(), B, Hq, Hkv, C, Smax, D,
                 int(layer), per, splits, *strides, *tstrides, float(sm_scale), stream)
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return o


def chunk_decode_attention(q, cache, layer, kv_valid, offset, *,
                           sm_scale: float | None = None, impl: str = "auto"):
    """C-token verify-chunk attention against layer ``layer`` of the cache.

    Row b's queries sit at cache columns ``offset[b] .. offset[b]+C-1``
    (already written by this layer); query c sees the valid prefix plus the
    chunk columns up to its own -- per-row causal alignment that the
    single-token kernel does not express.

    Args:
      q: [B, Hq, C, D] (RoPE applied).
      cache / layer: as ``decode_attention``; the cache may be a view with
        the head dim contiguous (a slot's or a slab's columns).
      kv_valid: [B, Smax] -- the ACCEPTED prefix only (chunk columns
        excluded; the causal term admits them).
      offset: [B] int -- each row's first chunk column.
    Returns [B, Hq, C, D] in q's dtype.
    """
    if "table" in cache:  # paged pool + block table
        from multimodal_unlearning_tpu_torch.ops.paged_attention import (
            paged_chunk_decode_attention)

        return paged_chunk_decode_attention(q, cache, layer, kv_valid, offset,
                                            sm_scale=sm_scale, impl=impl)
    B, Hq, C, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    if _route(q, impl, "chunk_decode_attention"):
        _check_cache(cache)
        k, v = dequant_layer(cache, layer, q.dtype)
        return chunk_attention_reference(q, k, v, chunk_visibility(kv_valid, offset, C),
                                         sm_scale)
    return _chunk_cuda(q, cache, layer, kv_valid, offset, sm_scale)
