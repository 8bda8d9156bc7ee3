"""Grouped-int4 W4A16 matmul: kernel B8 and its plain PyTorch version.

Counterpart of ``multimodal_unlearning_tpu/ops/int4_matmul.py``.  A grouped
int4 weight ``[K, N]`` is stored as ``q4`` int8 ``[K/2, N]`` (half-split
nibble packing: byte i holds row i in its low nibble and row i + K/2 in its
high nibble, values in [-7, 7]) and ``s`` f32 ``[K/G, N]``, one scale per
(group of G contracting rows, output column), the low half's groups first
(``utils/quantize.quantize_leaf_int4``).  The port stores ``q4`` with the
K/2 dimension contiguous (strides ``(1, K/2)``, as ``in_contiguous`` lays
out int8 weights): a column's packed bytes are one run in memory, which is
what the kernel loads.  Shape and values are the JAX leaf's.

``grouped_int4_matmul(x, q4, s)`` computes

    y = sum_g (x_lo[:, g] @ lo_g) * s_lo[g] + (x_hi[:, g] @ hi_g) * s_hi[g]

with f32 partials per group, the f32 scale row applied to the partial and
never to a materialised weight, as the TPU kernel does.  On a CUDA tensor it
launches B8 (``csrc/int4_matmul.cu``: one launch per call, which folds the
partials of groups split across blocks itself) or raises; on a CPU tensor it runs
``int4_matmul_reference``, the same arithmetic in plain torch.  The plain
version also runs on the card while ``PLAIN`` is set (``use_plain``): a
module global read at each call, for holding a whole model against it.

Which calls reach it is ``utils/quantize.int4_matmul``'s rule: M <= 1024
rows and a shape that ``supported`` accepts; the rest dequantizes one weight
at a time.

Training over an int4 base (QLoRA): both functions differentiate in x
(``with_dx``, a ``torch.autograd.Function``): the forward takes its route
unchanged (B8 or the dequant), the backward is ``int4_dx``, dx = dy @
dequant(q4, s)^T with each half of the weight dequantized to x's dtype and
multiplied by ``torch.matmul`` -- what autodiff gives for the JAX package's
XLA route, which has no kernel of its own either -- counted in
``INT4_BWD_CALLS``.  The base gets no gradient.
"""

from __future__ import annotations

import collections
import functools

import torch

from multimodal_unlearning_tpu_torch.ops import kernels

__all__ = ["grouped_int4_matmul", "int4_matmul_reference", "supported", "nibbles",
           "use_plain", "splits_for", "dequant_halves", "int4_dx", "with_dx", "INT4_BWD_CALLS"]

PLAIN = False  # set via use_plain(); the plain version on the card too
# (M, K, N) -> backward passes through an int4 product (dequant + matmul)
INT4_BWD_CALLS: collections.Counter = collections.Counter()

_MAX_GROUP = 128   # the widest scale group the kernel takes
_BN = 128          # output columns per block (csrc/int4_matmul.cu)
# csrc/int4_matmul.cu's tiles by rows M: (most rows, block rows, blocks the
# split plan aims at).  The rows kernel (8, 16 or 32 rows, 33-64 rows as
# two 32-row tiles; 2-3 blocks resident per SM) aims at two blocks per SM of
# the H100's 132, the 128-row wgmma kernel (1 per SM) at one.
TILES = ((8, 8, 264), (16, 16, 264), (64, 32, 264), (None, 128, 132))


def use_plain(on: bool = True) -> bool:
    """Run the plain version instead of B8 on the card as well.  Returns the
    previous value so callers can restore it; the flag is read at each call."""
    global PLAIN
    prev = PLAIN
    PLAIN = on
    return prev


def nibbles(packed):
    """(low, high) sign-extended int4 values of a packed int8 array, int8:
    two arithmetic shifts each (int8 shifts wrap, as the kernel's)."""
    return (packed << 4) >> 4, packed >> 4


def dequant_halves(q4, s, dtype):
    """(low, high) halves [K/2, N] of the weight ``dequant(q4, s)`` in
    ``dtype``: the exact int4 values times their f32 group scales, rounded
    once."""
    half, N = q4.shape[-2], q4.shape[-1]
    gh = s.shape[-2] // 2
    g = half // gh

    def dq(q_half, s_half):
        return (q_half.to(torch.float32).reshape(gh, g, N) * s_half[:, None, :]).reshape(
            half, N).to(dtype)

    lo, hi = nibbles(q4)
    return dq(lo, s[:gh]), dq(hi, s[gh:])


def int4_dx(dy, q4, s, dtype):
    """dx [..., K] = dy @ dequant(q4, s)^T, the weight's halves in ``dtype``
    (x's), as autodiff of the JAX package's XLA route gives it; counted in
    ``INT4_BWD_CALLS``."""
    lo, hi = dequant_halves(q4, s, dtype)
    N = q4.shape[-1]
    INT4_BWD_CALLS[(dy.numel() // N if N else 0, 2 * q4.shape[-2], N)] += 1
    dy = dy.to(dtype)
    return torch.cat([dy @ lo.t(), dy @ hi.t()], dim=-1)


class _WithDx(torch.autograd.Function):
    """``fn(x, q4, s, out_dtype)`` as it is in the forward; dx by
    ``int4_dx`` in the backward, nothing for q4 and s."""

    @staticmethod
    def forward(ctx, x, q4, s, fn, out_dtype):
        ctx.save_for_backward(q4, s)
        ctx.x_dtype = x.dtype
        return fn(x, q4, s, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        q4, s = ctx.saved_tensors
        return int4_dx(dy, q4, s, ctx.x_dtype), None, None, None, None


def with_dx(fn, x, q4, s, out_dtype=None):
    """``fn(x, q4, s, out_dtype)``, differentiable in x when x requires a
    gradient (``_WithDx``), else called as it is."""
    if x.requires_grad and torch.is_grad_enabled():
        return _WithDx.apply(x, q4, s, fn, out_dtype)
    return fn(x, q4, s, out_dtype)


def _group(q4, s) -> int | None:
    """The scale group width G of a 2-D leaf, or None if ``s`` does not tile
    the packed rows into two halves of whole groups."""
    if q4.ndim != 2 or s.ndim != 2 or s.shape[1] != q4.shape[1] or s.shape[0] % 2:
        return None
    gh = s.shape[0] // 2
    if gh == 0 or q4.shape[0] % gh:
        return None
    return q4.shape[0] // gh


def supported(q4, s) -> bool:
    """Shapes B8 takes: a 2-D leaf whose scale groups are a multiple of 16
    rows and at most 128 wide (every group the port's quantizer gives at
    real widths: 128, and 64 or 32 from ``int4:g64`` / ``int4:g32``); any N,
    a ragged last column tile included.  Others take the dequant path."""
    g = _group(q4, s)
    return g is not None and g % 16 == 0 and g <= _MAX_GROUP


def int4_matmul_reference(x, q4, s, out_dtype=None):
    """The plain version of B8: per-group f32 partials ``x_lo[:, g] @ lo_g``
    and ``x_hi[:, g] @ hi_g``, each times its f32 scale row, summed in f32
    and cast to ``out_dtype`` (default ``x.dtype``).  x: [M, K]."""
    out_dtype = out_dtype or x.dtype
    K2, N = q4.shape
    gh = s.shape[0] // 2
    G = K2 // gh
    x32 = x.reshape(-1, 2 * K2).to(torch.float32)
    M = x32.shape[0]
    parts = []
    for xh, wq, sh in zip((x32[:, :K2], x32[:, K2:]), nibbles(q4), (s[:gh], s[gh:])):
        xg = xh.reshape(M, gh, G).transpose(0, 1)            # [gh, M, G]
        w = wq.to(torch.float32).reshape(gh, G, N)           # exact int4 values
        parts.append(torch.bmm(xg, w) * sh.to(torch.float32)[:, None, :])  # [gh, M, N]
    return (parts[0] + parts[1]).sum(0).to(out_dtype)


def tile_of(M: int) -> tuple[int, int]:
    """(block rows, target blocks) of the kernel that takes M rows."""
    for most, bm, target in TILES:
        if most is None or M <= most:
            return bm, target
    raise AssertionError("TILES ends with an open row")


@functools.lru_cache(maxsize=4096)
def splits_for(M: int, N: int, gh: int) -> tuple[int, int]:
    """(groups per split, splits): how B8 divides the ``gh`` scale groups of
    each half among blocks.  Where the (N, M) tiles are fewer than the
    kernel's target blocks, the groups are split so that tiles x splits
    comes near the target; the last block of each tile to finish sums the
    splits' f32 partials in the same launch.  Every group falls in exactly
    one split and none is empty."""
    bm, target = tile_of(M)
    tiles = -(-N // _BN) * -(-M // bm)
    splits = max(1, min(gh, round(target / tiles)))
    per = -(-gh // splits)
    return per, -(-gh // per)


def _check_leaf(q4, s):
    if q4.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"B8 takes int8 q4 and f32 scales, got {q4.dtype} and {s.dtype}")
    if not supported(q4, s):
        raise ValueError(f"B8 does not take q4 {tuple(q4.shape)} with scales {tuple(s.shape)}: "
                         "groups must be a multiple of 16 rows and at most 128")
    if s.device != q4.device:
        raise ValueError("q4 and s must be on one device")
    if q4.stride() != (1, q4.shape[0]) or q4.data_ptr() % 16:
        raise ValueError("B8 reads q4 with its K/2 dimension contiguous (strides (1, K/2), "
                         "16-byte aligned), as quantize_leaf_int4 stores it")
    if not s.is_contiguous():
        raise ValueError("the scales must be contiguous [K/G, N]")


def _check(x, q4, s, out_dtype):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"B8 takes bf16 activations, got {x.dtype} (int4 serving computes in "
                        "bf16; the plain version runs on the CPU)")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"B8 writes bf16 or f32, not {out_dtype}")
    if x.ndim != 2 or x.shape[1] != 2 * q4.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} must be [M, K] with K = 2 * {q4.shape[0]}")
    _check_leaf(q4, s)
    if q4.device != x.device:
        raise ValueError("x, q4 and s must be on one device")


def grouped_int4_matmul(x, q4, s, out_dtype=None):
    """``x @ dequant(q4, s)`` for x [M, K]: kernel B8 on a CUDA tensor (bf16
    x, bf16 or f32 out), the plain version on a CPU tensor or while
    ``PLAIN`` is set; differentiable in x (``with_dx``)."""
    return with_dx(_grouped_int4_matmul, x, q4, s, out_dtype)


def _grouped_int4_matmul(x, q4, s, out_dtype):
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" or PLAIN:
        return int4_matmul_reference(x, q4, s, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"grouped_int4_matmul has no kernel for device {x.device}")
    _check(x, q4, s, out_dtype)
    M, K2, N = x.shape[0], q4.shape[0], q4.shape[1]
    if M == 0:
        return torch.empty((0, N), dtype=out_dtype, device=x.device)
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel copies x in 16-byte runs
        x = x.clone()
    gh = s.shape[0] // 2
    per, splits = splits_for(M, N, gh)
    dev = x.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    ws = counters = None
    if splits > 1:  # f32 partials and one counter per (N, M) tile
        ws, counters = kernels.fold_buffers("int4_matmul", dev, splits * M * N,
                                            -(-N // _BN) * -(-M // tile_of(M)[0]))
    kernels.run("int4_matmul", dev, x.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), M, K2, N, K2 // gh, per,
                splits, int(out_dtype == torch.float32))
    return out
