"""Weight quantization for frozen parameter trees (QLoRA-style).

Counterpart of ``multimodal_unlearning_tpu/utils/quantize.py``.  A quantized
leaf is ``{"q": int8[..., in, out], "s": f32[..., 1, out]}`` (per-output-
channel symmetric int8) or ``{"q4": int8[..., in/2, out], "s": f32[..., in/G,
out]}`` (grouped int4, two values nibble-packed per byte along the
contracting dim, half-split: byte i holds row i in its low nibble and row
i + in/2 in its high nibble): a plain dict in a dict tree, a ``QTensor`` /
``QTensor4`` module holding the two arrays at the same paths in a model.
Both store their int8 array with the ``in`` (``in/2``) dimension contiguous
(``in_contiguous``); shapes and values are the JAX leaves'.
``models/llama.dense`` and the embedding lookup dequantize transparently:
int8 per layer (W8A16), or W8A8 through ``int8_matmul`` when
``llama.enable_int8_compute`` is on; int4 through ``int4_matmul`` (W4A16:
kernel B8 for M <= 1024 rows, ``ops/int4_matmul.py``), whatever that flag.

The W8A8 products are exact int8 x int8 -> int32: ``torch._int_mm`` on the
card, an int32 matmul on the CPU.  The MoE expert functions are not ported
yet.
"""

from __future__ import annotations

import collections
import copy

import torch
from torch import nn
from torch.profiler import record_function

from multimodal_unlearning_tpu_torch.ops.int4_matmul import (
    dequant_halves, grouped_int4_matmul, nibbles as _nibbles, supported as _int4_supported,
    with_dx)

_MIN_QUANT_ELEMS = 2**16
_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
INT4_MAX_KERNEL_ROWS = 1024  # int4_matmul: B8 up to this many rows, then the dequant path


class QTensor(nn.Module):
    """An int8 quantized leaf inside a model: ``q`` and ``s`` at the JAX
    tree's paths ``<leaf>.q`` and ``<leaf>.s``, frozen.  Indexing the stacked
    layer dimension gives the plain ``{"q", "s"}`` dict the functions below
    take."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.q = nn.Parameter(q, requires_grad=False)
        self.s = nn.Parameter(s, requires_grad=False)

    def __getitem__(self, index) -> dict:
        return {"q": self.q[index], "s": self.s[index]}

    @property
    def shape(self):
        return self.q.shape


class QTensor4(nn.Module):
    """A grouped-int4 leaf inside a model: the packed ``q4`` and the group
    scales ``s`` at the JAX tree's paths ``<leaf>.q4`` and ``<leaf>.s``,
    frozen.  Indexing the stacked layer dimension gives the plain
    ``{"q4", "s"}`` dict.  ``shape`` is the packed array's ([..., in/2, out])."""

    def __init__(self, q4: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.q4 = nn.Parameter(q4, requires_grad=False)
        self.s = nn.Parameter(s, requires_grad=False)

    def __getitem__(self, index) -> dict:
        return {"q4": self.q4[index], "s": self.s[index]}

    @property
    def shape(self):
        return self.q4.shape


def is_qtensor(x) -> bool:
    """A quantized leaf of either kind, in either form."""
    if isinstance(x, (QTensor, QTensor4)):
        return True
    return isinstance(x, dict) and set(x.keys()) in ({"q", "s"}, {"q4", "s"})


def is_int4(x) -> bool:
    """A grouped-int4 leaf, in either form."""
    return isinstance(x, QTensor4) or (isinstance(x, dict) and set(x.keys()) == {"q4", "s"})


def qs_of(qt):
    """(values, scales) of a quantized leaf in either form: the int8 ``q``,
    or for an int4 leaf the packed ``q4``."""
    if isinstance(qt, QTensor):
        return qt.q, qt.s
    if isinstance(qt, QTensor4):
        return qt.q4, qt.s
    return (qt["q4"] if "q4" in qt else qt["q"]), qt["s"]


def _quantize_2d(w):
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q, s


def in_contiguous(q):
    """The same [..., in, out] int8 values stored with the ``in`` dimension
    contiguous (strides (.., 1, in)): the layout in which the forward W8A8
    product, which contracts over ``in``, reaches the int8 tensor cores
    (``int_matmul``), and in which B8 reads a column's packed bytes as one
    run.  Shapes and values are unchanged."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def _per_layer(fn, w):
    """``fn`` on a 2-D weight, or on each leading index of a stacked one
    (bounds the f32 transients to one layer's weight; changes no value)."""
    if w.ndim <= 2:
        return fn(w)
    parts = [_per_layer(fn, w[i]) for i in range(w.shape[0])]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


@torch.no_grad()
def quantize_leaf(w) -> dict:
    """Per-output-channel (last dim) symmetric int8, ``q`` laid out as
    ``in_contiguous`` gives it.  A stacked leaf is quantized one leading
    index at a time, which bounds the f32 transients to one layer's weight
    and changes no value."""
    q, s = _per_layer(_quantize_2d, w)
    return {"q": in_contiguous(q), "s": s}


def _int4_groups(in_dim: int, group_size: int) -> int:
    """Largest divisor of ``in_dim`` that is <= group_size (scale groups
    must tile the contracting dim exactly)."""
    g = min(group_size, in_dim)
    while in_dim % g:
        g -= 1
    return g


def _quantize_int4_2d(w, group_size):
    w32 = w.to(torch.float32)
    in_dim, out = w32.shape
    # scale groups must not straddle the half boundary
    g = _int4_groups(in_dim // 2, group_size)
    wg = w32.reshape(in_dim // g, g, out)
    absmax = wg.abs().amax(dim=-2)                                   # [in/g, out]
    s = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wg / s[:, None, :]), -7, 7).reshape(in_dim, out).to(torch.int8)
    half = in_dim // 2
    return (q[:half] & 0xF) | (q[half:] << 4), s


@torch.no_grad()
def quantize_leaf_int4(w, group_size: int = 128) -> dict:
    """Group-wise symmetric int4 along the CONTRACTING (second-to-last) dim:
    ``group_size`` input channels (the largest divisor of in/2 not above it)
    share one f32 scale per output channel, the AWQ/GPTQ-style W4A16 layout.
    Leaf = {"q4": int8[..., in/2, out], "s": f32[..., in/G, out]}, half-split
    nibble packing (byte i: row i low, row i + in/2 high), ``q4`` laid out as
    ``in_contiguous`` gives it.  A stacked leaf is quantized one leading
    index at a time."""
    if w.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even contracting dim, got {w.shape[-2]}")
    q4, s = _per_layer(lambda t: _quantize_int4_2d(t, group_size), w)
    return {"q4": in_contiguous(q4), "s": s}


def unpack_int4(packed):
    """Nibble-packed int8 [..., in/2, out] -> int4 VALUES as int8 [..., in,
    out] (half-split layout: low nibbles are rows [0, in/2), high the rest)."""
    return torch.cat(_nibbles(packed), dim=-2)


def dequantize_leaf(qt, dtype=torch.bfloat16):
    q, s = qs_of(qt)
    if is_int4(qt):  # grouped int4: scales along the contracting dim
        v = unpack_int4(q)
        *lead, in_dim, out = v.shape
        n_groups = s.shape[-2]
        vg = v.to(torch.float32).reshape(*lead, n_groups, in_dim // n_groups, out)
        return (vg * s[..., :, None, :]).reshape(*lead, in_dim, out).to(dtype)
    return (q.to(torch.float32) * s).to(dtype)


def embed_lookup(et, input_ids):
    """Dequantizing embedding lookup for a quantized table [V, H]: gather
    the quantized rows, then the matching scales (int8: the one [1, H]
    channel-scale row; int4: the token's vocab-group row of the [V/G, H]
    grid).  An int4 table is nibble-packed along V: gather the pair row,
    pick the token's nibble.  f32 out."""
    q, s = qs_of(et)
    if is_int4(et):
        half = q.shape[0]
        lo, hi = _nibbles(q[input_ids % half])                         # [..., H]
        rows = torch.where((input_ids < half)[..., None], lo, hi)
        g = 2 * half // s.shape[0]
        return rows.to(torch.float32) * s[input_ids // g]
    return q[input_ids].to(torch.float32) * s[0]


def _want_quant(v, min_elems: int) -> bool:
    return (
        isinstance(v, torch.Tensor) and v.ndim >= 2
        and v.shape[-1] >= 256 and v.shape[-2] >= 256  # matmul weights only
        and v.dtype in _FLOAT_DTYPES
        and v.numel() >= min_elems
    )


def _leaf_quantizer(bits: int, group_size: int):
    """The leaf function of ``bits`` (8: per-channel int8, 4: grouped int4)."""
    if bits == 8:
        return quantize_leaf
    if bits == 4:
        return lambda w: quantize_leaf_int4(w, group_size)
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def _module_leaf(leaf: dict) -> nn.Module:
    return QTensor4(leaf["q4"], leaf["s"]) if "q4" in leaf else QTensor(leaf["q"], leaf["s"])


def quantize_tree(params, *, bits: int = 8, group_size: int = 128,
                  min_elems: int = _MIN_QUANT_ELEMS):
    """Quantize every large (>= 2-D) float leaf; small leaves stay as they
    are.  ``bits``: 8 = per-output-channel int8 (the W8A16/W8A8 base), 4 =
    grouped int4 with ``group_size`` (W4A16, half the int8 weight stream).
    Returns a new tree (a dict tree, or a deep copy of a module) and leaves
    ``params`` alone: the float tree and the quantized one are alive
    together.  See ``quantize_tree_inplace`` for trees near the memory limit."""
    qfn = _leaf_quantizer(bits, group_size)
    if isinstance(params, nn.Module):
        return quantize_tree_inplace(copy.deepcopy(params), bits=bits, group_size=group_size,
                                     min_elems=min_elems)
    if isinstance(params, dict) and not is_qtensor(params):
        return {k: quantize_tree(v, bits=bits, group_size=group_size, min_elems=min_elems)
                for k, v in params.items()}
    return qfn(params) if _want_quant(params, min_elems) else params


def quantize_tree_inplace(params, *, bits: int = 8, group_size: int = 128,
                          min_elems: int = _MIN_QUANT_ELEMS):
    """Destructive ``quantize_tree``: quantizes leaf by leaf and drops each
    float leaf before touching the next, so the peak is the float tree plus
    one leaf's transients.  ``params`` (a module, or a nested dict of tensors)
    is changed and also returned; a quantized leaf of a module becomes a
    ``QTensor`` (int8) or ``QTensor4`` (int4) at the same path.  Leaves equal
    ``quantize_tree``'s exactly.

    Only modules and nested dicts are traversed; a list or tuple container
    would be silently skipped, so it raises."""
    qfn = _leaf_quantizer(bits, group_size)
    if isinstance(params, nn.Module):
        for module in list(params.modules()):
            if isinstance(module, (QTensor, QTensor4)):
                continue
            # names only: a list of the parameters would keep every float
            # leaf alive until the loop ends
            for name in [n for n, _ in module.named_parameters(recurse=False)]:
                p = getattr(module, name)
                if _want_quant(p, min_elems):
                    leaf = qfn(p.data)
                    delattr(module, name)
                    del p
                    setattr(module, name, _module_leaf(leaf))
        return params

    def rec(d, path):
        if not isinstance(d, dict) or is_qtensor(d):
            return d
        for key in list(d.keys()):
            v = d[key]
            if isinstance(v, dict):
                rec(v, path + (key,))
            elif isinstance(v, (list, tuple)):
                raise TypeError(
                    "quantize_tree_inplace traverses dicts only; found a "
                    f"{type(v).__name__} container at {'/'.join(path + (key,))} "
                    "-- use quantize_tree or restructure the tree as dicts")
            elif _want_quant(v, min_elems):
                d[key] = None  # drop the float leaf first
                d[key] = qfn(v)
                del v
        return d

    return rec(params, ())


def tree_nbytes(tree) -> int:
    """Bytes held by a module's parameters or a dict tree's tensors."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


# ---------------------------------------------------------------------------
# W4A16 matmul: grouped int4 weights against float activations.
# ---------------------------------------------------------------------------

# (M, K, N) -> calls of int4_matmul that took the dequant path
INT4_DEQUANT_CALLS: collections.Counter = collections.Counter()


def int4_matmul(x, q4, s, out_dtype=None):
    """``x @ dequant(q4, s)``.  x: [..., in], q4: [in/2, out] half-split
    nibble-packed, s: [in/G, out] with G | in/2.  Dispatches as the JAX
    function does: at most ``INT4_MAX_KERNEL_ROWS`` rows (decode, verify
    rounds, chunked-prefill passes, short prefills) on a shape B8 takes
    (``ops/int4_matmul.supported``) go to ``grouped_int4_matmul`` (B8 on the
    card, its plain version on the CPU), which keeps the packed bytes as the
    only weight traffic.  Anything else -- a long prefill, an odd group --
    dequantizes each half of this one weight to x's dtype and multiplies it
    with ``torch.matmul``, and is counted in ``INT4_DEQUANT_CALLS``.
    Differentiable in x on either route (QLoRA over an int4 base): the
    backward dequantizes the weight and multiplies
    (``ops/int4_matmul.int4_dx``, counted in ``INT4_BWD_CALLS``); the base
    gets no gradient.  ``enable_int8_compute`` and ``enable_int8_bwd`` do
    nothing here: W8A8 and the int8 dx are int8-only, as in the JAX
    package."""
    return with_dx(_int4_route, x, q4, s, out_dtype)


def _int4_route(x, q4, s, out_dtype):
    out_dtype = out_dtype or x.dtype
    K, N = x.shape[-1], q4.shape[-1]
    M = x.numel() // K if K else 0
    if q4.ndim == 2 and M <= INT4_MAX_KERNEL_ROWS and _int4_supported(q4, s):
        y = grouped_int4_matmul(x.reshape(M, K), q4, s, out_dtype)
        return y.reshape(*x.shape[:-1], N)
    INT4_DEQUANT_CALLS[(M, K, N)] += 1
    return int4_dequant_matmul(x, q4, s, out_dtype)


def int4_dequant_matmul(x, q4, s, out_dtype=None):
    """The dequant path of ``int4_matmul``: each half of the one weight
    dequantized to x's dtype (f32 group scales applied first), then
    ``torch.matmul``.  Not counted: ``int4_matmul`` counts its calls."""
    out_dtype = out_dtype or x.dtype
    half = q4.shape[-2]
    with record_function("mmu::int4_dequant_matmul"):
        lo, hi = dequant_halves(q4, s, x.dtype)
        y = x[..., :half] @ lo
        y = y + x[..., half:] @ hi
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# W8A8 matmul (opt-in): dynamic per-row int8 activations against int8 weights.
# Backward is a straight-through matmul against the dequantized weight (the
# weight is frozen, so only dx is needed), or an int8 product too when
# ``enable_int8_bwd`` is on.
# ---------------------------------------------------------------------------

INT8_BWD = False  # set via enable_int8_bwd(); int8 product for the dx backward too


def enable_int8_bwd(on: bool = True):
    """Opt-in: run the dx backward of quantized matmuls as an int8 product
    as well (per-row dynamic quantization of dy with the weight's column
    scales folded in).  Adds int8 rounding noise to upstream gradients.  The
    flag is read when a backward pass runs."""
    global INT8_BWD
    INT8_BWD = on


def int_matmul(a, b):
    """Exact ``a @ b`` of int8 matrices [M, K] x [K, N] in int32.

    On the card ``torch._int_mm``, which wants more than 16 rows in ``a`` and
    multiples of 8 in K and N: smaller or odd operands are zero-padded, which
    keeps the product exact.  It reaches the int8 tensor cores only when K is
    the contiguous dimension of both operands (860 against 128 TOP/s on an
    H100, ``bench_int_mm.py``), so a ``b`` stored otherwise -- the transposed
    view the dx backward passes -- is copied into that layout first.  On the
    CPU an int32 matmul."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    M, K = a.shape
    N = b.shape[1]
    if b.stride(0) != 1:
        b = in_contiguous(b)
    pm = max(32 - M, 0) if M <= 16 else 0
    pk, pn = (-K) % 8, (-N) % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    y = torch._int_mm(a, b)
    return y[:M, :N] if (pm or pn) else y


def _quantize_rows(x32):
    """Dynamic symmetric int8 per row (last dim) of an f32 tensor."""
    with record_function("mmu::int8_quantize"):
        a = x32.abs().amax(dim=-1, keepdim=True)
        sx = torch.where(a > 0, a / 127.0, torch.ones_like(a))
        xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def _w8a8(xq, sx, q, s, lead, dtype):
    y32 = int_matmul(xq.reshape(-1, xq.shape[-1]), q)
    with record_function("mmu::int8_rescale"):
        y = y32.to(torch.float32).reshape(*lead, q.shape[-1])
        return (y * sx * s.reshape(-1)).to(dtype)


def _int8_dx(dy, q, s):
    """dx = dy @ W^T for W = q*s (s per output column of W): fold s into dy
    elementwise, quantize per row, contract int8 against q's columns."""
    with record_function("mmu::int8_quantize"):
        dys = dy.to(torch.float32) * s.reshape(-1)
    dq, sdy = _quantize_rows(dys)
    dx32 = int_matmul(dq.reshape(-1, dq.shape[-1]), q.t())
    with record_function("mmu::int8_rescale"):
        dx = dx32.to(torch.float32).reshape(*dy.shape[:-1], q.shape[0])
        return (dx * sdy).to(dy.dtype)


def _dx(dy, q, s):
    if INT8_BWD:
        return _int8_dx(dy, q, s)
    w = (q.to(torch.float32) * s).to(dy.dtype)  # dequantize once per layer
    return dy @ w.t()


class _Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, s):
        xq, sx = _quantize_rows(x.to(torch.float32))
        ctx.save_for_backward(q, s)
        return _w8a8(xq, sx, q, s, x.shape[:-1], x.dtype)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        q, s = ctx.saved_tensors
        return _dx(dy, q, s), None, None


class _Int8MatmulGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, *qs_ss):
        qs, ss = qs_ss[:n], qs_ss[n:]
        xq, sx = _quantize_rows(x.to(torch.float32))
        ctx.save_for_backward(*qs_ss)
        ctx.n = n
        return tuple(_w8a8(xq, sx, q, s, x.shape[:-1], x.dtype) for q, s in zip(qs, ss))

    @staticmethod
    def backward(ctx, *dys):
        n = ctx.n
        if not ctx.needs_input_grad[0]:
            return (None,) * (2 + 2 * n)
        saved = ctx.saved_tensors  # read once: a checkpointed region unpacks only once
        qs, ss = saved[:n], saved[n:]
        dx, dt = None, None
        for dy, q, s in zip(dys, qs, ss):
            if dy is None:
                continue
            dt = dy.dtype
            t = _dx(dy, q, s).to(torch.float32)
            dx = t if dx is None else dx + t
        return (None if dx is None else dx.to(dt), None) + (None,) * (2 * n)


def int8_matmul(x, q, s):
    """W8A8 ``x @ (q*s)``: x [..., in] quantized per row, q int8 [in, out],
    s f32 [1, out]; straight-through gradient for x, none for q and s."""
    return _Int8Matmul.apply(x, q, s)


def int8_matmul_group(x, qs, ss):
    """Several W8A8 projections of one input (q/k/v share the attention
    input, gate/up the MLP input): the activations are quantized once.
    Returns one output per (q, s) pair."""
    return _Int8MatmulGroup.apply(x, len(qs), *qs, *ss)
