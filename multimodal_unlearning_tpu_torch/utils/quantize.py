"""Int8 weight quantization for frozen parameter trees (QLoRA-style).

Counterpart of ``multimodal_unlearning_tpu/utils/quantize.py``, int8 only.
A quantized leaf is ``{"q": int8[..., in, out], "s": f32[..., 1, out]}``
(per-output-channel symmetric int8): a plain dict in a dict tree, a
``QTensor`` module holding the two arrays at the same paths in a model.
``models/llama.dense`` and the embedding lookup dequantize transparently
(W8A16), or run W8A8 through ``int8_matmul`` when
``llama.enable_int8_compute`` is on.

The W8A8 products are exact int8 x int8 -> int32: ``torch._int_mm`` on the
card, an int32 matmul on the CPU.  Grouped int4 leaves (``"q4"``) and the MoE
expert functions are not ported yet.
"""

from __future__ import annotations

import copy

import torch
from torch import nn
from torch.profiler import record_function

_MIN_QUANT_ELEMS = 2**16
_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class QTensor(nn.Module):
    """A quantized leaf inside a model: ``q`` and ``s`` at the JAX tree's
    paths ``<leaf>.q`` and ``<leaf>.s``, frozen.  Indexing the stacked layer
    dimension gives the plain ``{"q", "s"}`` dict the functions below take."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.q = nn.Parameter(q, requires_grad=False)
        self.s = nn.Parameter(s, requires_grad=False)

    def __getitem__(self, index) -> dict:
        return {"q": self.q[index], "s": self.s[index]}

    @property
    def shape(self):
        return self.q.shape


def is_qtensor(x) -> bool:
    if isinstance(x, QTensor):
        return True
    return isinstance(x, dict) and set(x.keys()) in ({"q", "s"}, {"q4", "s"})


def qs_of(qt):
    """(q, s) of a quantized leaf in either form."""
    if isinstance(qt, QTensor):
        return qt.q, qt.s
    if "q4" in qt:
        raise NotImplementedError("grouped int4 leaves are not ported yet (slice 6)")
    return qt["q"], qt["s"]


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
    (``int_matmul``).  Shapes and values are unchanged."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def _quantize(w):
    if w.ndim <= 2:
        return _quantize_2d(w)
    parts = [_quantize(w[i]) for i in range(w.shape[0])]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


@torch.no_grad()
def quantize_leaf(w) -> dict:
    """Per-output-channel (last dim) symmetric int8, ``q`` laid out as
    ``in_contiguous`` gives it.  A stacked leaf is quantized one leading
    index at a time, which bounds the f32 transients to one layer's weight
    and changes no value."""
    q, s = _quantize(w)
    return {"q": in_contiguous(q), "s": s}


def dequantize_leaf(qt, dtype=torch.bfloat16):
    q, s = qs_of(qt)
    return (q.to(torch.float32) * s).to(dtype)


def embed_lookup(et, input_ids):
    """Dequantizing embedding lookup for a quantized table [V, H]: gather
    the int8 rows, then apply the one [1, H] channel-scale row.  f32 out."""
    q, s = qs_of(et)
    return q[input_ids].to(torch.float32) * s[0]


def _want_quant(v, min_elems: int) -> bool:
    return (
        isinstance(v, torch.Tensor) and v.ndim >= 2
        and v.shape[-1] >= 256 and v.shape[-2] >= 256  # matmul weights only
        and v.dtype in _FLOAT_DTYPES
        and v.numel() >= min_elems
    )


def _check_bits(bits: int) -> None:
    if bits == 4:
        raise NotImplementedError("bits=4 (grouped int4, W4A16) is not ported yet (slice 6)")
    if bits != 8:
        raise ValueError(f"bits must be 8 or 4, got {bits}")


def quantize_tree(params, *, bits: int = 8, min_elems: int = _MIN_QUANT_ELEMS):
    """Quantize every large (>= 2-D) float leaf; small leaves stay as they
    are.  Returns a new tree (a dict tree, or a deep copy of a module) and
    leaves ``params`` alone: the float tree and the quantized one are alive
    together.  See ``quantize_tree_inplace`` for trees near the memory limit."""
    _check_bits(bits)
    if isinstance(params, nn.Module):
        return quantize_tree_inplace(copy.deepcopy(params), bits=bits, min_elems=min_elems)
    if isinstance(params, dict) and not is_qtensor(params):
        return {k: quantize_tree(v, bits=bits, min_elems=min_elems) for k, v in params.items()}
    return quantize_leaf(params) if _want_quant(params, min_elems) else params


def quantize_tree_inplace(params, *, bits: int = 8, min_elems: int = _MIN_QUANT_ELEMS):
    """Destructive ``quantize_tree``: quantizes leaf by leaf and drops each
    float leaf before touching the next, so the peak is the float tree plus
    one leaf's transients.  ``params`` (a module, or a nested dict of tensors)
    is changed and also returned; a quantized leaf of a module becomes a
    ``QTensor`` at the same path.  Leaves equal ``quantize_tree``'s exactly.

    Only modules and nested dicts are traversed; a list or tuple container
    would be silently skipped, so it raises."""
    _check_bits(bits)
    if isinstance(params, nn.Module):
        for module in list(params.modules()):
            if isinstance(module, QTensor):
                continue
            # names only: a list of the parameters would keep every float
            # leaf alive until the loop ends
            for name in [n for n, _ in module.named_parameters(recurse=False)]:
                p = getattr(module, name)
                if _want_quant(p, min_elems):
                    leaf = quantize_leaf(p.data)
                    delattr(module, name)
                    del p
                    setattr(module, name, QTensor(leaf["q"], leaf["s"]))
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
                d[key] = quantize_leaf(v)
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
