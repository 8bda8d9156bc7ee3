"""Optimizers: AdamW and SGD as functional updates on tensor trees.

Counterpart of ``multimodal_unlearning_tpu/train/optim.py``.  The JAX
package chains optax transformations; here an ``Optimizer`` holds the same
chain as two plain functions over nested dicts of tensors
(``utils/pytree.py``):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)   # params + updates

AdamW is ``scale_by_adam`` -> masked weight decay -> ``-lr``:
``p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * mask * p)``, with the
learning rate taken at the pre-increment step count, moments kept in the
parameters' dtype, and a decay mask that can be elementwise per stacked
layer -- which ``torch.optim.AdamW``'s parameter groups cannot express.
``adamw_q8`` (alias ``adamw_bnb_8bit``) keeps both moments in 8 bits with
one f32 scale per block of 256 entries of each flattened leaf: the first
signed int8 (absmax / 127), the second uint8 in the quartic-root domain.

A dense trainable tree (full-parameter forgetting at 7B) is too large for
a functional step: every tree-sized temporary is another 12.6 GiB.  There
``opt.step_(grads, state, params, ok=...)`` clips the gradients, updates
the moments and writes the parameters in place, leaf by leaf and, for a
stacked leaf of more than ``CHUNK_ELEMS`` entries, a layer slice at a time;
where ``ok`` is false nothing is written.  Its values equal ``update`` +
``apply_updates`` (the same elementwise expressions on each slice).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

import torch

from multimodal_unlearning_tpu_torch.utils.pytree import (
    tree_get, tree_leaves, tree_leaves_with_path, tree_map, tree_map_with_path)

_QBLOCK = 256
# a stacked leaf above this many entries is reduced and updated a layer
# slice at a time: the f32 temporaries of one slice, not of the whole leaf
CHUNK_ELEMS = 1 << 24


def hf_linear_schedule(lr: float, warmup_steps: int, total_steps: int):
    """HF Trainer default (transformers get_linear_schedule_with_warmup):
    linear warmup then linear decay to 0, evaluated at the pre-increment step
    count -- the first optimizer step runs at lr 0, like torch's LambdaLR.
    ``sched(count)`` takes an int or an integer tensor and computes in f32."""
    w = max(int(warmup_steps), 1)
    t = max(int(total_steps), w + 1)

    def sched(count):
        c = torch.as_tensor(count).to(torch.float32)
        return lr * torch.clamp(torch.minimum(c / w, (t - c) / (t - w)), min=0.0)

    return sched


_LN_COMPONENT = re.compile(r"ln\d*|ln_[a-z0-9]+|[a-z0-9]+_ln")


def _is_no_decay_component(name: str) -> bool:
    n = name.lower()
    return (
        n == "bias" or n.endswith("_bias")
        or n == "norm" or n.endswith("_norm")
        or "layernorm" in n or "rmsnorm" in n
        or bool(_LN_COMPONENT.fullmatch(n))
    )


def hf_decay_mask(params):
    """HF Trainer applies weight decay only to non-bias / non-norm
    parameters.  True = decay.  Matched against this tree's naming:
    ``*_bias``, ``input_layernorm``, ``post_attention_layernorm``, ``norm``,
    ``q_norm``/``k_norm``, and the ``ln1``/``ln2``/``pre_ln``/``post_ln``
    LayerNorm dicts (whose scale and bias both sit under the ln component)."""
    return tree_map_with_path(
        lambda path, _: not any(_is_no_decay_component(str(k)) for k in path), params)


def decay_mask_tree(params, reachable=None):
    """Effective weight-decay factor per leaf: HF's decay-parameter naming
    rule (``hf_decay_mask``) and structural reachability.  torch.optim.AdamW
    skips parameters whose ``.grad is None`` -- parameters autograd never
    reaches are never stepped nor weight-decayed by the reference, while a
    functional optimizer sees exact-zero gradients and would still decay
    them.  ``reachable`` leaves (a tree, or a callable giving one) are
    True/False or 1.0/0.0 scalars, or per-layer [L, 1, ..] tensors for
    stacked-layer leaves."""
    base = hf_decay_mask(params)
    if reachable is None:
        return base
    r = reachable(params) if callable(reachable) else reachable
    return tree_map(lambda b, m: m if b else False, base, r)


def _pieces(x, block: int = 1):
    """The layer indices a leaf is walked by (``[None]``: the whole leaf):
    a stacked leaf above ``CHUNK_ELEMS`` entries whose layer slice is a
    whole number of ``block``-entry blocks goes a slice at a time."""
    if x.ndim >= 3 and x.numel() > CHUNK_ELEMS and x[0].numel() % block == 0:
        return range(x.shape[0])
    return [None]


def _at(x, i):
    """Layer ``i`` of a leaf (or of a per-layer [L, 1, ..] mask); a bool or
    a scalar passes as it is."""
    if i is None or not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    return x[i]


def _sq_sum(x):
    return sum(torch.sum(_at(x, i).to(torch.float32) ** 2) for i in _pieces(x))


def global_norm(tree):
    """sqrt of the sum of squares over every leaf, in f32."""
    return torch.sqrt(sum(_sq_sum(x) for x in tree_leaves(tree)))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_by_global_norm_torch(grads, max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics, as run by HF Trainer every
    step: scale ALL grads by min(1, max_norm / (total_norm + 1e-6)) -- the
    +1e-6 is observable, so it is reproduced.  The f32 scale promotes bf16
    gradients to f32, as in JAX.  (optax's global norm rounds a bf16 leaf's
    sum of squares to bf16; here it stays f32.)"""
    scale = _clip_scale(global_norm(grads), max_norm)
    return tree_map(lambda g: _times(g, scale), grads)


def _times(g, scale):
    """``g * scale`` in the promoted dtype, as JAX computes it (torch would
    keep a bf16 ``g`` bf16 against a 0-d f32 scale)."""
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


def _decayed(u, p, m, weight_decay):
    if isinstance(m, bool) or m is None:
        return u + weight_decay * p.to(u.dtype) if m else u
    return u + weight_decay * (p * torch.as_tensor(m, device=p.device)).to(u.dtype)


def _scaled(u, factor):
    """``u * factor``; a scheduled (tensor) factor widens bf16 updates to f32."""
    if isinstance(factor, torch.Tensor):
        ft = torch.promote_types(u.dtype, factor.dtype)
        return u.to(ft) * factor.to(device=u.device, dtype=ft)
    return u * factor


def _applied(p, u):
    """``p + u`` in the wider of the two dtypes, cast back to p's dtype."""
    return (p + u.to(device=p.device)).to(p.dtype)


def apply_updates(params, updates):
    return tree_map(_applied, params, updates)


# ---------------------------------------------------------------------------
# int8 blockwise moment quantization (the JAX package's _quantize/_dequantize)
# ---------------------------------------------------------------------------


def _blocks(x):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _QBLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, _QBLOCK)


def _quantize(x, signed: bool):
    """signed: symmetric linear int8 (first moment).  unsigned: uint8 in the
    quartic-root domain (second moment): linear int8 would flush a block's
    small entries to 0 and m / (sqrt(v) + eps) would explode; the root keeps
    about four decades representable."""
    blocks = _blocks(x)
    if signed:
        absmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    else:
        absmax = torch.amax(blocks, dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
        w = torch.sqrt(torch.sqrt(torch.clamp(blocks, min=0.0) / scale))
        q = torch.clamp(torch.round(w * 255.0), 0, 255).to(torch.uint8)
    return q, scale.to(torch.float32)


def _dequantize(q, scale, shape):
    if q.dtype == torch.uint8:
        w = q.to(torch.float32) / 255.0
        w2 = w * w  # w ** 4 as XLA's integer_pow computes it: (w * w) squared
        blocks = (w2 * w2) * scale
    else:
        blocks = q.to(torch.float32) * scale
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


def dequantize_moment(mom: dict, shape):
    """A quantized moment ``{"q", "scale"}`` of a leaf of ``shape`` in f32."""
    return _dequantize(mom["q"], mom["scale"], shape)


def _q8_init(p):
    nb = -(-p.numel() // _QBLOCK)
    ones = torch.ones((nb, 1), dtype=torch.float32, device=p.device)
    return ({"q": torch.zeros((nb, _QBLOCK), dtype=torch.int8, device=p.device),
             "scale": ones},
            {"q": torch.zeros((nb, _QBLOCK), dtype=torch.uint8, device=p.device),
             "scale": ones.clone()})


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    step_: Callable


def make_optimizer(name: str, lr: float, *, weight_decay: float = 0.0, warmup_steps: int = 0,
                   total_steps: int = 0, max_grad_norm: float | None = None,
                   reachable_mask=None) -> Optimizer:
    """``reachable_mask``: optional params-shaped tree (or callable) of 1/0
    reachability factors -- see ``decay_mask_tree``."""
    sched = hf_linear_schedule(lr, warmup_steps, total_steps) if total_steps else None
    b1, b2, eps = 0.9, 0.999, 1e-8
    q8 = name in ("adamw_q8", "adamw_bnb_8bit")
    if not q8 and name not in ("adamw", "adamw_bnb_8bit_f32", "adamw_torch", "sgd"):
        raise ValueError(f"Unknown optimizer {name}")
    adam = name != "sgd"

    def init(params):
        state = {"count": torch.zeros((), dtype=torch.int64,
                                      device=tree_leaves(params)[0].device)}
        if q8:
            mv = tree_map(_q8_init, params)
            state["m"] = tree_map(lambda t: t[0], mv)
            state["v"] = tree_map(lambda t: t[1], mv)
        elif adam:
            state["mu"] = tree_map(torch.zeros_like, params)
            state["nu"] = tree_map(torch.zeros_like, params)
        return state

    def masks(params):
        if weight_decay:
            return decay_mask_tree(params, reachable_mask)
        return tree_map(lambda _: True, params)

    def adam_leaf(g, m, v, p, mask, step_lr, bc1, bc2):
        """(update, new first moment, new second moment) of one leaf or slice."""
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g * g) + b2 * v
        u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)
        if weight_decay:
            u = _decayed(u, p, mask, weight_decay)
        return _scaled(u, -step_lr), m, v

    def q8_leaf(g, mq, ms, vq, vs, p, wd_on, step_lr, c):
        """(update in p's dtype, (m q, scale), (v q, scale)) of one leaf or
        of one block-aligned slice, in f32 as the JAX package's leaf_update;
        the learning rate at the pre-increment count, the bias corrections
        at the post-increment one (``c``)."""
        g32 = g.to(torch.float32)
        m = _dequantize(mq, ms, g.shape)
        v = _dequantize(vq, vs, g.shape)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / (1 - b1 ** c)
        vhat = v / (1 - b2 ** c)
        p32 = p.to(torch.float32)
        if isinstance(wd_on, bool):
            decay = weight_decay * p32 if wd_on else 0.0
        else:
            decay = weight_decay * (p32 * torch.as_tensor(wd_on, device=p.device))
        upd = -step_lr * (mhat / (torch.sqrt(vhat) + eps) + decay)
        return upd.to(p.dtype), _quantize(m, True), _quantize(v, False)

    def lr_of(count):
        return lr if sched is None else sched(count)  # the pre-increment count

    def corrections(count):
        c = (count + 1).to(torch.float32)
        return c, 1 - b1 ** c, 1 - b2 ** c

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm:
            grads = clip_by_global_norm_torch(grads, max_grad_norm)
        count = state["count"]
        step_lr = lr_of(count)
        new_state = {"count": count + 1}
        if not adam:
            return tree_map(lambda g: _scaled(g, -step_lr), grads), new_state
        c, bc1, bc2 = corrections(count)
        mask = masks(params)
        if q8:
            q8_lr = torch.as_tensor(step_lr, dtype=torch.float32, device=count.device)
            out = tree_map(lambda g, m, v, p, k: q8_leaf(g, m["q"], m["scale"], v["q"],
                                                           v["scale"], p, k, q8_lr, c),
                           grads, state["m"], state["v"], params, mask)
            new_state["m"] = tree_map(lambda o: dict(zip(("q", "scale"), o[1])), out)
            new_state["v"] = tree_map(lambda o: dict(zip(("q", "scale"), o[2])), out)
            return tree_map(lambda o: o[0], out), new_state
        out = tree_map(lambda g, m, v, p, k: adam_leaf(g, m, v, p, k, step_lr, bc1, bc2),
                       grads, state["mu"], state["nu"], params, mask)
        new_state["mu"] = tree_map(lambda o: o[1], out)
        new_state["nu"] = tree_map(lambda o: o[2], out)
        return tree_map(lambda o: o[0], out), new_state

    @torch.no_grad()
    def step_(grads, state, params, *, ok=None, grad_norm=None):
        """``update`` + ``apply_updates`` in place: ``params`` and ``state``
        are overwritten (``grads`` is read only).  ``ok`` (a bool
        tensor, or None for always): where it is false, parameters and
        moments keep their bits and the count does not advance.
        ``grad_norm``: the gradients' global norm if the caller has it."""
        def put(dst, new):
            dst.copy_(new if ok is None else torch.where(ok, new, dst))

        gscale = None
        if max_grad_norm:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            gscale = _clip_scale(norm, max_grad_norm)

        def grad_at(g, i):  # clipped a slice at a time, as the functional clip
            return _at(g, i) if gscale is None else _times(_at(g, i), gscale)

        count = state["count"]
        step_lr = lr_of(count)
        c, bc1, bc2 = corrections(count)
        mask = dict(tree_leaves_with_path(masks(params))) if adam else {}
        q8_lr = torch.as_tensor(step_lr, dtype=torch.float32, device=count.device)
        for path, p in tree_leaves_with_path(params):
            g = tree_get(grads, path)
            if q8:
                m, v = tree_get(state["m"], path), tree_get(state["v"], path)
                rows = p[0].numel() // _QBLOCK if p.ndim else 0
                for i in _pieces(p, _QBLOCK):
                    r = slice(None) if i is None else slice(i * rows, (i + 1) * rows)
                    upd, (mq, ms), (vq, vs) = q8_leaf(
                        grad_at(g, i), m["q"][r], m["scale"][r], v["q"][r], v["scale"][r],
                        _at(p, i), _at(mask[path], i), q8_lr, c)
                    put(_at(p, i), _applied(_at(p, i), upd))
                    for dst, new in ((m["q"], mq), (m["scale"], ms), (v["q"], vq),
                                     (v["scale"], vs)):
                        put(dst[r], new)
            elif adam:
                mu, nu = tree_get(state["mu"], path), tree_get(state["nu"], path)
                for i in _pieces(p):
                    u, m_new, v_new = adam_leaf(grad_at(g, i), _at(mu, i), _at(nu, i), _at(p, i),
                                                _at(mask[path], i), step_lr, bc1, bc2)
                    put(_at(p, i), _applied(_at(p, i), u))
                    put(_at(mu, i), m_new)
                    put(_at(nu, i), v_new)
            else:
                for i in _pieces(p):
                    put(_at(p, i), _applied(_at(p, i), _scaled(grad_at(g, i), -step_lr)))
        put(count, count + 1)

    return Optimizer(init=init, update=update, step_=step_)
