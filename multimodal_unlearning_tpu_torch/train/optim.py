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
``adamw_q8`` (int8 blockwise moments) is not ported yet.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

import torch

from multimodal_unlearning_tpu_torch.utils.pytree import (
    tree_leaves, tree_map, tree_map_with_path)


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


def global_norm(tree):
    """sqrt of the sum of squares over every leaf, in f32."""
    leaves = [x for x in tree_leaves(tree) if x is not None]
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in leaves))


def clip_by_global_norm_torch(grads, max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics, as run by HF Trainer every
    step: scale ALL grads by min(1, max_norm / (total_norm + 1e-6)) -- the
    +1e-6 is observable, so it is reproduced."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def _decayed(u, p, m, weight_decay):
    if isinstance(m, bool) or m is None:
        return u + weight_decay * p.to(u.dtype) if m else u
    return u + weight_decay * (p * torch.as_tensor(m, device=p.device)).to(u.dtype)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def make_optimizer(name: str, lr: float, *, weight_decay: float = 0.0, warmup_steps: int = 0,
                   total_steps: int = 0, max_grad_norm: float | None = None,
                   reachable_mask=None) -> Optimizer:
    """``reachable_mask``: optional params-shaped tree (or callable) of 1/0
    reachability factors -- see ``decay_mask_tree``."""
    sched = hf_linear_schedule(lr, warmup_steps, total_steps) if total_steps else None
    b1, b2, eps = 0.9, 0.999, 1e-8
    if name in ("adamw_q8", "adamw_bnb_8bit"):
        raise NotImplementedError(
            f"optimizer {name!r} (int8 blockwise moments) is not ported yet")
    if name not in ("adamw", "adamw_bnb_8bit_f32", "adamw_torch", "sgd"):
        raise ValueError(f"Unknown optimizer {name}")
    adam = name != "sgd"

    def init(params):
        state = {"count": torch.zeros((), dtype=torch.int64,
                                      device=tree_leaves(params)[0].device)}
        if adam:
            state["mu"] = tree_map(torch.zeros_like, params)
            state["nu"] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm:
            grads = clip_by_global_norm_torch(grads, max_grad_norm)
        count = state["count"]
        step_lr = lr if sched is None else sched(count)  # the pre-increment count
        new_state = {"count": count + 1}
        if not adam:
            return tree_map(lambda g: _scaled(g, -step_lr), grads), new_state
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        c = (count + 1).to(torch.float32)
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c

        def direction(m, v):
            return (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)

        upd = tree_map(direction, mu, nu)
        if weight_decay:
            mask = decay_mask_tree(params, reachable_mask)
            upd = tree_map(lambda u, p, m: _decayed(u, p, m, weight_decay), upd, params, mask)
        new_state.update(mu=mu, nu=nu)
        return tree_map(lambda u: _scaled(u, -step_lr), upd), new_state

    return Optimizer(init=init, update=update)


def _scaled(u, factor):
    """``u * factor``; a scheduled (tensor) factor widens bf16 updates to f32."""
    if isinstance(factor, torch.Tensor):
        ft = torch.promote_types(u.dtype, factor.dtype)
        return u.to(ft) * factor.to(device=u.device, dtype=ft)
    return u * factor


def apply_updates(params, updates):
    """``p + u`` in the wider of the two dtypes, cast back to p's dtype."""
    return tree_map(lambda p, u: (p + u.to(device=p.device)).to(p.dtype), params, updates)
