"""Gradient-projection unlearning: the port's copy of
``multimodal_unlearning_tpu/train/grad_proj.py``.

Two backward passes a step, the forget (ascent) batch and the retain batch,
then at the optimizer:

- ``grad_proj``: g = g_neg - min(<g_neg, g_pos> / |g_pos|^2, 0) * g_pos, one
  coefficient per parameter tensor of the reference, which on the stacked
  ``[L, ...]`` layer leaves is one per layer (the leading axis) and on a
  flat leaf one per leaf;
- ``grad_proj_l2``: the intended objective L_pos + gamma * |grad L_neg -
  grad L_pos|^2, differentiated exactly (second order).  Its gradient is
  g_pos + H_neg v - H_pos v with v = 2 gamma (g_neg - g_pos): two
  Hessian-vector products through the graphs of the two first backward
  passes (``create_graph=True``), accumulated in place into g_pos: beside
  the parameters the step holds two tree-sized buffers (g_neg, then v in
  its place; g_pos, which becomes the gradient) and no f32 tree.  ``ref_behavior`` steps on g_pos alone, the
  reference's actual numerics.

Losses are the per-sequence token mean of the CE, then the batch mean; the
negative loss is its negation.  The optimizer is SGD; the step updates the
trainable tree in place (``Optimizer.step_``).
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.train.losses import shift
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path

PROJECTION_METHODS = ("grad_proj", "grad_proj_l2")


def per_seq_mean_ce(logits, labels):
    """Per-sequence mean CE (sum over the valid tokens / their count), then
    the batch mean -- not HF's global token mean."""
    lg, lb = shift(logits, labels)
    valid = lb != -100
    lb_safe = torch.where(valid, lb, torch.zeros_like(lb)).long()
    lg32 = lg.to(torch.promote_types(lg.dtype, torch.float32))
    lse = torch.logsumexp(lg32, dim=-1)
    ll = torch.gather(lg32, -1, lb_safe[..., None])[..., 0]
    nll = torch.where(valid, lse - ll, torch.zeros_like(lse))
    per_seq = nll.sum(-1) / torch.clamp(valid.sum(-1), min=1)
    return per_seq.mean()


def _is_stacked(path) -> bool:
    """A leaf under the stacked-layers subtree (leading dim = L)."""
    return "layers" in path


def _project_(path, n, p) -> None:
    """The reference's per-tensor projection of one leaf, written into
    ``n``: a stacked leaf gets one coefficient per layer (the sums over
    every axis but the first), a flat leaf one.  f32 arithmetic, a layer
    at a time."""
    for i in (range(n.shape[0]) if _is_stacked(path) and n.ndim >= 1 else (None,)):
        ni, pi = (n, p) if i is None else (n[i], p[i])
        n32, p32 = ni.float(), pi.float()
        coef = torch.clamp((n32 * p32).sum() / ((p32 * p32).sum() + 1e-30), max=0.0)
        ni.copy_((n32 - coef * p32).to(n.dtype))


def _slices(a, b):
    """Matching slices of two tensors of one shape: along the first axis
    for a tensor of two or more axes, else the whole tensors."""
    if a.ndim < 2:
        return [(a, b)]
    return [(a[i], b[i]) for i in range(a.shape[0])]


def _dot(a: list, b: list):
    return sum((x.float() * y.float()).sum() for x, y in zip(a, b))


def make_grad_proj_step(apply_fn, optimizer, *, method: str = "grad_proj", gamma: float = 1.0,
                        ref_behavior: bool = False):
    """step(trainable, opt_state, frozen, batch) -> (trainable, opt_state, metrics).

    ``batch``: {"forget": {...}, "retain": {...}}, each with input_ids,
    labels and attention_mask tensors on the device.  ``trainable`` (a dict
    tree of tensors with ``requires_grad``) and ``opt_state`` are updated
    in place and returned.  ``frozen``: LoRA's base (``apply_fn`` gets
    ``(frozen, trainable)``), or None.  The metrics are 0-d tensors on the
    device: ``neg_loss`` and ``pos_loss`` after the update, and for
    ``grad_proj`` the global inner product of the two gradients."""
    if method not in PROJECTION_METHODS:
        raise ValueError(f"method must be one of {PROJECTION_METHODS}")

    def loss(trainable, frozen, part, sign):
        out = apply_fn((frozen, trainable) if frozen is not None else trainable, part)
        return sign * per_seq_mean_ce(out["logits"], part["labels"])

    def neg_loss(trainable, frozen, batch):
        return loss(trainable, frozen, batch["forget"], -1.0)

    def pos_loss(trainable, frozen, batch):
        return loss(trainable, frozen, batch["retain"], 1.0)

    def grads_of(fn, trainable, frozen, batch, leaves, create_graph=False):
        with torch.enable_grad():
            value = fn(trainable, frozen, batch)
            g = torch.autograd.grad(value, leaves, allow_unused=True, create_graph=create_graph)
        return [torch.zeros_like(p) if x is None else x for x, p in zip(g, leaves)]

    def l2_grads(trainable, frozen, batch, leaves):
        gn = grads_of(neg_loss, trainable, frozen, batch, leaves, create_graph=True)
        gp = grads_of(pos_loss, trainable, frozen, batch, leaves, create_graph=True)
        with torch.no_grad():
            # v = 2 gamma (g_neg - g_pos) in f32, in each gradient's dtype (the
            # cotangent of the f32 difference), a layer at a time, written over
            # g_neg's values, which nothing reads again
            for a, b in zip(gn, gp):
                for x, y in _slices(a.detach(), b.detach()):
                    x.copy_((2.0 * gamma * (x.float() - y.float())).to(x.dtype))
            # the parameters' .grad starts as g_pos (its storage): the two
            # Hessian-vector products accumulate into it in place, so no third
            # or fourth tree-sized buffer is made
            for p, b in zip(leaves, gp):
                p.grad = b.detach()
        for graph, sign in ((gn, 1.0), (gp, -1.0)):
            live = [i for i, x in enumerate(graph) if x.requires_grad]
            if sign < 0:
                with torch.no_grad():
                    for i in live:
                        gn[i].detach().neg_()
            torch.autograd.backward([graph[i] for i in live], [gn[i].detach() for i in live],
                                    inputs=leaves)
        grads = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return grads

    def step(trainable, opt_state, frozen, batch):
        paths_leaves = tree_leaves_with_path(trainable)
        leaves = [p for _, p in paths_leaves]
        metrics = {}
        if method == "grad_proj":
            g_neg = grads_of(neg_loss, trainable, frozen, batch, leaves)
            g_pos = grads_of(pos_loss, trainable, frozen, batch, leaves)
            with torch.no_grad():
                metrics["inner_product"] = _dot(g_neg, g_pos)
                for (path, _), n, p in zip(paths_leaves, g_neg, g_pos):
                    _project_(path, n, p)
            grads = g_neg
            del g_pos
        elif ref_behavior:  # grad_proj_l2, the reference's actual numerics
            grads = grads_of(pos_loss, trainable, frozen, batch, leaves)
        else:  # grad_proj_l2, the intended objective
            grads = l2_grads(trainable, frozen, batch, leaves)
        optimizer.step_(_like(trainable, iter(grads)), opt_state, trainable)
        del grads
        with torch.no_grad():
            metrics["neg_loss"] = neg_loss(trainable, frozen, batch).detach()
            metrics["pos_loss"] = pos_loss(trainable, frozen, batch).detach()
        return trainable, opt_state, metrics

    return step


def _like(tree, flat):
    """A tree of ``tree``'s structure holding the next leaves of ``flat``."""
    if isinstance(tree, dict):
        return {k: _like(v, flat) for k, v in tree.items()}
    return None if tree is None else next(flat)

