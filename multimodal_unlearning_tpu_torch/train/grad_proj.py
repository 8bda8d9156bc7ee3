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
  g_pos + H_neg v - H_pos v with v = 2 gamma (g_neg - g_pos): g_neg and
  g_pos from two first-order passes (on the attention kernels where
  ``apply_fn`` runs them), v written over g_neg, and the two
  Hessian-vector products taken a layer at a time (``_hvp_``) and added
  into g_pos: beside the parameters the step holds two tree-sized buffers
  and one layer's second-order graph.  Two whole ``create_graph`` graphs,
  whose f32 attention scores and cotangents at Llama-2-7B and 500 tokens
  are more than a card of 80 GB has beside the trees, are never built.
  ``ref_behavior`` steps on g_pos alone, the reference's actual numerics.

Losses are the per-sequence token mean of the CE, then the batch mean; the
negative loss is its negation.  The optimizer is SGD; the step updates the
trainable tree in place (``Optimizer.step_``).
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.models import llama
from multimodal_unlearning_tpu_torch.train.losses import shift
from multimodal_unlearning_tpu_torch.utils.pytree import param_tree, tree_leaves_with_path

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


def _hvp_(model, part, sign, tangent, out, dtype) -> None:
    """``out += H t``, H the Hessian of ``sign`` x the per-sequence mean CE
    of ``model`` (a ``models/llama.Llama``) on ``part`` in the parameters,
    ``t`` = ``tangent``; both trees of the model's parameters at its paths.
    A layer at a time: ``torch.func.jvp`` carries each layer's input and its
    tangent up the stack (only those are kept); then, from the head down,
    each layer is recomputed from its input and differentiated twice: with
    c the cotangent of its output and c' that cotangent's tangent, the
    gradient of <dL/dx, x'> + <dL/dw, t_w> + <y, c'> in (x, w) is the
    tangent of the cotangent below it and the layer's share of ``H t``
    (reverse over reverse within the layer: SiLU's backward has no
    forward-mode derivative).  One layer's second-order graph at a time.
    The layers run the plain attention; ``dtype`` is the compute and logits
    type, as ``make_apply_fn`` gives them."""
    from torch.func import jvp

    ids, labels = part["input_ids"], part["labels"]
    pos = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
    cos_p, sin_p = model.rope_cos[pos], model.rope_sin[pos]
    mask = part["attention_mask"]
    eps = model.cfg.rms_norm_eps
    stacked = {n: getattr(model.layers, n).detach() for n in tangent["layers"]}

    def layer_fn(i):
        return lambda x, w: model.layer_forward(x, i, w, cos_p, sin_p, mask, "plain")

    def head(x, norm, lm_head):
        logits = llama.dense(llama.rms_norm(x, norm, eps), lm_head).to(dtype)
        return sign * per_seq_mean_ce(logits, labels)

    def second_order(fn, primals, tangents, cot=None, cot_t=None):
        """(the gradient of fn's output, dotted with ``cot``, in the
        primals; its tangent along ``tangents`` and ``cot_t``)."""
        xs = [x.detach().requires_grad_() for x in primals]
        with torch.enable_grad():
            y = fn(*xs)
            gs = torch.autograd.grad(y, xs, cot, create_graph=True)
            dot = sum((g * t).sum() for g, t in zip(gs, tangents))
            if cot_t is not None:
                dot = dot + (y * cot_t).sum()
            ts = torch.autograd.grad(dot, xs)
        return [g.detach() for g in gs], ts

    with torch.no_grad():
        h = model.embed_tokens.detach()[ids].to(dtype)
        ht = tangent["embed_tokens"][ids].to(dtype)
        ins = []
        for i in range(model.cfg.num_layers):
            ins.append((h, ht))
            w = {n: x[i] for n, x in stacked.items()}
            h, ht = jvp(layer_fn(i), (h, w), (ht, {n: x[i] for n, x in tangent["layers"].items()}))
        (g, _, _), (gt, hn, hl) = second_order(
            head, (h, model.norm, model.lm_head), (ht, tangent["norm"], tangent["lm_head"]))
        out["norm"] += hn
        out["lm_head"] += hl
        names = list(stacked)
        for i in reversed(range(model.cfg.num_layers)):
            x, xt = ins.pop()
            (g, *_), (gt, *hw) = second_order(
                lambda x, *w: layer_fn(i)(x, dict(zip(names, w))),
                (x, *(stacked[n][i] for n in names)),
                (xt, *(tangent["layers"][n][i] for n in names)), g, gt)
            for n, t in zip(names, hw):
                out["layers"][n][i] += t
        emb = out["embed_tokens"]
        emb.index_add_(0, ids.reshape(-1), gt.reshape(-1, gt.shape[-1]).to(emb.dtype))


def make_grad_proj_step(apply_fn, optimizer, *, method: str = "grad_proj", gamma: float = 1.0,
                        ref_behavior: bool = False, model=None, compute_dtype=None):
    """step(trainable, opt_state, frozen, batch) -> (trainable, opt_state, metrics).

    ``batch``: {"forget": {...}, "retain": {...}}, each with input_ids,
    labels and attention_mask tensors on the device.  ``trainable`` (a dict
    tree of tensors with ``requires_grad``) and ``opt_state`` are updated
    in place and returned.  ``frozen``: LoRA's base (``apply_fn`` gets
    ``(frozen, trainable)``), or None.  The metrics are 0-d tensors on the
    device: ``neg_loss`` and ``pos_loss`` after the update, and for
    ``grad_proj`` the global inner product of the two gradients.

    ``model``: for ``grad_proj_l2``'s intended objective, the
    ``models/llama.Llama`` whose whole parameter tree ``trainable`` is, with
    ``compute_dtype`` the type ``apply_fn`` computes in (``_hvp_`` runs its
    layers)."""
    if method not in PROJECTION_METHODS:
        raise ValueError(f"method must be one of {PROJECTION_METHODS}")
    if method == "grad_proj_l2" and not ref_behavior and not isinstance(model, llama.Llama):
        raise ValueError("grad_proj_l2 takes its Hessian-vector products through the layers of "
                         "the llama decoder it trains: pass it as model=")

    def loss(trainable, frozen, part, sign):
        out = apply_fn((frozen, trainable) if frozen is not None else trainable, part)
        return sign * per_seq_mean_ce(out["logits"], part["labels"])

    def neg_loss(trainable, frozen, batch):
        return loss(trainable, frozen, batch["forget"], -1.0)

    def pos_loss(trainable, frozen, batch):
        return loss(trainable, frozen, batch["retain"], 1.0)

    def grads_of(fn, trainable, frozen, batch, leaves):
        with torch.enable_grad():
            value = fn(trainable, frozen, batch)
            g = torch.autograd.grad(value, leaves, allow_unused=True)
        return [torch.zeros_like(p) if x is None else x for x, p in zip(g, leaves)]

    def l2_grads(trainable, frozen, batch, paths_leaves):
        if frozen is not None or {p for p, _ in paths_leaves} != {
                p for p, _ in tree_leaves_with_path(param_tree(model))}:
            raise ValueError("grad_proj_l2 trains the model's whole tree")
        leaves = [p for _, p in paths_leaves]
        gn = grads_of(neg_loss, trainable, frozen, batch, leaves)
        gp = grads_of(pos_loss, trainable, frozen, batch, leaves)
        with torch.no_grad():
            # v = 2 gamma (g_neg - g_pos) in f32, in each gradient's dtype (the
            # cotangent of the f32 difference), a layer at a time, written over
            # g_neg's values, which nothing reads again
            for a, b in zip(gn, gp):
                for x, y in _slices(a, b):
                    x.copy_((2.0 * gamma * (x.float() - y.float())).to(x.dtype))
        v, acc = _like(trainable, iter(gn)), _like(trainable, iter(gp))
        # H_neg v (neg_loss is -CE on the forget rows) and -H_pos v (H of -CE
        # on the retain rows), both into g_pos
        for part in ("forget", "retain"):
            _hvp_(model, batch[part], -1.0, v, acc, compute_dtype)
        return gp

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
            grads = l2_grads(trainable, frozen, batch, paths_leaves)
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

