"""The unlearning train step.

Counterpart of ``multimodal_unlearning_tpu/train/trainer.py``:

  train_step(state, frozen, teacher_params, batch) -> (state, metrics)

- the loss type is fixed when the step is built;
- gradient accumulation loops over the leading micro-batch axis (HF
  semantics: mean of per-micro means), summing the gradients in f32 in
  place;
- the trainable tree (a nested dict of leaf tensors with
  ``requires_grad=True``) is the only thing differentiated: LoRA adapters
  (the frozen base flows through ``frozen`` and ``combine``), or a dense
  model's own parameters (full-parameter forgetting; ``frozen`` holds the
  frozen vision tower at its paths, and the step applies the merged tree,
  ``merge_trees``);
- a LoRA step is functional like the JAX one: it returns a new
  ``TrainState`` and leaves the old one as it was.  A dense step
  (``combine`` not given) updates the parameters and the optimizer state
  in place (``Optimizer.step_``): at 7B each tree-sized temporary would be
  12.6 GiB.  Both decide first whether the loss and the gradient norm are
  finite; if not, nothing is written;
- L1/L0 regularization (``l_regularization``) adds its value to the loss
  and its gradient to the gradients, per micro-batch, as in the JAX
  package; the RMU control vector and the initial model for ``l_norm_from:
  init`` live in the ``TrainState``;
- metrics stay tensors on the device; the step never waits for the host.

``shard_train_state`` waits for multi-GPU.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from multimodal_unlearning_tpu_torch.train import losses as L
from multimodal_unlearning_tpu_torch.train.optim import apply_updates, global_norm
from multimodal_unlearning_tpu_torch.utils.pytree import (
    merge_trees, tree_get, tree_leaves, tree_leaves_with_path, tree_map)


@dataclass(frozen=True)
class TrainState:
    step: torch.Tensor
    trainable: Any
    opt_state: Any
    control_vec: Any = None
    init_trainable: Any = None  # for l_norm_from == "init"


def create_train_state(trainable, optimizer, *, control_vec=None, keep_init: bool = False):
    device = tree_leaves(trainable)[0].device
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        trainable=trainable,
        opt_state=optimizer.init(trainable),
        control_vec=control_vec,
        init_trainable=tree_map(lambda p: p.detach().clone(), trainable) if keep_init else None,
    )


def _unstack(batch, i):
    return tree_map(lambda x: x[i], batch)


def make_train_step(apply_fn: Callable, optimizer, *, loss_type: str, beta: float = 1.0,
                    l1_lambda: float = 0.0, l0_lambda: float = 0.0, l_norm_from: str = "zero",
                    loss_args: dict | None = None, dpo_fix: bool = False, grad_accum: int = 1,
                    combine=None, skip_nonfinite: bool = True):
    """Build the step.

    apply_fn(params, batch_part, capture_layer=None) -> {"logits", "captured"}
    where ``params`` is ``combine(trainable, frozen)`` (LoRA: ``combine =
    lambda tr, fr: (fr, tr)``), else ``merge_trees(trainable, frozen)``, or
    the trainable tree itself when ``frozen`` is None.  With ``grad_accum >
    1`` every leaf of ``batch`` carries a leading micro-batch axis of that
    length.  Without ``combine`` the step updates ``state`` in place and
    returns it with its step advanced.

    The returned function has the attribute ``grad_fn(trainable, frozen,
    teacher_params, micro, control_vec=None, init_trainable=None) -> ((loss,
    metrics), grads)``, the loss and the gradient tree of one micro-batch
    without an update.
    """
    inplace = combine is None

    def loss_fn(trainable, frozen, teacher_params, micro, control_vec):
        if combine is not None:
            params = combine(trainable, frozen)
        else:
            params = trainable if frozen is None else merge_trees(trainable, frozen)

        def student(part, **kw):
            return apply_fn(params, part, **kw)

        teacher = None
        if teacher_params is not None:
            def teacher(part, **kw):
                with torch.no_grad():
                    return apply_fn(teacher_params, part, **kw)

        return L.compute_forget_loss(loss_type, micro, student=student, teacher=teacher,
                                     beta=beta, loss_args=loss_args, control_vec=control_vec,
                                     dpo_fix=dpo_fix)

    def grad_fn(trainable, frozen, teacher_params, micro, control_vec=None,
                init_trainable=None):
        leaves = tree_leaves(trainable)
        with torch.enable_grad():
            loss, metrics = loss_fn(trainable, frozen, teacher_params, micro, control_vec)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = iter(torch.zeros_like(p) if g is None else g for g, p in zip(flat, leaves))
        grads = tree_map(lambda _: next(flat), trainable)
        metrics = {k: v.detach() for k, v in metrics.items()}
        loss = loss.detach()
        if l1_lambda or l0_lambda:
            # the regularizer's value joins the loss and its gradient (L1's
            # sign(d), a layer slice at a time) is added to the gradients in
            # place: through autograd, every leaf's regularizer gradient
            # would wait beside the others for the model's backward pass
            init = init_trainable if l_norm_from == "init" else None
            with torch.no_grad():
                loss = loss + L.l_regularization(trainable, init, l1_lambda=l1_lambda,
                                                 l0_lambda=l0_lambda)
                if l1_lambda:
                    inits = (dict(tree_leaves_with_path(init)) if init is not None else {})
                    for path, p in tree_leaves_with_path(trainable):
                        g = tree_get(grads, path)
                        g.add_(L.l1_grad(p.detach(), inits.get(path), l1_lambda))
            metrics["loss"] = loss
        return (loss, metrics), grads

    def accumulated(state, frozen, teacher_params, batch):
        if grad_accum == 1:
            (_, metrics), grads = grad_fn(state.trainable, frozen, teacher_params, batch,
                                          state.control_vec, state.init_trainable)
            return metrics, grads
        g_sum, m_sum = None, None
        for i in range(grad_accum):
            (_, m), g = grad_fn(state.trainable, frozen, teacher_params, _unstack(batch, i),
                                state.control_vec, state.init_trainable)
            if g_sum is None:  # f32 sums, as the JAX package's f32 zeros + g
                g_sum = tree_map(lambda x: x.to(torch.float32, copy=True), g)
                m_sum = m
            else:
                for (_, s), (_, x) in zip(tree_leaves_with_path(g_sum),
                                          tree_leaves_with_path(g)):
                    s.add_(x)
                m_sum = {k: m_sum[k] + v for k, v in m.items()}
            del g
        for x in tree_leaves(g_sum):
            x.div_(grad_accum)
        return {k: v / grad_accum for k, v in m_sum.items()}, g_sum

    def train_step(state: TrainState, frozen, teacher_params, batch):
        metrics, grads = accumulated(state, frozen, teacher_params, batch)
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
            ok = None
            if skip_nonfinite:
                # drop the whole update if the loss or the gradients blew up:
                # parameters AND moments stay as they were
                ok = torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])
                metrics["skipped_nonfinite"] = (~ok).to(torch.int32)
            if inplace:
                optimizer.step_(grads, state.opt_state, state.trainable, ok=ok,
                                grad_norm=metrics["grad_norm"])
                return replace(state, step=state.step + 1), metrics
            updates, new_opt = optimizer.update(grads, state.opt_state, state.trainable)
            new_trainable = apply_updates(state.trainable, updates)
            if ok is not None:
                keep = lambda new, old: torch.where(ok.to(new.device), new, old.to(new.dtype))
                new_trainable = tree_map(keep, new_trainable, state.trainable)
                new_opt = tree_map(keep, new_opt, state.opt_state)
            new_trainable = tree_map(lambda p: p.requires_grad_(), new_trainable)
        return replace(state, step=state.step + 1, trainable=new_trainable,
                       opt_state=new_opt), metrics

    train_step.grad_fn = grad_fn
    return train_step
