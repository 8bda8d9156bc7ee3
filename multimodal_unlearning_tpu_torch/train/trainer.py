"""The unlearning train step.

Counterpart of ``multimodal_unlearning_tpu/train/trainer.py``:

  train_step(state, frozen, teacher_params, batch) -> (state, metrics)

- the loss type is fixed when the step is built;
- gradient accumulation loops over the leading micro-batch axis (HF
  semantics: mean of per-micro means);
- the trainable tree (LoRA adapters: a nested dict of leaf tensors with
  ``requires_grad=True``) is the only thing differentiated; the frozen base
  flows through the ``frozen`` argument and ``combine``;
- the step is functional like the JAX one: it returns a new ``TrainState``
  and leaves the old one as it was (the trainable tree is small, so nothing
  is updated in place);
- metrics stay tensors on the device; the step never waits for the host.

L1/L0 regularization is not ported yet (``l_regularization``), and
``shard_train_state`` waits for multi-GPU.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from multimodal_unlearning_tpu_torch.train import losses as L
from multimodal_unlearning_tpu_torch.train.optim import apply_updates, global_norm
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves, tree_map


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
                    l1_lambda: float = 0.0, l0_lambda: float = 0.0, grad_accum: int = 1,
                    combine=None, skip_nonfinite: bool = True):
    """Build the step.

    apply_fn(params, batch_part, capture_layer=None) -> {"logits", "captured"}
    where ``params`` is ``combine(trainable, frozen)`` (LoRA: ``combine =
    lambda tr, fr: (fr, tr)``), or the trainable tree itself when ``frozen``
    is None.  With ``grad_accum > 1`` every leaf of ``batch`` carries a
    leading micro-batch axis of that length.

    The returned function has the attribute ``grad_fn(trainable, frozen,
    teacher_params, micro) -> ((loss, metrics), grads)``, the loss and the
    gradient tree of one micro-batch without an update.
    """
    if l1_lambda or l0_lambda:
        raise NotImplementedError(
            "l1_lambda / l0_lambda need l_regularization, which is not ported yet")

    def loss_fn(trainable, frozen, teacher_params, micro):
        if combine is not None:
            params = combine(trainable, frozen)
        elif frozen is None:
            params = trainable
        else:
            raise NotImplementedError(
                "merging a partitioned dense tree is not ported: pass combine=")

        def student(part, **kw):
            return apply_fn(params, part, **kw)

        teacher = None
        if teacher_params is not None:
            def teacher(part, **kw):
                with torch.no_grad():
                    return apply_fn(teacher_params, part, **kw)

        return L.compute_forget_loss(loss_type, micro, student=student, teacher=teacher,
                                     beta=beta)

    def grad_fn(trainable, frozen, teacher_params, micro):
        leaves = tree_leaves(trainable)
        with torch.enable_grad():
            loss, metrics = loss_fn(trainable, frozen, teacher_params, micro)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = iter(torch.zeros_like(p) if g is None else g for g, p in zip(flat, leaves))
        grads = tree_map(lambda _: next(flat), trainable)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads

    def train_step(state: TrainState, frozen, teacher_params, batch):
        if grad_accum == 1:
            (_, metrics), grads = grad_fn(state.trainable, frozen, teacher_params, batch)
        else:
            g_sum, m_sum = None, None
            for i in range(grad_accum):
                (_, m), g = grad_fn(state.trainable, frozen, teacher_params,
                                    _unstack(batch, i))
                g32 = tree_map(lambda x: x.to(torch.float32), g)
                g_sum = g32 if g_sum is None else tree_map(torch.add, g_sum, g32)
                m_sum = m if m_sum is None else {k: m_sum[k] + v for k, v in m.items()}
            grads = tree_map(lambda x: x / grad_accum, g_sum)
            metrics = {k: v / grad_accum for k, v in m_sum.items()}

        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, state.opt_state, state.trainable)
            new_trainable = apply_updates(state.trainable, updates)
            metrics["grad_norm"] = global_norm(grads)
            if skip_nonfinite:
                # drop the whole update if the loss or the gradients blew up:
                # parameters AND moments stay as they were
                ok = torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])
                keep = lambda new, old: torch.where(ok.to(new.device), new, old.to(new.dtype))
                new_trainable = tree_map(keep, new_trainable, state.trainable)
                new_opt = tree_map(keep, new_opt, state.opt_state)
                metrics["skipped_nonfinite"] = (~ok).to(torch.int32)
            new_trainable = tree_map(lambda p: p.requires_grad_(), new_trainable)
        return replace(state, step=state.step + 1, trainable=new_trainable,
                       opt_state=new_opt), metrics

    train_step.grad_fn = grad_fn
    return train_step
