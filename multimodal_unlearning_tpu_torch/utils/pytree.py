"""Helpers over parameter trees.

Counterpart of ``multimodal_unlearning_tpu/utils/pytree.py``.  A tree of the
port is an ``nn.Module`` (the frozen base model) or a nested dict of tensors
at the JAX tree's paths (LoRA adapters, optimizer moments, gradients).  The
dict helpers walk keys in insertion order, so two trees built the same way
flatten to leaves in the same order.
"""

from __future__ import annotations

import torch
from torch import nn


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list:
    """[(path tuple, leaf)] of a nested dict; ``None`` leaves are kept."""
    if isinstance(tree, dict):
        out = []
        for key, val in tree.items():
            out.extend(tree_leaves_with_path(val, prefix + (key,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, prefix: tuple = ()):
    """``fn(path, leaf, *other_leaves)`` over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), prefix=prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def count_params(tree) -> int:
    """Number of elements in a module's parameters or a dict tree's tensors
    (a quantized leaf counts its int8 values and its scales, as the JAX
    package's ``count_params`` counts both arrays of a QTensor)."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    return sum(x.numel() for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def print_trainable_parameters(trainable, frozen) -> str:
    t, f = count_params(trainable), count_params(frozen)
    total = t + f
    msg = (
        f"trainable params: {t} || all params: {total} || "
        f"trainable%: {100 * t / max(total, 1)}"
    )
    print(msg)
    return msg
