"""Helpers over parameter trees.

Counterpart of ``multimodal_unlearning_tpu/utils/pytree.py``.  A tree of the
port is an ``nn.Module`` (the frozen base model) or a nested dict of tensors
at the JAX tree's paths (LoRA adapters, a partitioned dense model, optimizer
moments, gradients).  The dict helpers walk keys in insertion order, so two
trees built the same way flatten to leaves in the same order.  As in JAX, a
``None`` slot is an empty subtree: the helpers skip it and ``tree_map``
leaves it ``None`` (``partition_tree`` puts one where the other side holds
the leaf).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list:
    """[(path tuple, leaf)] of a nested dict; ``None`` slots are skipped."""
    if isinstance(tree, dict):
        out = []
        for key, val in tree.items():
            out.extend(tree_leaves_with_path(val, prefix + (key,)))
        return out
    return [] if tree is None else [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over nested dicts of one structure;
    ``None`` slots of ``tree`` stay ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return None if tree is None else fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, prefix: tuple = ()):
    """``fn(path, leaf, *other_leaves)`` over nested dicts of one structure;
    ``None`` slots of ``tree`` stay ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), prefix=prefix + (k,))
                for k, v in tree.items()}
    return None if tree is None else fn(prefix, tree, *rest)


def tree_get(tree, path: tuple):
    """The subtree or leaf of a nested dict at ``path``."""
    for key in path:
        tree = tree[key]
    return tree


def param_tree(module: nn.Module) -> dict:
    """A module's parameters as a nested dict at the JAX tree's paths, the
    ``nn.Parameter`` objects themselves (no copy, no detach): updating a
    leaf in place updates the module."""
    out = dict(module.named_parameters(recurse=False))
    out.update({n: param_tree(c) for n, c in module.named_children()})
    return out


def path_predicate(*substrings: str) -> Callable[[str], bool]:
    """Predicate matching any '/'-joined path containing one of the substrings."""
    return lambda path: any(s in path for s in substrings)


def partition_tree(tree, predicate: Callable[[str], bool]):
    """Split a nested dict into (matching, rest) by the '/'-joined path of
    each leaf; the other side's slot becomes ``None``."""
    def split(node, prefix):
        if isinstance(node, dict):
            pairs = {k: split(v, prefix + (k,)) for k, v in node.items()}
            return ({k: a for k, (a, _) in pairs.items()},
                    {k: b for k, (_, b) in pairs.items()})
        if node is None:
            return None, None
        return (node, None) if predicate("/".join(map(str, prefix))) else (None, node)

    return split(tree, ())


def merge_trees(a, b):
    """Merge two same-structure trees where exactly one side holds each leaf."""
    if isinstance(a, dict):
        return {k: merge_trees(v, b[k]) for k, v in a.items()}
    return a if a is not None else b


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
