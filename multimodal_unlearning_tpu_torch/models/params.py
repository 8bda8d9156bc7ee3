"""Parameter trees laid out like the JAX package's parameter dicts.

A model of the port is an ``nn.Module`` whose parameters sit at the same
paths, with the same shapes and the same ``[in, out]`` layouts, as the
nested dict the JAX package's ``init_params`` returns (layer weights
stacked on a leading L dimension).  That keeps each function of the port
next to its counterpart and makes carrying weights across a walk over one
tree (``models/convert.py``).  Serving needs no gradients, so the
parameters are created with ``requires_grad=False``.
"""

from __future__ import annotations

import torch
from torch import nn


class ParamTree(nn.Module):
    """Nested parameters from a spec ``{name: shape or {sub-spec}}``,
    allocated uninitialised on ``device`` in ``dtype``."""

    def __init__(self, spec: dict, *, device, dtype):
        super().__init__()
        for name, shape in spec.items():
            if isinstance(shape, dict):
                setattr(self, name, ParamTree(shape, device=device, dtype=dtype))
            else:
                setattr(self, name, nn.Parameter(
                    torch.empty(shape, device=device, dtype=dtype), requires_grad=False))


def trains(module: nn.Module, skip: str | None = None) -> bool:
    """Whether any parameter of ``module`` (but those under ``skip``)
    requires a gradient: a vision tower that none of its leaves trains
    runs without building a graph."""
    return any(p.requires_grad for n, p in module.named_parameters()
               if skip is None or not n.startswith(skip))


def check_tree_of(module: nn.Module, tree: dict) -> nn.Module:
    """``module``, after checking that every leaf of ``tree`` (a nested dict
    at its parameter paths, ``None`` slots skipped) is one of its own
    parameters: a dense trainable tree is the model's parameters
    themselves, never a second copy, so applying the tree is applying the
    module."""
    for key, val in tree.items():
        if isinstance(val, dict):
            check_tree_of(getattr(module, key), val)
        elif val is not None and module._parameters.get(key) is not val:
            raise ValueError(f"{key}: the tree's leaf is not the model's own parameter")
    return module
