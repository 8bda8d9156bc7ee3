"""Carry weights from the JAX package's parameter trees into the port.

The input is the nested dict that ``multimodal_unlearning_tpu``'s
``llama.init_params`` / ``vit.init_params`` / ``llava.init_params`` return,
with numpy arrays as leaves (``jax.tree.map(np.asarray, params)``):
``[in, out]`` weight layouts, layers stacked on a leading L dimension.
The port's modules keep exactly that layout, so conversion copies leaf by
leaf and checks that every parameter is covered and every shape agrees.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.config import LlamaConfig, LlavaConfig, VitConfig
from multimodal_unlearning_tpu_torch.models import llama, llava, vit


@torch.no_grad()
def load_tree(module: torch.nn.Module, tree: dict) -> None:
    """Copy the leaves of ``tree`` into the same-named parameters of
    ``module``; every parameter must be covered, with its own shape."""
    seen = set()

    def walk(node, sub, prefix):
        for key, val in sub.items():
            path = prefix + key
            if isinstance(val, dict):
                walk(getattr(node, key), val, path + ".")
                continue
            target = getattr(node, key, None)
            if not isinstance(target, torch.nn.Parameter):
                raise KeyError(f"{path}: the port's model has no such parameter")
            arr = np.array(val, dtype=np.float32)  # a writable copy
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{path}: shape {arr.shape} != {tuple(target.shape)}")
            target.copy_(torch.from_numpy(arr))
            seen.add(path)

    walk(module, tree, "")
    missing = {n for n, _ in module.named_parameters()} - seen
    if missing:
        raise KeyError(f"parameters missing from the JAX tree: {sorted(missing)}")


def from_jax(tree: dict, cfg, *, device=None, dtype=torch.float32):
    """The port's model for ``cfg`` (LlamaConfig, VitConfig or LlavaConfig)
    holding the weights of the JAX parameter tree ``tree``."""
    if isinstance(cfg, LlavaConfig):
        model = llava.Llava(cfg, device=device, dtype=dtype)
    elif isinstance(cfg, LlamaConfig):
        model = llama.Llama(cfg, device=device, dtype=dtype)
    elif isinstance(cfg, VitConfig):
        model = vit.Vit(cfg, device=device, dtype=dtype)
    else:
        raise NotImplementedError(f"no converter for {type(cfg).__name__}")
    load_tree(model, tree)
    return model
