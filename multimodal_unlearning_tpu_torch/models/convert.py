"""Carry weights from the JAX package's parameter trees into the port.

The input is the nested dict that ``multimodal_unlearning_tpu``'s
``llama.init_params`` / ``vit.init_params`` / ``llava.init_params`` return,
with numpy arrays as leaves (``jax.tree.map(np.asarray, params)``):
``[in, out]`` weight layouts, layers stacked on a leading L dimension.
The port's modules keep exactly that layout, so conversion copies leaf by
leaf and checks that every parameter is covered and every shape agrees.

A quantized tree (``utils/quantize.py``: ``{"q": int8, "s": f32}`` or grouped
int4 ``{"q4": int8, "s": f32}`` leaves) crosses with its int8 storage: the
leaf becomes a ``QTensor`` / ``QTensor4`` at the same path, its int8 array
stored ``in_contiguous`` as the port's quantizer stores it.  A LoRA adapter
tree crosses as a nested dict of trainable tensors (``adapters_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.config import LlamaConfig, LlavaConfig, VitConfig
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import llama, llava, vit
from multimodal_unlearning_tpu_torch.utils.quantize import (
    QTensor, QTensor4, in_contiguous, is_qtensor)


@torch.no_grad()
def load_tree(module: torch.nn.Module, tree: dict) -> None:
    """Copy the leaves of ``tree`` into the same-named parameters of
    ``module``; every parameter must be covered, with its own shape."""
    seen = set()

    def walk(node, sub, prefix):
        for key, val in sub.items():
            path = prefix + key
            if is_qtensor(val):
                _load_quantized(node, key, val, path)
                seen.update(f"{path}.{k}" for k in val)
                continue
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


def _load_quantized(node, key, leaf, path):
    """Replace the float parameter ``node.<key>`` by a ``QTensor`` holding
    the leaf's int8 values and f32 scales, or by a ``QTensor4`` holding a
    grouped-int4 leaf's packed bytes [.., in/2, out] and group scales."""
    target = getattr(node, key, None)
    if not isinstance(target, (torch.nn.Parameter, QTensor, QTensor4)):
        raise KeyError(f"{path}: the port's model has no such parameter")
    int4 = "q4" in leaf
    q = np.array(leaf["q4"] if int4 else leaf["q"])
    s = np.array(leaf["s"], dtype=np.float32)
    shape = tuple(target.shape)
    if int4 and isinstance(target, torch.nn.Parameter):
        shape = shape[:-2] + (shape[-2] // 2, shape[-1])  # the packed [.., in/2, out]
    if q.dtype != np.int8 or tuple(q.shape) != shape:
        raise ValueError(f"{path}: quantized leaf {q.dtype}{q.shape} != int8{shape}")
    device = (target if isinstance(target, torch.nn.Parameter) else target.s).device
    delattr(node, key)
    cls = QTensor4 if int4 else QTensor
    setattr(node, key, cls(in_contiguous(torch.from_numpy(q).to(device)),
                           torch.from_numpy(s).to(device)))


def adapters_from_jax(tree: dict, *, device=None, dtype=torch.float32) -> dict:
    """A LoRA adapter tree of the JAX package (numpy leaves) as the port's
    nested dict of trainable tensors at the same paths, on the card unless
    the caller names another device (as ``from_jax`` places the model)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: adapters_from_jax(v, device=device, dtype=dtype) for k, v in tree.items()}
    arr = np.array(tree, dtype=np.float32)  # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype).requires_grad_()


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
