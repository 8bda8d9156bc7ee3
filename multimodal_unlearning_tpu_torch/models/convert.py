"""Carry weights from the JAX package's parameter trees into the port.

The input is the nested dict that ``multimodal_unlearning_tpu``'s
``llama.init_params`` / ``vit.init_params`` / ``llava.init_params`` /
``qwen2_vl.init_params`` (either tower version) return,
with numpy arrays as leaves (``jax.tree.map(np.asarray, params)``):
``[in, out]`` weight layouts, layers stacked on a leading L dimension.
The port's modules keep exactly that layout, so conversion puts the leaves
one by one into a model built without storage, and checks that every
parameter is covered and every shape agrees.

A quantized tree (``utils/quantize.py``: ``{"q": int8, "s": f32}`` or grouped
int4 ``{"q4": int8, "s": f32}`` leaves) crosses with its int8 storage: the
leaf becomes a ``QTensor`` / ``QTensor4`` at the same path, its int8 array
stored ``in_contiguous`` as the port's quantizer stores it.  A LoRA adapter
tree crosses as a nested dict of trainable tensors (``adapters_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.config import (
    LlamaConfig, LlavaConfig, QwenVisionConfig, QwenVLConfig, VitConfig)
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import llama, llava, qwen2_vl, vit
from multimodal_unlearning_tpu_torch.utils.quantize import (
    QTensor, QTensor4, in_contiguous, is_qtensor)


def _as_tensor(val, dtype=None):
    """A leaf as a tensor: a tensor passes as it is (``copy_`` casts it), an
    array-like (numpy, JAX) is copied into ``dtype`` (numpy views may be
    read-only)."""
    if isinstance(val, torch.Tensor):
        return val
    arr = np.array(val)
    return torch.from_numpy(arr if dtype is None else arr.astype(
        torch.empty((), dtype=dtype).numpy().dtype))


@torch.no_grad()
def load_tree(module: torch.nn.Module, tree: dict, *, device, dtype) -> None:
    """Put the leaves of ``tree`` into the same-named parameters of
    ``module``, a model built on the meta device (shapes, no storage): a
    float leaf becomes the parameter, on ``device`` in ``dtype`` (a tensor
    already there is taken as it is, so a loaded checkpoint is never copied
    again), a quantized leaf a ``QTensor`` / ``QTensor4``.  Every parameter
    must be covered, with its own shape."""
    seen = set()

    def walk(node, sub, prefix):
        for key, val in sub.items():
            path = prefix + key
            if is_qtensor(val):
                _load_quantized(node, key, val, path, device)
                seen.update(f"{path}.{k}" for k in val)
                continue
            if isinstance(val, dict):
                walk(getattr(node, key), val, path + ".")
                continue
            target = getattr(node, key, None)
            if not isinstance(target, torch.nn.Parameter):
                raise KeyError(f"{path}: the port's model has no such parameter")
            arr = _as_tensor(val, torch.float32)
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{path}: shape {tuple(arr.shape)} != {tuple(target.shape)}")
            setattr(node, key, torch.nn.Parameter(
                arr.to(device=device, dtype=dtype).contiguous(), requires_grad=False))
            seen.add(path)

    walk(module, tree, "")
    missing = {n for n, _ in module.named_parameters()} - seen
    if missing:
        raise KeyError(f"parameters missing from the JAX tree: {sorted(missing)}")


def _load_quantized(node, key, leaf, path, device):
    """Replace the parameter ``node.<key>`` by a ``QTensor`` holding the
    leaf's int8 values and f32 scales, or by a ``QTensor4`` holding a
    grouped-int4 leaf's packed bytes [.., in/2, out] and group scales."""
    target = getattr(node, key, None)
    if not isinstance(target, (torch.nn.Parameter, QTensor, QTensor4)):
        raise KeyError(f"{path}: the port's model has no such parameter")
    int4 = "q4" in leaf
    q = _as_tensor(leaf["q4"] if int4 else leaf["q"])
    s = _as_tensor(leaf["s"], torch.float32)
    shape = tuple(target.shape)
    if int4 and isinstance(target, torch.nn.Parameter):
        shape = shape[:-2] + (shape[-2] // 2, shape[-1])  # the packed [.., in/2, out]
    if q.dtype != torch.int8 or tuple(q.shape) != shape:
        raise ValueError(f"{path}: quantized leaf {q.dtype}{tuple(q.shape)} != int8{shape}")
    delattr(node, key)
    cls = QTensor4 if int4 else QTensor
    setattr(node, key, cls(in_contiguous(q.to(device)), s.to(device)))


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
    """The port's model for ``cfg`` (LlamaConfig, VitConfig, LlavaConfig,
    QwenVLConfig or QwenVisionConfig)
    holding the weights of the parameter tree ``tree``: a JAX tree as numpy
    arrays, or a tree of tensors at the same paths (a loaded checkpoint,
    whose tensors on ``device`` in ``dtype`` become the parameters as they
    are).  The model is built without storage and takes its leaves one by
    one, so only the tree's own copy of the weights is ever on the device."""
    device = resolve_device(device)
    if isinstance(cfg, LlavaConfig):
        model = llava.Llava(cfg, device="meta", dtype=dtype)
    elif isinstance(cfg, LlamaConfig):
        model = llama.Llama(cfg, device="meta", dtype=dtype)
    elif isinstance(cfg, VitConfig):
        model = vit.Vit(cfg, device="meta", dtype=dtype)
    elif isinstance(cfg, QwenVLConfig):
        model = qwen2_vl.QwenVL(cfg, device="meta", dtype=dtype)
    elif isinstance(cfg, QwenVisionConfig):
        model = qwen2_vl.QwenVisionTower(cfg, device="meta", dtype=dtype)
    else:
        raise NotImplementedError(f"no converter for {type(cfg).__name__}")
    load_tree(model, tree, device=device, dtype=dtype)
    for m in model.modules():
        if isinstance(m, llama.Llama):
            m.make_rope_tables(device)
    return model
