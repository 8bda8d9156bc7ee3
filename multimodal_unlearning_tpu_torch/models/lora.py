"""LoRA adapters over stacked-layer parameter trees.

Counterpart of ``multimodal_unlearning_tpu/models/lora.py`` (initialisation
only; ``merge``, ``merge_model`` and ``stack_adapters`` are not ported yet).
The adapter tree is a nested dict of tensors at the JAX tree's paths --
``language_model.layers.<proj>.{a,b}`` with ``a: [L, in, r]`` (gaussian times
in^-0.5) and ``b: [L, r, out]`` (zeros), ``projector.{fc1,fc2}.{a,b}`` flat --
and its leaves are the only tensors with ``requires_grad=True``: the base
model stays frozen.  The adapters are applied inside the projections
(``models/llama.py:dense``).
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.utils.quantize import QTensor, is_int4, is_qtensor

# every decoder linear except lm_head
DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)
PROJECTOR_TARGETS = ("fc1", "fc2")


def lora_scale(r: int, alpha: float) -> float:
    return alpha / r if r else 0.0


def _get(node, name):
    return node.get(name) if isinstance(node, dict) else getattr(node, name, None)


def _weight_shape(w):
    """Logical [.., in, out] shape of a dense or int8-quantized weight."""
    if is_int4(w):
        raise NotImplementedError("LoRA over grouped int4 bases is not ported yet (int4 "
                                  "training is a later slice)")
    if isinstance(w, QTensor):
        return tuple(w.q.shape)
    if is_qtensor(w):
        return tuple(w["q"].shape)
    return tuple(w.shape)


def _pair(lead, d_in, d_out, r, generator, dtype, device):
    a = torch.randn((*lead, d_in, r), generator=generator, device=device,
                    dtype=torch.float32) * d_in ** -0.5
    b = torch.zeros((*lead, r, d_out), device=device, dtype=dtype)
    return {"a": a.to(dtype).requires_grad_(), "b": b.requires_grad_()}


def _device_of(w):
    return (w.q if isinstance(w, QTensor) else w["q"] if isinstance(w, dict) else w).device


def init_lora(layer_params, r: int, generator: torch.Generator, targets=DEFAULT_TARGETS,
              dtype=torch.float32) -> dict:
    """Adapters for the stacked ``layers`` subtree of a decoder (a module or
    a dict).  ``generator`` must live on the weights' device."""
    adapters = {}
    for name in targets:
        w = _get(layer_params, name)
        if w is None:
            continue
        shape = _weight_shape(w)
        if len(shape) != 3:
            continue  # expert stacks [L, E, in, out] are not LoRA targets
        L, d_in, d_out = shape
        adapters[name] = _pair((L,), d_in, d_out, r, generator, dtype, _device_of(w))
    return {"layers": adapters}


def init_flat_lora(flat_params, r: int, generator: torch.Generator,
                   targets=PROJECTOR_TARGETS, dtype=torch.float32) -> dict:
    """Adapters for unstacked 2-D linears (the VLM projector MLP)."""
    adapters = {}
    for name in targets:
        w = _get(flat_params, name)
        d_in, d_out = _weight_shape(w)
        adapters[name] = _pair((), d_in, d_out, r, generator, dtype, _device_of(w))
    return adapters


def _projector_site(params):
    """Path of the projector subtree: LLaVA keeps it at ``projector``."""
    if _get(params, "projector") is not None:
        return ("projector",)
    vt = _get(params, "vision_tower")
    if vt is not None and _get(vt, "merger") is not None:
        return ("vision_tower", "merger")
    return None


def init_model_lora(params, r: int, generator: torch.Generator, *, projector: bool = True,
                    dtype=torch.float32) -> dict:
    """Full-model adapter tree (every linear except lm_head).

    A decoder gets the stacked layer adapters; a VLM (with a
    ``language_model`` subtree) additionally gets projector adapters under the
    ``projector`` key unless ``projector=False``."""
    lm = _get(params, "language_model")
    if lm is None:
        return init_lora(_get(params, "layers"), r, generator, dtype=dtype)
    adapters = {"language_model": init_lora(_get(lm, "layers"), r, generator, dtype=dtype)}
    site = _projector_site(params) if projector else None
    if site is not None:
        node = params
        for k in site:
            node = _get(node, k)
        adapters["projector"] = init_flat_lora(node, r, generator, dtype=dtype)
    return adapters
