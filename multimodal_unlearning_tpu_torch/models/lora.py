"""LoRA adapters over stacked-layer parameter trees.

Counterpart of ``multimodal_unlearning_tpu/models/lora.py``: initialisation,
merging and ``stack_adapters``, the multi-adapter bank of multi-LoRA
serving.  The
adapter tree is a nested dict of tensors at the JAX tree's paths --
``language_model.layers.<proj>.{a,b}`` with ``a: [L, in, r]`` (gaussian times
in^-0.5) and ``b: [L, r, out]`` (zeros), ``projector.{fc1,fc2}.{a,b}`` flat
(LLaVA's ``projector``, or Qwen2-VL's ``vision_tower.merger``) --
and its leaves are the only tensors with ``requires_grad=True``: the base
model stays frozen.  The adapters are applied inside the projections
(``models/llama.py:dense``).

``merge_model`` folds the adapters into the base (a module or a dict tree)
and returns a dense dict tree, dequantizing int8 and int4 leaves.  Adapters
over an int4 base (QLoRA) take the weight's logical ``in``, twice the
packed dimension.  ``out_dtype`` sets
the dtype of every float leaf of the result, dense bases included (the JAX
package honours it only for quantized leaves).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_unlearning_tpu_torch.utils.quantize import (
    dequantize_leaf, is_int4, is_qtensor, qs_of)

# every decoder linear except lm_head
DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)
PROJECTOR_TARGETS = ("fc1", "fc2")


def stack_adapters(trees: list, scales: list) -> dict:
    """Stack same-structure adapter trees into ONE multi-adapter bank for
    per-row serving (``models/llama.py:apply_lora_delta`` with ``lora_ids``;
    apply with ``lora_scale=1.0``: each adapter's own alpha/r scale is
    folded into its ``b`` here, in the adapter's dtype).

    Decoder layer leaves [L, in, r] stack to [L, A, in, r] (axis 1: the
    layer loop still slices L); flat projector leaves [in, r] stack to
    [A, in, r]."""
    def walk(nodes, scales, key=None):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], scales, k) for k in nodes[0]}
        leaves = [(x * s if key == "b" else x).detach() for x, s in zip(nodes, scales)]
        return torch.stack(leaves, dim=1 if leaves[0].ndim == 3 else 0)

    return walk(list(trees), [float(s) for s in scales])


def lora_scale(r: int, alpha: float) -> float:
    return alpha / r if r else 0.0


def _get(node, name):
    return node.get(name) if isinstance(node, dict) else getattr(node, name, None)


def _weight_shape(w):
    """Logical [.., in, out] shape of a dense, int8 or grouped-int4 weight
    (int4: the packed contracting dim holds two rows a byte, as the JAX
    package reads it)."""
    if is_qtensor(w):
        q, _ = qs_of(w)
        *lead, d_in, d_out = q.shape
        return (*lead, 2 * d_in if is_int4(w) else d_in, d_out)
    return tuple(w.shape)


def _pair(lead, d_in, d_out, r, generator, dtype, device):
    a = torch.randn((*lead, d_in, r), generator=generator, device=device,
                    dtype=torch.float32) * d_in ** -0.5
    b = torch.zeros((*lead, r, d_out), device=device, dtype=dtype)
    return {"a": a.to(dtype).requires_grad_(), "b": b.requires_grad_()}


def _device_of(w):
    return (qs_of(w)[0] if is_qtensor(w) else w).device


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


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------


def _items(node) -> list:
    """(name, child) of a module's own parameters and submodules, or of a
    dict."""
    if isinstance(node, nn.Module):
        return list(node.named_parameters(recurse=False)) + list(node.named_children())
    return list(node.items())


class _Merge:
    """One merge: where results go (the host under ``consume``), and what a
    consumed source leaves behind (nothing: it is dropped from its module)."""

    def __init__(self, scale: float, consume: bool, out_dtype, dq_dtype):
        self.scale, self.consume = float(scale), consume
        self.out_dtype, self.dq_dtype = out_dtype, dq_dtype

    def finish(self, owner, name, out):
        if self.consume:
            out = out.to("cpu")
            if isinstance(owner, nn.Module):
                delattr(owner, name)
        return out

    def walk(self, owner, name, node):
        """A leaf or subtree with no adapter: int8/int4 leaves dequantized to
        the merge dtype, float leaves cast to ``out_dtype`` when given."""
        if is_qtensor(node):
            return self.finish(owner, name, dequantize_leaf(node, self.dq_dtype))
        if isinstance(node, (dict, nn.Module)):
            return {k: self.walk(node, k, v) for k, v in _items(node)}
        out = node.detach()
        if self.out_dtype is not None and out.is_floating_point():
            out = out.to(self.out_dtype)
        return self.finish(owner, name, out)

    @torch.no_grad()
    def fold(self, w, a, b):
        """One merged [L, in, out] leaf, one layer at a time (the f32 delta
        stays one layer): dequantize to the merge dtype first, then promote,
        fold and cast, in the JAX package's order."""
        quantized = is_qtensor(w)
        acc = torch.promote_types(a.dtype, torch.float32)
        odt = self.dq_dtype if quantized else (self.out_dtype or w.dtype)
        L, d_in, d_out = _weight_shape(w)
        dev = "cpu" if self.consume else a.device
        out = torch.empty((L, d_in, d_out), dtype=odt, device=dev)
        for i in range(L):
            wl = dequantize_leaf(w[i], self.dq_dtype) if quantized else w[i]
            delta = a[i].detach().to(acc) @ b[i].detach().to(acc)
            out[i].copy_((wl.to(acc) + self.scale * delta).to(odt))
        return out

    def layers(self, sub, lora_layers):
        merged = {}
        for name, w in _items(sub):
            ab = lora_layers.get(name)
            if ab is None:
                merged[name] = self.walk(sub, name, w)
            else:
                merged[name] = self.fold(w, ab["a"], ab["b"])
                if self.consume and isinstance(sub, nn.Module):
                    delattr(sub, name)
        return merged

    @torch.no_grad()
    def flat(self, flat_params, lora: dict) -> dict:
        """Flat (2-D) adapters folded into their dense weights; the other
        leaves as ``walk`` gives them."""
        out = {}
        for name, w in _items(flat_params):
            ab = lora.get(name)
            if ab is None:
                out[name] = self.walk(flat_params, name, w)
                continue
            acc = torch.promote_types(ab["a"].dtype, torch.float32)
            delta = ab["a"].detach().to(acc) @ ab["b"].detach().to(acc)
            folded = (w.detach().to(acc) + self.scale * delta).to(self.out_dtype or w.dtype)
            out[name] = self.finish(flat_params, name, folded)
        return out


def _merger(lora: dict, scale, consume, out_dtype) -> _Merge:
    # the quantized leaves dequantize to out_dtype, else to the adapters'
    # dtype (an f32 LoRA merges to an f32 checkpoint)
    lead = next(iter(lora.get("layers", {}).values()), None)
    dq_dtype = out_dtype or (lead["b"].dtype if lead is not None else torch.bfloat16)
    return _Merge(scale, consume, out_dtype, dq_dtype)


def merge_flat(flat_params, lora: dict, scale: float, out_dtype=None) -> dict:
    """Fold flat (2-D) adapters into their dense weights."""
    return _Merge(scale, False, out_dtype, out_dtype).flat(flat_params, lora)


def merge(params, lora: dict, scale: float, consume: bool = False, out_dtype=None) -> dict:
    """merge_and_unload: a decoder (module or dict) with its layer adapters
    folded in, as a dense dict tree.  int8/int4 leaves are dequantized.

    ``consume=True`` merges one leaf at a time, moves each result to the
    host and drops its source from the module before the next, so the card
    holds the dense tree at no point; the module is unusable afterwards (the
    end-of-run merge before ``save_model``).  Values equal the default
    path's."""
    m = _merger(lora, scale, consume, out_dtype)
    lora_layers = lora.get("layers", {})
    out = {}
    for key, sub in _items(params):
        out[key] = (m.layers(sub, lora_layers) if key == "layers"
                    else m.walk(params, key, sub))
    return out


def merge_model(params, adapters: dict, scale: float, consume: bool = False,
                out_dtype=None) -> dict:
    """Model-level merge_and_unload: decoder layers and projector adapters
    (at LLaVA's ``projector`` or inside Qwen2-VL's ``vision_tower.merger``)."""
    if "language_model" not in adapters:
        return merge(params, adapters, scale, consume=consume, out_dtype=out_dtype)
    m = _merger(adapters["language_model"], scale, consume, out_dtype)
    proj = adapters.get("projector")
    site = _projector_site(params) if proj else None
    out = {}
    for key, sub in _items(params):
        if key == "language_model":
            out[key] = merge(sub, adapters["language_model"], scale, consume=consume,
                             out_dtype=out_dtype)
        elif site == (key,):
            out[key] = m.flat(sub, proj)
        elif site is not None and site[0] == key:
            out[key] = {k: m.flat(v, proj) if k == site[1] else m.walk(sub, k, v)
                        for k, v in _items(sub)}
        else:
            out[key] = m.walk(params, key, sub)
    return out
