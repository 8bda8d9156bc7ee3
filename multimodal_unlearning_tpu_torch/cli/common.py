"""Helpers shared by the port's entry points: the port's copy of
``quantize_base_params`` from ``multimodal_unlearning_tpu/cli/common.py``."""

from __future__ import annotations

from torch import nn

from multimodal_unlearning_tpu_torch.models import VLM_KINDS
from multimodal_unlearning_tpu_torch.utils.quantize import is_qtensor, quantize_tree_inplace


def quantize_base_params(model: nn.Module, kind: str, spec) -> nn.Module:
    """Quantize the decoder weights per the ``quantize_base`` config value:
    true / "int8" -> per-output-channel int8 (W8A16: each layer's weight is
    dequantized as the forward reaches it; W8A8 under
    ``llama.enable_int8_compute``); "int4" or "int4:g<N>" -> grouped int4
    with groups of 128 (or N) contracting rows (W4A16: kernel B8 streams the
    packed bytes; half the int8 weight stream again).  A VLM quantizes only
    its language tower; the vision tower and projector stay float.  A model
    that is already quantized passes through untouched.

    DESTRUCTIVE: quantizes leaf by leaf in place (``quantize_tree_inplace``),
    dropping each float leaf as it goes, so the float and quantized trees
    are never alive together.  Returns ``model``."""
    if any(is_qtensor(m) for m in model.modules()):
        return model  # quantized already
    s = str(spec).strip().lower()
    bits = 4 if s.startswith("int4") else 8
    gs = int(s.split(":g", 1)[1]) if bits == 4 and ":g" in s else 128
    quantize_tree_inplace(model.language_model if kind in VLM_KINDS else model, bits=bits,
                          group_size=gs)
    return model
