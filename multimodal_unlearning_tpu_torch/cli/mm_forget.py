"""MM unlearning entry point of the port: the model apply the train step
differentiates.

Counterpart of ``multimodal_unlearning_tpu/cli/mm_forget.py``;
``make_apply_fn`` only.  The run loop (config, data, checkpoints) is not
ported yet.
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.models import VLM_KINDS


def make_apply_fn(kind, mcfg, *, lora_cfg=None, remat=False, remat_policy=None,
                  attn_impl="auto", compute_dtype=torch.bfloat16, logits_dtype=None):
    """apply_fn(params_or_(params, lora), batch_part, capture_layer) -> outputs.

    ``params`` is the model (``models/llava.Llava`` or ``models/llama.Llama``),
    or the tuple (model, adapters) in LoRA mode, where ``lora_cfg`` is the
    adapters' scale (alpha / r).  ``logits_dtype`` defaults to
    ``compute_dtype``: every loss does its softmax and logsumexp math in f32
    anyway (``train/losses.py:_token_nll``), so an f32 [B, S, V] logits buffer
    would only cost memory and traffic."""
    if logits_dtype is None:
        logits_dtype = compute_dtype
    vlm = kind in VLM_KINDS
    if not vlm and kind != "llama":
        raise NotImplementedError(f"model kind {kind!r} is not ported yet (llava, llama)")
    del mcfg  # the port's models carry their configuration

    def apply_fn(params, part, capture_layer=None):
        kw = dict(
            attention_mask=torch.as_tensor(part["attention_mask"]),
            capture_layer=capture_layer,
            remat=remat,
            remat_policy=remat_policy,
            attn_impl=attn_impl,
            compute_dtype=compute_dtype,
            logits_dtype=logits_dtype,
        )
        if isinstance(params, tuple):  # (base, adapters) LoRA mode
            base, adapters = params
            kw.update(lora=adapters, lora_scale=lora_cfg)
        else:
            base = params
        if vlm:
            kw["pixel_values"] = torch.as_tensor(part["pixel_values"])
        out = base(torch.as_tensor(part["input_ids"]), **kw)
        return {"logits": out["logits"], "captured": out["captured"]}

    return apply_fn
