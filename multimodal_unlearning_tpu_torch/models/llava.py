"""LLaVA assembly: ViT tower -> MLP projector -> Llama decoder, in PyTorch.

Counterpart of ``multimodal_unlearning_tpu/models/llava.py``.  The
processor pre-expands ``<image>`` into ``num_image_tokens`` copies of
``image_token_id``; the splice pulls projected patch features into those
positions through a cumsum index, so rows without an image ride through
untouched.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_unlearning_tpu_torch.config import LlavaConfig
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import llama, vit
from multimodal_unlearning_tpu_torch.models.params import ParamTree, trains
from multimodal_unlearning_tpu_torch.utils.pytree import tree_map_with_path
from multimodal_unlearning_tpu_torch.utils.quantize import embed_lookup, is_qtensor

__all__ = ["LlavaConfig", "Llava", "init_params", "project", "splice_image_embeds",
           "reachable_mask"]


def reachable_mask(params: dict, cfg: LlavaConfig) -> dict:
    """Per-leaf factors (True / False, or [L, 1, ..] 1/0 tensors) marking
    the leaves of a dict tree that the loss reaches.  LLaVA reads the vision
    tower's ``hidden_states[vision_feature_layer]``, so the blocks at or
    above it get no gradient, and torch's AdamW, which skips parameters with
    no ``.grad``, never decays them; a functional optimizer sees zero
    gradients and would.  For ``optim.make_optimizer(reachable_mask=...)``."""
    L = cfg.vision.num_layers
    cut = (L + 1 + cfg.vision_feature_layer) if cfg.vision_feature_layer < 0 \
        else cfg.vision_feature_layer

    def leaf_mask(path, leaf):
        keys = [str(k) for k in path]
        if keys[:2] == ["vision_tower", "layers"]:
            used = (torch.arange(L, device=leaf.device) < cut).to(torch.float32)
            return used.reshape((L,) + (1,) * (leaf.ndim - 1))
        if keys[:2] == ["vision_tower", "post_ln"]:
            return False  # CLIP's post_layernorm only feeds the pooled output
        return True

    return tree_map_with_path(leaf_mask, params)


def project(params, feats, lora=None, lora_scale: float = 0.0, lora_ids=None):
    """Two-layer MLP projector with exact (erf) GELU, HF's
    ``projector_hidden_act="gelu"``; ``lora``: ``{"fc1", "fc2"}`` adapters, or
    a bank of them selected per row by ``lora_ids``."""
    def dense(x, name):
        y = x @ getattr(params, name).to(x.dtype) + getattr(params, f"{name}_bias")
        ab = lora.get(name) if lora is not None else None
        return llama.apply_lora_delta(y, x, ab, lora_scale, lora_ids)

    h = dense(feats, "fc1")
    h = F.gelu(h.to(torch.promote_types(h.dtype, torch.float32)),
               approximate="none").to(feats.dtype)
    return dense(h, "fc2")


def splice_image_embeds(token_embeds, image_embeds, image_token_mask):
    """token_embeds [B, S, H]; image_embeds [B, N, H]; image_token_mask
    [B, S] bool with 0 or exactly N True entries per row."""
    idx = torch.cumsum(image_token_mask.to(torch.int64), dim=1) - 1
    idx = idx.clamp(0, image_embeds.shape[1] - 1)
    gathered = torch.gather(
        image_embeds, 1, idx[..., None].expand(-1, -1, image_embeds.shape[-1]))
    return torch.where(image_token_mask[..., None], gathered.to(token_embeds.dtype),
                       token_embeds)


class Llava(nn.Module):
    """language_model (Llama), vision_tower (Vit) and projector parameters
    at the JAX tree's paths."""

    def __init__(self, cfg: LlavaConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        vh, dh = cfg.vision.hidden_size, cfg.decoder.hidden_size
        self.cfg = cfg
        self.language_model = llama.Llama(cfg.decoder, device=dev, dtype=dtype)
        self.vision_tower = vit.Vit(cfg.vision, device=dev, dtype=dtype)
        self.projector = ParamTree({"fc1": (vh, dh), "fc1_bias": (dh,),
                                    "fc2": (dh, dh), "fc2_bias": (dh,)},
                                   device=dev, dtype=dtype)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Llava":
        self.language_model.init_params(generator)
        self.vision_tower.init_params(generator)
        p = self.projector
        p.fc1.normal_(0.0, p.fc1.shape[0] ** -0.5, generator=generator)
        p.fc2.normal_(0.0, p.fc2.shape[0] ** -0.5, generator=generator)
        p.fc1_bias.zero_()
        p.fc2_bias.zero_()
        return self

    def forward(self, input_ids, *, pixel_values=None, attention_mask=None, positions=None,
                kv_cache=None, cache_offset=0, kv_valid_mask=None, lora: dict | None = None,
                lora_scale: float = 0.0, lora_ids=None, capture_layer: int | None = None,
                remat: bool = False, remat_policy: str | None = None,
                attn_impl: str = "auto", compute_dtype=torch.bfloat16, logits_dtype=None,
                last_logit_only: bool = False, chunk_decode: bool = False) -> dict:
        """VLM forward; ``input_ids`` already hold the expanded image tokens.
        ``lora``: ``{"language_model": ..., "projector": ...}`` adapters, or a
        bank of them with ``lora_ids`` [B] (multi-LoRA serving).  The
        vision tower builds a graph only when one of its leaves requires a
        gradient (``LoRA.r=0`` with ``freeze_vision_module=false``); it is
        not rematerialised, as in the JAX package.
        ``chunk_decode`` and ``positions`` pass through to the decoder (text
        passes into the cache: speculative verify, chunked prefill, prefix
        suffixes; see ``llama.Llama.forward``)."""
        cfg = self.cfg
        lm = self.language_model
        et = lm.embed_tokens
        embeds = (embed_lookup(et, input_ids) if is_qtensor(et) else et[input_ids]).to(
            compute_dtype)
        if pixel_values is not None:
            with torch.set_grad_enabled(torch.is_grad_enabled() and trains(self.vision_tower)):
                feats = self.vision_tower(
                    pixel_values, feature_layer=cfg.vision_feature_layer,
                    attn_impl=attn_impl, compute_dtype=compute_dtype)
            if cfg.vision_feature_select == "patch":
                feats = feats[:, 1:, :]
            image_embeds = project(self.projector, feats,
                                   lora=None if lora is None else lora.get("projector"),
                                   lora_scale=lora_scale, lora_ids=lora_ids)
            embeds = splice_image_embeds(embeds, image_embeds,
                                         input_ids == cfg.image_token_id)
        return lm(inputs_embeds=embeds, attention_mask=attention_mask, positions=positions,
                  kv_cache=kv_cache, cache_offset=cache_offset, kv_valid_mask=kv_valid_mask,
                  lora=lora if lora is None else lora.get("language_model"),
                  lora_scale=lora_scale, lora_ids=lora_ids, capture_layer=capture_layer,
                  remat=remat, remat_policy=remat_policy, attn_impl=attn_impl,
                  compute_dtype=compute_dtype, logits_dtype=logits_dtype,
                  last_logit_only=last_logit_only, chunk_decode=chunk_decode)


def init_params(cfg: LlavaConfig, generator: torch.Generator | None = None, *,
                device=None, dtype=torch.float32) -> Llava:
    """A randomly initialised LLaVA on ``device`` (the card by default)."""
    model = Llava(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=model.projector.fc1.device).manual_seed(0)
    return model.init_params(generator)
