from multimodal_unlearning_tpu_torch.config import LlamaConfig, LlavaConfig, QwenVLConfig
from multimodal_unlearning_tpu_torch.models import llama, llava, qwen2_vl, vit

__all__ = ["llama", "llava", "qwen2_vl", "vit", "VLM_KINDS", "vlm_module", "decoder_module"]

VLM_KINDS = ("llava", "qwen2_vl")


def vlm_module(kind_or_cfg):
    """VLM assembly module for a registry ``arch.kind`` or a built config."""
    if isinstance(kind_or_cfg, QwenVLConfig) or kind_or_cfg == "qwen2_vl":
        return qwen2_vl
    if isinstance(kind_or_cfg, LlavaConfig) or kind_or_cfg == "llava":
        return llava
    raise NotImplementedError(f"VLM {kind_or_cfg!r} is not ported yet (llava, qwen2_vl)")


def decoder_module(cfg_or_name):
    """Decoder module for a registry ``arch.decoder`` name or a built
    config; the port has the llama family only (Qwen2 included)."""
    if isinstance(cfg_or_name, LlamaConfig) or cfg_or_name == "llama":
        return llama
    raise NotImplementedError(f"decoder {cfg_or_name!r} is not ported yet (llama only)")
