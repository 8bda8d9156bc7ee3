from multimodal_unlearning_tpu_torch.config import LlamaConfig, LlavaConfig
from multimodal_unlearning_tpu_torch.models import llama, llava, vit

__all__ = ["llama", "llava", "vit", "VLM_KINDS", "vlm_module", "decoder_module"]

VLM_KINDS = ("llava",)


def vlm_module(kind_or_cfg):
    """VLM assembly module for a registry ``arch.kind`` or a built config;
    the port has LLaVA only."""
    if isinstance(kind_or_cfg, LlavaConfig) or kind_or_cfg == "llava":
        return llava
    raise NotImplementedError(f"VLM {kind_or_cfg!r} is not ported yet (llava only)")


def decoder_module(cfg_or_name):
    """Decoder module for a registry ``arch.decoder`` name or a built
    config; the port has the llama family only."""
    if isinstance(cfg_or_name, LlamaConfig) or cfg_or_name == "llama":
        return llama
    raise NotImplementedError(f"decoder {cfg_or_name!r} is not ported yet (llama only)")
