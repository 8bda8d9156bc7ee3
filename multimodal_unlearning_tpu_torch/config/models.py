"""Model configurations, built from a registry entry
(``config/registry.py``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_registry(cls, arch) -> "LlamaConfig":
        return cls(
            vocab_size=int(arch["vocab_size"]),
            hidden_size=int(arch["hidden_size"]),
            intermediate_size=int(arch["intermediate_size"]),
            num_layers=int(arch["num_layers"]),
            num_heads=int(arch["num_heads"]),
            num_kv_heads=int(arch["num_kv_heads"]),
            rope_theta=float(arch.get("rope_theta", 10000.0)),
            max_position_embeddings=int(arch.get("max_position_embeddings", 4096)),
            rms_norm_eps=float(arch.get("rms_norm_eps", 1e-5)),
        )


@dataclass(frozen=True)
class VitConfig:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    patch_size: int
    image_size: int
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # CLS

    @classmethod
    def from_registry(cls, arch) -> "VitConfig":
        return cls(
            hidden_size=int(arch["hidden_size"]),
            intermediate_size=int(arch["intermediate_size"]),
            num_layers=int(arch["num_layers"]),
            num_heads=int(arch["num_heads"]),
            patch_size=int(arch["patch_size"]),
            image_size=int(arch["image_size"]),
            layer_norm_eps=float(arch.get("layer_norm_eps", 1e-5)),
        )


@dataclass(frozen=True)
class LlavaConfig:
    decoder: LlamaConfig
    vision: VitConfig
    image_token_id: int
    vision_feature_layer: int = -2
    vision_feature_select: str = "patch"  # drop CLS

    @property
    def num_image_tokens(self) -> int:
        n = self.vision.num_patches
        return n if self.vision_feature_select == "patch" else n + 1

    @classmethod
    def from_registry(cls, arch) -> "LlavaConfig":
        return cls(
            decoder=LlamaConfig.from_registry(arch["decoder"]),
            vision=VitConfig.from_registry(arch["vision"]),
            image_token_id=int(arch["image_token_id"]),
            vision_feature_layer=int(arch.get("vision_feature_layer", -2)),
            vision_feature_select=str(arch.get("vision_feature_select", "patch")),
        )


def model_kind(model_cfg) -> str:
    arch = model_cfg["arch"]
    return str(arch.get("kind") or "llama")


def build_model_config(model_cfg):
    """LlavaConfig or LlamaConfig for a preset entry."""
    arch = model_cfg["arch"]
    kind = model_kind(model_cfg)
    if kind == "llava":
        return LlavaConfig.from_registry(arch)
    if kind == "llama" and str(arch.get("decoder", "llama")) == "llama":
        return LlamaConfig.from_registry(arch)
    raise NotImplementedError(
        f"model kind {kind!r} (decoder {arch.get('decoder')!r}) is not ported yet")
