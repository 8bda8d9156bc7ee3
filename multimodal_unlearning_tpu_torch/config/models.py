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
    qkv_bias: bool = False  # the Qwen2 family: q/k/v projections carry biases
    mrope_section: tuple = ()  # Qwen2-VL's M-RoPE channel split (t, h, w)

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
            qkv_bias=bool(arch.get("qkv_bias", False)),
            mrope_section=tuple(int(x) for x in arch.get("mrope_section", ())),
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


@dataclass(frozen=True)
class QwenVisionConfig:
    """Qwen2-VL's NaViT tower (``version`` "2": LayerNorm, quick-GELU MLP,
    full attention) or Qwen2.5-VL's (``version`` "2.5": RMSNorm, a biased
    SwiGLU MLP, attention within windows of ``window_size`` pixels except at
    ``fullatt_block_indexes``), at a fixed ``image_size``."""
    embed_dim: int
    depth: int
    num_heads: int
    out_hidden_size: int
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    image_size: int = 336
    version: str = "2"
    intermediate_size: int | None = None  # the 2.5 SwiGLU width (2 uses mlp_ratio)
    window_size: int = 0  # 2.5 window attention, in pixels (0: full attention)
    fullatt_block_indexes: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2

    @property
    def mlp_hidden(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def merge_dim(self) -> int:
        return self.embed_dim * self.spatial_merge_size ** 2

    @classmethod
    def from_registry(cls, arch) -> "QwenVisionConfig":
        inter = arch.get("intermediate_size")
        return cls(
            embed_dim=int(arch["embed_dim"]),
            depth=int(arch["depth"]),
            num_heads=int(arch["num_heads"]),
            out_hidden_size=int(arch["out_hidden_size"]),
            patch_size=int(arch.get("patch_size", 14)),
            temporal_patch_size=int(arch.get("temporal_patch_size", 2)),
            spatial_merge_size=int(arch.get("spatial_merge_size", 2)),
            mlp_ratio=float(arch.get("mlp_ratio", 4.0)),
            layer_norm_eps=float(arch.get("layer_norm_eps", 1e-6)),
            image_size=int(arch.get("image_size", 336)),
            version=str(arch.get("version", "2")),
            intermediate_size=None if inter is None else int(inter),
            window_size=int(arch.get("window_size", 0)),
            fullatt_block_indexes=tuple(int(i) for i in arch.get("fullatt_block_indexes", ())),
        )


@dataclass(frozen=True)
class QwenVLConfig:
    decoder: LlamaConfig
    vision: QwenVisionConfig
    image_token_id: int
    vision_start_token_id: int
    vision_end_token_id: int

    @property
    def num_image_tokens(self) -> int:
        """Merged image tokens at the fixed resolution."""
        g = self.vision.image_size // self.vision.patch_size
        return g * g // self.vision.spatial_merge_size ** 2

    @property
    def default_grid(self) -> tuple:
        g = self.vision.image_size // self.vision.patch_size
        return (1, g, g)

    @classmethod
    def from_registry(cls, arch) -> "QwenVLConfig":
        return cls(
            decoder=LlamaConfig.from_registry(arch["decoder"]),
            vision=QwenVisionConfig.from_registry(arch["vision"]),
            image_token_id=int(arch["image_token_id"]),
            vision_start_token_id=int(arch["vision_start_token_id"]),
            vision_end_token_id=int(arch["vision_end_token_id"]),
        )


def model_kind(model_cfg) -> str:
    arch = model_cfg["arch"]
    return str(arch.get("kind") or "llama")


def build_model_config(model_cfg):
    """LlavaConfig, QwenVLConfig or LlamaConfig for a preset entry."""
    arch = model_cfg["arch"]
    kind = model_kind(model_cfg)
    if kind == "llava":
        return LlavaConfig.from_registry(arch)
    if kind == "qwen2_vl":
        return QwenVLConfig.from_registry(arch)
    if kind == "llama" and str(arch.get("decoder", "llama")) == "llama":
        return LlamaConfig.from_registry(arch)
    raise NotImplementedError(
        f"model kind {kind!r} (decoder {arch.get('decoder')!r}) is not ported yet")
