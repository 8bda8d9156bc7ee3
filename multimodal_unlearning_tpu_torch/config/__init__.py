"""Configuration of the port: the model configurations (``models.py``),
configuration files with overrides (``loader.py``) and the model registry
(``registry.py``)."""

from multimodal_unlearning_tpu_torch.config.loader import Config, load_config, main, save_config
from multimodal_unlearning_tpu_torch.config.models import (
    LlamaConfig, LlavaConfig, QwenVisionConfig, QwenVLConfig, VitConfig, build_model_config,
    model_kind)
from multimodal_unlearning_tpu_torch.config.registry import (
    PRESETS, config_dir, get_model_identifiers)

__all__ = ["Config", "load_config", "save_config", "main", "PRESETS", "LlamaConfig",
           "LlavaConfig", "QwenVisionConfig", "QwenVLConfig", "VitConfig", "build_model_config", "config_dir",
           "get_model_identifiers", "model_kind"]
