"""Model registry: the port's copy of
``multimodal_unlearning_tpu/config/registry.py``.  ``PRESETS`` is
``<repo>/configs/model_config.yaml``, read once, and every model family of
the port is looked up there."""

from __future__ import annotations

from pathlib import Path

from multimodal_unlearning_tpu_torch.config.loader import Config, load_config

_REPO_ROOT = Path(__file__).resolve().parents[2]


def config_dir() -> Path:
    """The experiment configuration root, ``<repo>/configs``."""
    return _REPO_ROOT / "configs"


PRESETS: Config = load_config(config_dir(), "model_config")


def get_model_identifiers(model_family: str) -> Config:
    if model_family not in PRESETS:
        raise KeyError(
            f"Unknown model family {model_family!r}; known: {sorted(dict.keys(PRESETS))}")
    return PRESETS[model_family]
