"""CLEAR's inference-side unlearning methods on the port: SalUn's saliency
masks (``salun.py``) and ECO's embedding-corruption attack (``eco/``)."""

from multimodal_unlearning_tpu_torch.methods import eco, salun

__all__ = ["eco", "salun"]
