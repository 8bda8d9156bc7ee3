"""PyTorch and CUDA port of ``multimodal_unlearning_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference.  This package imports
``torch`` and never ``jax``, and nothing of the JAX package.  Its layout
mirrors the JAX package's (``ops/``, ``utils/``, ``models/``, ``train/``,
``data/``, ``serve/``, ``cli/``) so that every module has an obvious
counterpart.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CUDA tensor every attention call goes through a hand-written kernel
(``ops/csrc``), on a CPU tensor through its plain PyTorch version.
"""

from multimodal_unlearning_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
