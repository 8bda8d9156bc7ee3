"""The port's safetensors writer (``train/checkpoints._save``): what it
writes, the ``safetensors`` package and the JAX package read back exactly.

The card's routes (card tensors through the pinned buffer, in slices of
it; permuted host views through the card) run only with a CUDA device:

    python -m pytest --noconftest -m cuda tests/test_torch_checkpoint_writer.py -q
"""

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file

from multimodal_unlearning_tpu_torch.train import checkpoints

META = {"format": "pt", "step": "3"}


def _tensors(device="cpu"):
    g = torch.Generator().manual_seed(0)
    stacked = torch.randn(4, 6, 5, generator=g)
    out = {
        "bf16": torch.randn(3, 4, generator=g).to(torch.bfloat16),
        "f16": torch.randn(2, 3, generator=g).to(torch.float16),
        "transposed": stacked[1].T,  # a non-contiguous view
        "layer": stacked[2],  # a view into a stacked tensor
        "scalar": torch.tensor(3.5),
        "empty": torch.empty(0, 4),
        "i8": torch.randint(-5, 5, (7,), dtype=torch.int8, generator=g),
        "u8": torch.arange(5, dtype=torch.uint8),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i64": torch.arange(3),
        "f64": torch.randn(2, generator=g, dtype=torch.float64),
        "bool": torch.tensor([True, False, True]),
    }
    return {k: v.to(device) for k, v in out.items()}


def _check(path, want):
    got = load_file(str(path))
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.cpu()
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    with safe_open(str(path), framework="pt") as f:
        assert f.metadata() == META


@pytest.mark.parametrize("metadata", [META, None], ids=["metadata", "no_metadata"])
def test_written_file_reads_back(tmp_path, metadata):
    want = _tensors()
    checkpoints._save(want, tmp_path / "x.safetensors", metadata=metadata)
    got = load_file(str(tmp_path / "x.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    with safe_open(str(tmp_path / "x.safetensors"), framework="pt") as f:
        assert f.metadata() == metadata
    # the header is padded to 8 bytes, and nothing follows the last tensor
    raw = (tmp_path / "x.safetensors").read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0
    assert len(raw) == 8 + n + sum(v.numel() * v.element_size() for v in want.values())


def test_the_jax_package_reads_an_hf_checkpoint(tmp_path):
    from multimodal_unlearning_tpu.train import checkpoints as jax_ckpt

    g = torch.Generator().manual_seed(1)
    sd = {"model.embed_tokens.weight": torch.randn(11, 8, generator=g),
          "model.layers.0.self_attn.q_proj.weight": torch.randn(8, 8, generator=g).T,
          "lm_head.weight": torch.randn(11, 8, generator=g).to(torch.float16)}
    checkpoints.save_hf_checkpoint(tmp_path, sd, config={"a": 1})
    got = jax_ckpt.load_hf_checkpoint(tmp_path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda", "cpu"], ids=["card_tensors", "host_views_via_card"])
def test_card_tensors_through_the_pinned_buffer(tmp_path, monkeypatch, device):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(checkpoints, "_STAGE_BYTES", 48)  # several slices a tensor
    want = _tensors(device)  # on the host, the transposed view is permuted on the card
    checkpoints._save(want, tmp_path / "x.safetensors", metadata=META)
    _check(tmp_path / "x.safetensors", want)
