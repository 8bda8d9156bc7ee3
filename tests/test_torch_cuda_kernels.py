"""Kernels B1 (flash forward) and B4 (flash decode) against their plain
PyTorch versions on the card, in bf16.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not need.)  Tolerances: the kernel rounds the probabilities to
bf16 before the second product and the output to bf16, the plain version
runs in f32 and rounds once, so outputs agree to a few bf16 ulps of |o| <= 1:
2e-2 absolute; lse is f32 on both sides: 1e-3.
"""

import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.ops.attention import flash_attention_lse
from multimodal_unlearning_tpu_torch.ops.decode_attention import decode_attention

pytestmark = pytest.mark.cuda

O_TOL = 2e-2
LSE_TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,D,causal,q_offset,pad",
    [
        (1, 16, 16, 577, 577, 64, False, 0, 0),      # ViT tower
        (1, 32, 32, 768, 768, 128, True, 0, 100),    # decoder prefill, left padding
        (2, 32, 8, 200, 200, 128, True, 0, 37),      # GQA
        (2, 8, 8, 70, 300, 128, True, 230, 0),       # q_offset > 0
        (3, 4, 2, 129, 129, 64, False, 0, 129),      # a fully padded batch row
    ],
    ids=["vit", "prefill", "gqa", "q_offset", "dead_row"],
)
def test_flash_fwd_matches_plain(dev, B, Hq, Hkv, Sq, Sk, D, causal, q_offset, pad):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, (B, h, s, D), dev) for h, s in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
    mask = torch.ones((B, Sk), dtype=torch.int32, device=dev)
    mask[0, :pad] = 0
    before = kernels.LAUNCHES["flash_fwd"]
    o, lse = flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    o_ref, lse_ref = flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_offset,
                                         impl="plain")
    torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=0)
    live = lse_ref > -1e29
    torch.testing.assert_close(lse[live], lse_ref[live], atol=LSE_TOL, rtol=0)
    assert torch.all(lse[~live] == -1e30)
    assert torch.all(o.float()[~live.expand_as(o)] == 0)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_decode_matches_plain(dev, G):
    rng = np.random.default_rng(1)
    L, B, Hkv, Smax, D = 4, 8, 32 // G, 2048, 128
    cache = {n: _randn(rng, (L, B, Hkv, Smax, D), dev) for n in ("k", "v")}
    q = _randn(rng, (B, Hkv * G, 1, D), dev)
    lens = rng.integers(1, Smax, B)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        valid[b, Smax // 8: Smax // 8 + n // 2] = 1   # a ragged middle span ...
        valid[b, :17] = 1                            # ... and a left prefix
    valid[3] = 0                                     # an all-invalid row
    before = kernels.LAUNCHES["flash_decode"]
    o = decode_attention(q, cache, 3, valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode"] == before + 1
    ref = decode_attention(q, cache, 3, valid, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)
    assert torch.all(o[3] == 0)
