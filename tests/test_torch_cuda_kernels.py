"""Kernels B1, B2 and B3 (flash forward and backward: dq, dk/dv; head dims
64, 80 and 128), B4/B4q
(flash decode, bf16 and int8 cache), B5/B5q (verify-chunk attention, bf16
and int8 cache), B6/B6q, B7/B7q (the same two on a paged cache) and B8
(grouped-int4 W4A16 matmul) against their plain PyTorch versions on the
card, in bf16.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not need.)  Tolerances: the kernel rounds the probabilities to
bf16 before the second product and the output to bf16, the plain version
runs in f32 and rounds once, so outputs agree to a few bf16 ulps of |o| <= 1:
2e-2 absolute; lse is f32 on both sides: 1e-3.  The backward kernels and
their plain version start from the same saved o and lse and round p and ds to
bf16 at the same place; what differs is the f32 summation order and the final
bf16 rounding of sums over up to 768 queries or keys, so gradients agree to
1% of the largest gradient entry plus one bf16 ulp of the entry.  On an
int8 cache the kernels keep the scales outside the products while the plain
version dequantizes the slab to bf16 first: the same 2e-2.  The paged
kernels share the dense kernels' bodies and arithmetic order, so on the same
logical columns they must equal the dense kernels bit for bit.  B8 and its
plain version form the same exact products of bf16 activations and int4
values; they differ in the f32 summation order and the final bf16 rounding
of each output, one bf16 ulp being 2^-8 of it: max |err| <= 1e-2 of the
largest plain output.  B8 folds its split-K partials in the launch (the last
block of a tile sums them in split order), and the one-token decode kernel
merges its column runs the same way: two calls give the same bits.

The f32 instances of B1 and of the one-token decode kernel (ECO's attacked
model) compute in f32 by FMA and are held against the plain version in f32
(TF32 off, as PyTorch's default for matrix products): what differs is the
summation order and the online softmax's rescaling, a few f32 ulps of sums
over up to 2,000 terms: 5e-5 absolute on o (|o| <= ~4), 1e-5 on lse.
"""

import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.ops.attention import (
    flash_attention, flash_attention_bwd, flash_attention_lse)
from multimodal_unlearning_tpu_torch.ops.decode_attention import (
    chunk_decode_attention, decode_attention)
from multimodal_unlearning_tpu_torch.ops.paged_attention import (
    paged_chunk_decode_attention, paged_decode_attention)
from multimodal_unlearning_tpu_torch.models.llama import quantize_kv
from multimodal_unlearning_tpu_torch.ops.int4_matmul import (
    grouped_int4_matmul, int4_matmul_reference)
from multimodal_unlearning_tpu_torch.utils import quantize as tq

pytestmark = pytest.mark.cuda

O_TOL = 2e-2
LSE_TOL = 1e-3
F32_TOL = 5e-5
F32_LSE_TOL = 1e-5


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
        (2, 4, 4, 37, 93, 128, False, 0, 5),         # Sq, Sk multiples of neither 16 nor 64
        (1, 8, 8, 100, 100, 64, True, 0, 3),         # the same, causal, D 64
        (1, 4, 2, 40, 200, 128, True, 130, 0),       # the causal range ends inside a tile
        (2, 4, 4, 129, 129, 128, True, 0, 129),      # dead rows at D 128
        (1, 8, 8, 150, 150, 128, True, 0, 0),        # an odd count of paired causal row blocks
        (2, 16, 16, 576, 576, 80, False, 0, 0),      # Qwen2-VL's tower: D 80, no padding
        (2, 16, 16, 200, 200, 80, False, 0, 37),     # D 80, masked
        (1, 8, 8, 150, 150, 80, True, 0, 3),         # D 80, causal
        (2, 4, 2, 37, 93, 80, True, 50, 5),          # D 80, GQA, q_offset, ragged lengths
    ],
    ids=["vit", "prefill", "gqa", "q_offset", "dead_row", "ragged", "ragged_causal_d64",
         "causal_mid_tile", "dead_row_d128", "causal_odd_blocks", "qwen_tower_d80",
         "masked_d80", "causal_d80", "gqa_ragged_d80"],
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


def test_flash_fwd_d80_ragged_windows(dev):
    """Qwen2.5-VL's windowed blocks at D 80: the windows folded into the
    batch, each row its own right padding (ragged windows), one launch."""
    rng = np.random.default_rng(7)
    W, H, Lw, D = 9 * 2, 16, 64, 80
    q, k, v = (_randn(rng, (W, H, Lw, D), dev) for _ in range(3))
    lens = rng.integers(1, Lw + 1, W)
    lens[0] = Lw
    mask = (torch.arange(Lw)[None, :] < torch.from_numpy(lens)[:, None]).to(dev, torch.int32)
    before = kernels.LAUNCHES["flash_fwd"]
    o = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    ref = flash_attention(q, k, v, mask, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)


def test_flash_bwd_refuses_other_head_dims(dev):
    """The backward kernels are built at D 64, 80 and 128: another head dim
    raises instead of falling back."""
    rng = np.random.default_rng(8)
    q, k, v, do = (_randn(rng, (1, 4, 64, 96), dev) for _ in range(4))
    o, lse = q.clone(), torch.zeros((1, 4, 64, 1), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="head dim 64, 80 or 128"):
        flash_attention_bwd(q, k, v, None, do, o, lse)


@pytest.mark.parametrize("G", [1, 2, 4, 6])
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


def _cache(rng, shape, dev, int8):
    k, v = _randn(rng, shape, dev), _randn(rng, shape, dev)
    if not int8:
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return {"k": kq, "v": vq, "k_s": ks, "v_s": vs}


@pytest.mark.parametrize("Smax", [2048, 1000])
@pytest.mark.parametrize("G", [1, 4, 6])
def test_flash_decode_q8_matches_plain(dev, G, Smax):
    rng = np.random.default_rng(4)
    L, B, Hkv, D = 4, 8, 32 // G, 128
    cache = _cache(rng, (L, B, Hkv, Smax, D), dev, True)
    q = _randn(rng, (B, Hkv * G, 1, D), dev)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    for b, n in enumerate(rng.integers(1, Smax, B)):
        valid[b, Smax - n:] = 1
    valid[5] = 0
    before = kernels.LAUNCHES["flash_decode_q8"]
    o = decode_attention(q, cache, 2, valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode_q8"] == before + 1
    ref = decode_attention(q, cache, 2, valid, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)
    assert torch.all(o[5] == 0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize(
    "B,Hq,Hkv,C,Smax,slab",
    [
        (8, 32, 32, 5, 2048, 0),     # the verify round, K = 4
        (1, 32, 32, 512, 2048, 1536),  # a chunked-prefill pass over a slab view
        (4, 32, 8, 5, 2048, 0),      # GQA
        (3, 8, 8, 70, 1000, 0),      # C not a multiple of the tile, Smax of neither 64 nor 128
        (4, 32, 32, 1, 2048, 0),     # C 1: one live row per tile, split columns
        (2, 8, 8, 16, 1000, 0),      # G*C 16: one m16 row tile
        (2, 8, 8, 17, 1000, 0),      # G*C 17: two row tiles
        (2, 8, 2, 10, 2048, 0),      # GQA, G*C 40: past two row tiles, one 64-row block
        (2, 8, 2, 17, 1000, 0),      # GQA, G*C 68: past 64 rows, two blocks
        (8, 32, 32, 5, 128, 0),      # Smax of two tiles: one split
        (8, 12, 2, 5, 2048, 0),      # Qwen2-VL-2B's group 6: the verify round, G*C 30
        (1, 12, 2, 512, 2048, 1536),  # group 6, a chunked-prefill pass over a slab view
    ],
    ids=["verify", "prefill_chunk", "gqa", "ragged", "c1", "c16", "c17", "gqa_m40", "gqa_m68",
         "one_split", "gqa6_verify", "gqa6_prefill_chunk"],
)
def test_chunk_decode_matches_plain(dev, int8, B, Hq, Hkv, C, Smax, slab):
    rng = np.random.default_rng(5)
    L, D, layer = 3, 128, 1
    cache = _cache(rng, (L, B, Hkv, Smax, D), dev, int8)
    if slab:  # the first `slab` columns, as a strided view
        cache = {n: t[..., :slab, :] if n in ("k", "v") else t[..., :slab]
                 for n, t in cache.items()}
        Smax = slab
    q = _randn(rng, (B, Hq, C, D), dev)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    for b in range(B):
        off = int(rng.integers(C, Smax - C)) if b else Smax - C  # row 0: offset near Smax
        valid[b, int(rng.integers(0, off)):off] = 1   # left padding, then the prefix
        offset[b] = off
    # stale columns past each chunk hold values but stay invalid
    before = dict(kernels.LAUNCHES)
    o = chunk_decode_attention(q, cache, layer, valid, offset)
    torch.cuda.synchronize()
    name = "chunk_decode_q8" if int8 else "chunk_decode"
    assert kernels.LAUNCHES[name] == before[name] + 1
    ref = chunk_decode_attention(q, cache, layer, valid, offset, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,D,causal,q_offset,pad",
    [
        (2, 32, 32, 768, 768, 128, True, 0, 0),      # the forget step's shape
        (1, 32, 32, 768, 768, 128, True, 0, 100),    # left padding
        (2, 32, 8, 200, 200, 128, True, 0, 37),      # GQA
        (2, 8, 8, 70, 300, 128, True, 230, 0),       # q_offset > 0, Sk > Sq
        (1, 16, 16, 577, 577, 64, False, 0, 0),      # ViT shape, not causal
        (3, 4, 2, 129, 129, 64, True, 0, 129),       # a fully padded batch row: dead rows
        (1, 8, 8, 320, 320, 128, True, 0, 0),        # 5 row and key blocks: a middle pair
        (2, 8, 8, 129, 129, 128, True, 0, 0),        # lengths past a multiple of the tiles
        (2, 4, 4, 70, 300, 64, True, 230, 3),        # the same at D 64, with padding
        (2, 16, 4, 333, 333, 64, True, 0, 61),       # GQA group 4, odd blocks, left padding
        (2, 8, 8, 300, 300, 128, True, 0, 128),      # key blocks 0 and 1 all padding
        (2, 12, 2, 300, 300, 128, True, 0, 37),      # Qwen2-VL-2B's group 6, left padding
        (2, 16, 16, 576, 576, 80, False, 0, 0),      # Qwen2-VL-2B's tower at D 80
        (18, 16, 16, 64, 64, 80, False, 0, 9),       # Qwen2.5-VL's windows, a padded one
        (2, 8, 4, 200, 200, 80, True, 0, 37),        # D 80 causal, GQA, left padding
        (3, 4, 2, 129, 129, 80, True, 0, 129),       # D 80, a fully padded row: dead rows
        (2, 4, 4, 70, 300, 80, True, 230, 3),        # D 80, q_offset > 0, Sk > Sq
    ],
    ids=["step", "left_pad", "gqa", "q_offset", "vit", "dead_row", "odd_blocks", "len_129",
         "ragged_d64", "gqa4_pad", "pad_block", "gqa6", "qwen_tower_d80", "windows_d80",
         "gqa_causal_d80", "dead_row_d80", "q_offset_d80"],
)
def test_flash_bwd_matches_plain(dev, B, Hq, Hkv, Sq, Sk, D, causal, q_offset, pad):
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (B, h, s, D), dev) for h, s in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
    # do arrives from a transpose in the model: [B, S, H, D] storage
    do = _randn(rng, (B, Sq, Hq, D), dev).transpose(1, 2)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=dev)
    mask[0, :pad] = 0
    o, lse = flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_offset)
    before = dict(kernels.LAUNCHES)
    got = flash_attention_bwd(q, k, v, mask, do, o, lse, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert kernels.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = flash_attention_bwd(q, k, v, mask, do, o, lse, causal=causal, q_offset=q_offset,
                               impl="plain")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g.float()).all(), name
        atol = 1e-2 * w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=2 ** -7, msg=lambda m: f"{name}: {m}")
    dead = (lse <= -1e29).expand_as(got[0])
    assert torch.all(got[0].float()[dead] == 0)
    # a key the mask refuses gets exactly 0
    for g in got[1:]:
        assert torch.all(g[0, :, :pad] == 0)


def test_flash_bwd_deterministic(dev):
    """B2 and B3 add nothing atomically: two calls give the same bits."""
    rng = np.random.default_rng(4)
    B, Hq, Hkv, S, D = 2, 32, 8, 512, 128
    q = _randn(rng, (B, Hq, S, D), dev)
    k, v = (_randn(rng, (B, Hkv, S, D), dev) for _ in range(2))
    do = _randn(rng, (B, S, Hq, D), dev).transpose(1, 2)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    mask[1, :37] = 0
    o, lse = flash_attention_lse(q, k, v, mask, causal=True)
    first = flash_attention_bwd(q, k, v, mask, do, o, lse, causal=True)
    second = flash_attention_bwd(q, k, v, mask, do, o, lse, causal=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_attention_autograd_runs_the_kernels(dev):
    """``flash_attention`` on CUDA tensors: backward() launches B2 and B3 and
    agrees with autograd through the plain forward."""
    rng = np.random.default_rng(3)
    B, H, S, D = 2, 8, 300, 128
    q, k, v = (_randn(rng, (B, H, S, D), dev).requires_grad_() for _ in range(3))
    g = _randn(rng, (B, H, S, D), dev)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    mask[1, :50] = 0
    before = dict(kernels.LAUNCHES)
    got = torch.autograd.grad(flash_attention(q, k, v, mask, causal=True), (q, k, v), g)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    want = torch.autograd.grad(flash_attention(q, k, v, mask, causal=True, impl="plain"),
                               (q, k, v), g)
    for gg, w in zip(got, want):
        atol = 2e-2 * w.float().abs().max().item()
        torch.testing.assert_close(gg.float(), w.float(), atol=atol, rtol=2 ** -6)


def _paged(cache, P, rng):
    """The dense [L,B,Hkv,S,D] cache chopped into a pool of pages assigned
    by a random permutation (page 0 left unused, as the engine keeps it)."""
    L, B, H, S, D = cache["k"].shape
    MP = S // P
    dev = cache["k"].device
    table = torch.from_numpy((1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)).to(dev)
    pool = {"table": table}
    for n, t in cache.items():
        if n in ("k", "v"):
            pool[n] = torch.zeros((L, H, B * MP + 1, P, D), dtype=t.dtype, device=dev)
            pool[n][:, :, table.long()] = t.reshape(L, B, H, MP, P, D).transpose(1, 2)
        else:
            pool[n] = torch.zeros((L, H, B * MP + 1, 1, P), dtype=t.dtype, device=dev)
            pool[n][:, :, table.long()] = t.reshape(L, B, H, 1, MP, P).permute(0, 2, 1, 4, 3, 5)
    return pool


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("P", [16, 128])
@pytest.mark.parametrize("G", [1, 4, 6])
def test_paged_decode_matches_plain(dev, int8, P, G):
    rng = np.random.default_rng(6)
    L, B, Hkv, S, D, layer = 4, 8, 32 // G, 2048, 128, 3
    dense = _cache(rng, (L, B, Hkv, S, D), dev, int8)
    pool = _paged(dense, P, rng)
    q = _randn(rng, (B, Hkv * G, 1, D), dev)
    valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, n in enumerate(rng.integers(1, S - 256, B)):
        valid[b, :100] = 1                 # a prefix ending inside a page ...
        valid[b, 256: 256 + n] = 1         # ... and, after an all-invalid gap page, the rest
    valid[6] = 0                           # an idle row
    name = "paged_decode_q8" if int8 else "paged_decode"
    before = kernels.LAUNCHES[name]
    o = paged_decode_attention(q, pool, layer, valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    ref = paged_decode_attention(q, pool, layer, valid, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)
    assert torch.all(o[6] == 0)
    assert torch.equal(o, decode_attention(q, dense, layer, valid))  # B4/B4q, bit for bit


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("P", [16, 128])
@pytest.mark.parametrize(
    "B,Hq,Hkv,C,case",
    [
        (8, 32, 32, 5, "verify"),          # K = 4, chunks straddling page boundaries
        (4, 32, 8, 5, "gqa"),
        (1, 32, 32, 512, "prefill_chunk"),  # 512 queries behind 1,024 prefix columns
        (2, 8, 8, 3, "fresh_page"),        # the chunk starts a page past every valid one
        (4, 32, 32, 1, "verify_c1"),       # one query per row, split columns
        (8, 12, 2, 5, "gqa6"),             # Qwen2-VL-2B's group 6
    ],
    ids=["verify", "gqa", "prefill_chunk", "fresh_page", "verify_c1", "gqa6"],
)
def test_paged_chunk_matches_plain(dev, int8, P, B, Hq, Hkv, C, case):
    rng = np.random.default_rng(7)
    L, S, D, layer = 3, 2048, 128, 1
    dense = _cache(rng, (L, B, Hkv, S, D), dev, int8)
    pool = _paged(dense, P, rng)
    q = _randn(rng, (B, Hq, C, D), dev)
    valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    for b in range(B):
        if case == "prefill_chunk":
            off, start = 1024, 0
        elif case == "fresh_page":
            off, start = 4 * 128, 3
        else:  # a chunk straddling a page boundary: it starts 2 columns before one
            off, start = (int(rng.integers(2, 15)) * 128 - 2), int(rng.integers(0, 100))
        valid[b, start:off] = 1
        offset[b] = off
    name = "paged_chunk_q8" if int8 else "paged_chunk"
    before = kernels.LAUNCHES[name]
    o = paged_chunk_decode_attention(q, pool, layer, valid, offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    ref = paged_chunk_decode_attention(q, pool, layer, valid, offset, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)
    assert torch.equal(o, chunk_decode_attention(q, dense, layer, valid, offset))  # B5/B5q


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_chunk_decode_split_edges(dev, int8):
    """The split regime's edges: a row whose prefix ends in the first split
    (every later split sees no column), a row that sees nothing at all
    (offset at Smax, nothing valid: 0), a row whose chunk sits in the last
    split behind a gap; the split plan has many splits here."""
    from multimodal_unlearning_tpu_torch.ops.decode_attention import chunk_split_plan, sm_count
    rng = np.random.default_rng(8)
    L, B, Hkv, G, C, Smax, D, layer = 2, 3, 4, 2, 5, 2048, 128, 1
    assert chunk_split_plan(B, Hkv, G * C, Smax, sm_count(dev))[0] > 4
    cache = _cache(rng, (L, B, Hkv, Smax, D), dev, int8)
    q = _randn(rng, (B, Hkv * G, C, D), dev)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    valid[0, 3:40] = 1
    valid[2, :30] = 1
    offset = torch.tensor([40, Smax, Smax - C], dtype=torch.int32, device=dev)
    o = chunk_decode_attention(q, cache, layer, valid, offset)
    torch.cuda.synchronize()
    ref = chunk_decode_attention(q, cache, layer, valid, offset, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)
    assert torch.all(o[1] == 0)


def _int4_case(rng, M, K, N, G, dev):
    x = _randn(rng, (M, K), dev)
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(dev) * K ** -0.5
    return x, tq.quantize_leaf_int4(w, G)


@pytest.mark.parametrize("M", [1, 8, 40, 512, 1024])
@pytest.mark.parametrize(
    "K,N,G",
    [(4096, 4096, 128), (4096, 11008, 128), (11008, 4096, 128), (4096, 32000, 128),
     (4096, 4096, 64), (4096, 4096, 32), (1024, 1000, 128)],
    ids=["qkvo", "gate_up", "down", "lm_head", "g64", "g32", "ragged_n"],
)
def test_int4_matmul_matches_plain(dev, M, K, N, G):
    rng = np.random.default_rng(M + N + G)
    x, qt = _int4_case(rng, M, K, N, G, dev)
    before = kernels.LAUNCHES["int4_matmul"]
    y = grouped_int4_matmul(x, qt["q4"], qt["s"])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int4_matmul"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    ref = int4_matmul_reference(x, qt["q4"], qt["s"], torch.float32)
    assert (y.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    y32 = grouped_int4_matmul(x, qt["q4"], qt["s"], torch.float32)
    assert (y32 - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_int4_matmul_dispatch_and_refusals(dev):
    rng = np.random.default_rng(3)
    x, qt = _int4_case(rng, 1100, 1024, 512, 128, dev)
    before = kernels.LAUNCHES["int4_matmul"]
    tq.INT4_DEQUANT_CALLS.clear()
    tq.int4_matmul(x[:1024], qt["q4"], qt["s"])  # B8
    y = tq.int4_matmul(x, qt["q4"], qt["s"])      # more than 1024 rows: the dequant path
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int4_matmul"] == before + 1
    assert dict(tq.INT4_DEQUANT_CALLS) == {(1100, 1024, 512): 1}
    ref = int4_matmul_reference(x, qt["q4"], qt["s"], torch.float32)
    assert (y.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    with pytest.raises(TypeError, match="bf16"):
        grouped_int4_matmul(x.float(), qt["q4"], qt["s"])
    with pytest.raises(ValueError, match="contiguous"):
        grouped_int4_matmul(x, qt["q4"].contiguous(), qt["s"])  # row-major packed bytes
    assert grouped_int4_matmul(x[:0], qt["q4"], qt["s"]).shape == (0, 512)
    assert kernels.LAUNCHES["int4_matmul"] == before + 1


@pytest.mark.parametrize("out_f32", [False, True], ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("M", [1, 16, 17, 32, 33, 64, 127, 128, 129, 1000, 1024])
@pytest.mark.parametrize(
    "K,N,G",
    [(11008, 4096, 128), (1024, 1000, 128), (4096, 4096, 64), (4096, 4096, 32),
     (1024, 512, 16), (768, 640, 48)],
    ids=["down", "ragged_n", "g64", "g32", "g16", "g48"],
)
def test_int4_matmul_tile_edges(dev, M, K, N, G, out_f32):
    """B8 at the edges of its tile table (rows kernel at 16 and 32 rows and
    at two 32-row tiles up to 64, wgmma kernel at 128-row tiles from 65),
    with 43 groups per half (down), a ragged last column tile, and groups of
    16-128 rows (stages of 16, 32 and 64)."""
    rng = np.random.default_rng(M * 7 + N + G)
    x, qt = _int4_case(rng, M, K, N, G, dev)
    out_dtype = torch.float32 if out_f32 else torch.bfloat16
    before = kernels.LAUNCHES["int4_matmul"]
    y = grouped_int4_matmul(x, qt["q4"], qt["s"], out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int4_matmul"] == before + 1  # one launch, splits folded in it
    assert y.dtype == out_dtype and y.shape == (M, N)
    ref = int4_matmul_reference(x, qt["q4"], qt["s"], torch.float32)
    tol = 1e-4 if out_f32 else 1e-2
    assert (y.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("M", [8, 1024], ids=["split", "one_split"])
def test_int4_matmul_deterministic(dev, M):
    from multimodal_unlearning_tpu_torch.ops.int4_matmul import splits_for

    rng = np.random.default_rng(11)
    x, qt = _int4_case(rng, M, 4096, 4096, 128, dev)
    assert (splits_for(M, 4096, 16)[1] > 1) == (M == 8)
    a = grouped_int4_matmul(x, qt["q4"], qt["s"], torch.float32)
    b = grouped_int4_matmul(x, qt["q4"], qt["s"], torch.float32)
    c = grouped_int4_matmul(x, qt["q4"], qt["s"])
    d = grouped_int4_matmul(x, qt["q4"], qt["s"])
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_decode_split_runs(dev, G, D, int8):
    """The column runs of the one-token kernel: a row longer than one run, a
    row whose middle runs see nothing, an all-invalid row (0), Smax not a
    multiple of the run; two calls give the same bits."""
    from multimodal_unlearning_tpu_torch.ops.decode_attention import decode_split_plan, sm_count

    rng = np.random.default_rng(20 + G + D)
    L, B, Hkv, Smax, layer = 2, 3, 2, 2000, 1
    splits, per = decode_split_plan(B, Hkv, G, Smax, sm_count(dev))
    assert splits > 1 and Smax % per
    cache = _cache(rng, (L, B, Hkv, Smax, D), dev, int8)
    q = _randn(rng, (B, Hkv * G, 1, D), dev)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    valid[0, 3:per + 50] = 1                 # longer than one run
    valid[1, 10:20] = 1                      # the first run ...
    valid[1, Smax - 30:] = 1                 # ... and the last; the runs between see nothing
    name = "flash_decode_q8" if int8 else "flash_decode"
    before = kernels.LAUNCHES[name]
    o = decode_attention(q, cache, layer, valid)
    o2 = decode_attention(q, cache, layer, valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 2
    ref = decode_attention(q, cache, layer, valid, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)
    assert torch.all(o[2] == 0)
    assert torch.equal(o, o2)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("P", [16, 128])
def test_decode_narrowed_mask(dev, int8, P):
    """The mask narrowed to its first S columns, as the serving engine hands
    it over (a view of the [B, Smax] mask): the columns past S are never
    looked at, paged equals dense bit for bit, one run and two."""
    from multimodal_unlearning_tpu_torch.ops.decode_attention import decode_split_plan, sm_count

    rng = np.random.default_rng(40 + P)
    L, B, Hkv, G, Smax, D, layer = 2, 8, 8, 1, 2048, 128, 1
    dense = _cache(rng, (L, B, Hkv, Smax, D), dev, int8)
    pool = _paged(dense, P, rng)
    q = _randn(rng, (B, Hkv * G, 1, D), dev)
    full = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    for b in range(B):
        if b != 3:                          # row 3 sees nothing before the cut
            full[b, 10 * b:100 + 120 * b] = 1
    full[:, 1100:] = 1                      # past every cut: never looked at
    for S, runs in ((256, 1), (1100, 2)):
        assert decode_split_plan(B, Hkv, G, S, sm_count(dev))[0] == runs
        mask = full[:, :S]
        o = decode_attention(q, dense, layer, mask)
        op = paged_decode_attention(q, pool, layer, mask)
        torch.cuda.synchronize()
        assert torch.equal(o, op)           # bit for bit
        assert torch.all(o[3] == 0)
        cut = torch.zeros_like(full)
        cut[:, :S] = mask
        ref = decode_attention(q, dense, layer, cut, impl="plain")
        torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("P", [16, 128])
def test_paged_decode_splits_equal_dense(dev, int8, P):
    from multimodal_unlearning_tpu_torch.ops.decode_attention import decode_split_plan, sm_count

    rng = np.random.default_rng(30 + P)
    L, B, Hkv, G, S, D, layer = 2, 4, 8, 1, 2048, 128, 1
    assert decode_split_plan(B, Hkv, G, S, sm_count(dev))[0] > 1
    dense = _cache(rng, (L, B, Hkv, S, D), dev, int8)
    pool = _paged(dense, P, rng)
    q = _randn(rng, (B, Hkv * G, 1, D), dev)
    valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
    valid[0, :1500] = 1
    valid[1, 7:40] = 1
    valid[1, 1900:1910] = 1
    valid[3, 1024:] = 1                    # row 2 idle
    o = paged_decode_attention(q, pool, layer, valid)
    torch.cuda.synchronize()
    assert torch.equal(o, decode_attention(q, dense, layer, valid))  # bit for bit
    assert torch.all(o[2] == 0)
    ref = paged_decode_attention(q, pool, layer, valid, impl="plain")
    torch.testing.assert_close(o.float(), ref.float(), atol=O_TOL, rtol=0)


def _randn32(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,D,causal,q_offset,pad",
    [
        (8, 32, 32, 128, 128, 128, True, 0, 70),     # ECO's prefill: left-padded rows
        (2, 32, 8, 200, 200, 128, True, 0, 37),      # GQA
        (2, 8, 8, 70, 300, 128, True, 230, 0),       # q_offset > 0
        (3, 4, 2, 129, 129, 64, False, 0, 129),      # a fully padded batch row
        (2, 4, 4, 37, 93, 80, True, 50, 5),          # D 80, ragged lengths
        (1, 4, 4, 100, 100, 64, True, 0, 3),         # D 64, causal
    ],
    ids=["eco_prefill", "gqa", "q_offset", "dead_row", "ragged_d80", "causal_d64"],
)
def test_flash_fwd_f32_matches_plain(dev, B, Hq, Hkv, Sq, Sk, D, causal, q_offset, pad):
    """B1's f32 instance: f32 in and out, against the plain version in f32;
    the bf16 kernel's count does not move."""
    rng = np.random.default_rng(40)
    q, k, v = (_randn32(rng, (B, h, s, D), dev) for h, s in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
    mask = torch.ones((B, Sk), dtype=torch.int32, device=dev)
    mask[0, :pad] = 0
    before = dict(kernels.LAUNCHES)
    o, lse = flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd_f32"] == before["flash_fwd_f32"] + 1
    assert kernels.LAUNCHES["flash_fwd"] == before["flash_fwd"]
    assert o.dtype == torch.float32
    o_ref, lse_ref = flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_offset,
                                         impl="plain")
    torch.testing.assert_close(o, o_ref, atol=F32_TOL, rtol=0)
    live = lse_ref > -1e29
    torch.testing.assert_close(lse[live], lse_ref[live], atol=F32_LSE_TOL, rtol=0)
    assert torch.all(lse[~live] == -1e30)
    assert torch.all(o[~live.expand_as(o)] == 0)


def test_f32_has_no_backward_kernel(dev):
    """The backward kernels take bf16 only: an f32 gradient raises instead
    of running the plain version."""
    rng = np.random.default_rng(41)
    q, k, v = (_randn32(rng, (1, 4, 64, 128), dev).requires_grad_() for _ in range(3))
    o = flash_attention(q, k, v, causal=True)
    with pytest.raises(TypeError, match="bf16"):
        o.sum().backward()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("Smax,S", [(160, 160), (160, 100), (2000, 2000)],
                         ids=["eco", "narrowed", "split_runs"])
def test_flash_decode_f32_matches_plain(dev, G, D, Smax, S):
    """The one-token kernel's f32 instance: ECO's cache of 128 + 32 columns,
    a mask narrowed to fewer columns, and a row long enough for split runs;
    an all-invalid row gives 0, two calls give the same bits."""
    rng = np.random.default_rng(42 + G + D + S)
    L, B, Hkv, layer = 3, 5, 32 // G if D == 128 else 2, 2
    cache = {n: _randn32(rng, (L, B, Hkv, Smax, D), dev) for n in ("k", "v")}
    q = _randn32(rng, (B, Hkv * G, 1, D), dev)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    for b, n in enumerate(rng.integers(1, S, B)):
        valid[b, S - n:S] = 1                   # left-padded rows
    valid[2] = 0                                # an all-invalid row
    valid = valid[:, :S]
    before = dict(kernels.LAUNCHES)
    o = decode_attention(q, cache, layer, valid)
    o2 = decode_attention(q, cache, layer, valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode_f32"] == before["flash_decode_f32"] + 2
    assert kernels.LAUNCHES["flash_decode"] == before["flash_decode"]
    assert o.dtype == torch.float32
    ref = decode_attention(q, cache, layer, valid, impl="plain")
    torch.testing.assert_close(o, ref, atol=F32_TOL, rtol=0)
    assert torch.all(o[2] == 0)
    assert torch.equal(o, o2)


def test_f32_decode_routes_refuse_mixed_types(dev):
    """Only an f32 query on an f32 cache takes the f32 instance; the chunk
    kernel has no f32 instance and raises."""
    rng = np.random.default_rng(43)
    cache = {n: _randn32(rng, (1, 2, 4, 64, 128), dev) for n in ("k", "v")}
    valid = torch.ones((2, 64), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        decode_attention(_randn(rng, (2, 4, 1, 128), dev), cache, 0, valid)
    with pytest.raises(TypeError):
        chunk_decode_attention(_randn32(rng, (2, 4, 3, 128), dev), cache, 0, valid,
                               torch.zeros(2, dtype=torch.int32, device=dev))
