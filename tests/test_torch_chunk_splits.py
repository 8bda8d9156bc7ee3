"""The chunk kernel's column splits, on the CPU: ``chunk_split_plan`` and
``chunk_attention_split_reference`` (``multimodal_unlearning_tpu_torch/ops/
decode_attention.py``), the plain form of what ``csrc/chunk_decode.cu``
does for short chunks: each run of columns gives a partial (max, sum,
unnormalised output) and the runs merge by the log-sum-exp rule.

- The plan: runs of whole 64-column tiles covering [0, Smax), none empty,
  one split for long chunks, the same plan for a dense and a paged call of
  one shape (it sees logical columns only).
- The split arithmetic against ``chunk_attention_reference`` in f32 /
  f64: 1e-5 (the same sums in another order), with runs that see nothing,
  a row that sees nothing (0), GQA, and int8 scales kept outside both
  products (against the dequantized cache).
- One tiny case against the JAX Pallas ``_chunk_kernel`` /
  ``_chunk_kernel_q8`` in interpret mode: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.ops import decode_attention as jdec
from multimodal_unlearning_tpu_torch.ops import decode_attention as tdec

TOL = 1e-5


@pytest.mark.parametrize(
    "B,Hkv,M,Smax,sms",
    [
        (8, 32, 5, 2048, 132),    # the verify round
        (4, 8, 20, 2048, 132),    # GQA verify
        (8, 32, 1, 2048, 132),
        (2, 2, 3, 64, 132),       # one tile
        (1, 32, 32, 1000, 132),   # Smax not a multiple of the tile
        (1, 1, 5, 8192, 8),
        (1, 32, 512, 1536, 132),  # chunked prefill: one split
        (3, 8, 70, 1000, 132),
    ],
)
def test_split_plan_covers_the_columns_in_tiles(B, Hkv, M, Smax, sms):
    splits, per = tdec.chunk_split_plan(B, Hkv, M, Smax, sms)
    assert splits >= 1 and per > 0 and per % tdec.CHUNK_TILE == 0
    assert per * splits >= Smax > per * (splits - 1)  # covers, none empty
    if M > tdec.CHUNK_SPLIT_ROWS:
        assert splits == 1
    # a paged cache of the same logical columns gets the same plan
    for P in (16, 128):
        if Smax % P == 0:
            assert tdec.chunk_split_plan(B, Hkv, M, (Smax // P) * P, sms) == (splits, per)


def test_split_plan_splits_the_verify_round_only():
    assert tdec.chunk_split_plan(8, 32, 5, 2048, 132)[0] > 1
    assert tdec.chunk_split_plan(4, 8, 20, 2048, 132)[0] > 1
    assert tdec.chunk_split_plan(1, 32, 512, 2048, 132) == (1, 2048)


def _case(rng, B, Hkv, G, C, S, D, dtype=np.float64):
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, C, D)).astype(dtype))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, S, D)).astype(dtype))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, S, D)).astype(dtype))
    return q, k, v


@pytest.mark.parametrize(
    "G,C,plan",
    [
        (1, 5, (5, 64)),     # rows whose prefix ends in the first run: later runs see nothing
        (1, 5, (3, 128)),
        (2, 3, (2, 192)),    # GQA
        (1, 1, (1, 320)),    # one run
        (4, 5, (10, 32)),    # runs narrower than a tile: the rule does not care
    ],
)
def test_split_reference_matches_reference(G, C, plan):
    rng = np.random.default_rng(0)
    B, Hkv, S, D = 3, 2, 300, 16
    q, k, v = _case(rng, B, Hkv, G, C, S, D)
    valid = torch.zeros((B, S), dtype=torch.int32)
    valid[0, 10:40] = 1       # prefix ending in the first run
    valid[1, 150:290] = 1     # left padding, then a prefix into the last run
    offset = torch.tensor([40, 290, S])  # row 2: nothing valid, chunk past Smax
    vis = tdec.chunk_visibility(valid, offset, C)
    want = tdec.chunk_attention_reference(q, k, v, vis, 0.25)
    got = tdec.chunk_attention_split_reference(q, k, v, vis, 0.25, plan)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert torch.all(got[2] == 0)  # a row that sees nothing gives 0


def test_split_reference_f32_and_int8_scales():
    """f32 in, f32 sums; an int8 cache's scales outside both products against
    the dequantized cache."""
    rng = np.random.default_rng(1)
    B, Hkv, G, C, S, D = 2, 2, 2, 5, 256, 16
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, C, D), dtype=np.float32))
    kq = torch.from_numpy(rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.float32))
    vq = torch.from_numpy(rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.float32))
    ks = torch.from_numpy((0.01 + 0.01 * rng.random((B, Hkv, S))).astype(np.float32))
    vs = torch.from_numpy((0.01 + 0.01 * rng.random((B, Hkv, S))).astype(np.float32))
    valid = torch.zeros((B, S), dtype=torch.int32)
    valid[0, :70] = 1
    valid[1, 5:200] = 1
    vis = tdec.chunk_visibility(valid, torch.tensor([70, 200]), C)
    want = tdec.chunk_attention_reference(q, kq * ks[..., None], vq * vs[..., None], vis, 0.25)
    for plan in ((4, 64), (2, 128), (1, 256)):
        got = tdec.chunk_attention_split_reference(q, kq, vq, vis, 0.25, plan, k_scale=ks,
                                                   v_scale=vs)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    plain = tdec.chunk_attention_split_reference(q, kq * ks[..., None], vq * vs[..., None], vis,
                                                 0.25, (4, 64))
    torch.testing.assert_close(plain, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_split_reference_matches_jax_kernel(kind):
    rng = np.random.default_rng(2)
    L, B, Hkv, G, C, Smax, D, layer = 2, 2, 2, 2, 3, 64, 16, 1
    k = rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32)
    v = rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32)
    cache = {"k": k, "v": v}
    if kind == "int8":
        for n, x in (("k", k), ("v", v)):
            s = np.abs(x).max(-1, keepdims=True) / 127.0
            cache[n] = np.round(x / s).astype(np.int8)
            cache[n + "_s"] = np.swapaxes(s, -1, -2).astype(np.float32)
    q = rng.standard_normal((B, Hkv * G, C, D), dtype=np.float32)
    valid = np.zeros((B, Smax), np.int32)
    valid[0, 2:20] = 1
    offset = np.asarray([20, Smax - C], np.int32)
    valid[1, 30:Smax - C] = 1
    want = np.asarray(jdec.chunk_decode_attention(
        jnp.asarray(q), {n: jnp.asarray(a) for n, a in cache.items()}, layer,
        jnp.asarray(valid), jnp.asarray(offset), impl="pallas", interpret=True))
    tk = torch.from_numpy(cache["k"][layer].astype(np.float32))
    tv = torch.from_numpy(cache["v"][layer].astype(np.float32))
    scales = {}
    if kind == "int8":
        scales = dict(k_scale=torch.from_numpy(cache["k_s"][layer][:, :, 0]),
                      v_scale=torch.from_numpy(cache["v_s"][layer][:, :, 0]))
    vis = tdec.chunk_visibility(torch.from_numpy(valid), torch.from_numpy(offset), C)
    got = tdec.chunk_attention_split_reference(torch.from_numpy(q), tk, tv, vis, D ** -0.5,
                                               (4, 16), **scales)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
