"""The port's paged KV-cache attention (``ops/paged_attention.py``) and paged
cache writes against the JAX package's, on the CPU.

Inputs are made with numpy from seeds: a dense cache chopped into a pool of
pages assigned by a random permutation (page 0 left unused, as the engine
keeps it), ragged validity rows, an idle row, and an all-invalid gap page
after a prefix that ends inside its page.

- ``paged_decode_attention`` against JAX ``paged_decode_attention`` through
  its XLA gather path and through its Pallas kernels ``_paged_kernel`` /
  ``_paged_kernel_q8`` in interpret mode (pages of 128, D 128: the shapes
  the TPU kernel takes).
- ``paged_chunk_decode_attention`` against the Pallas kernels
  ``_paged_chunk_kernel`` / ``_q8`` in interpret mode: chunks spanning one
  or two pages, and a chunk that starts a page past every valid one.
- ``_page_counts`` and ``gather_layer_kv`` against JAX's.
- ``_cache_write_per_row`` into a paged cache (``_cache_write_paged``) at
  C = 1 and C = 3 with rows straddling page boundaries, against JAX's.

Tolerances: f32 queries over f32 or int8 pools, 1e-5 (the same arithmetic
in another order; on int8 pools the JAX kernels keep the scales outside the
products while the port's plain version dequantizes first).  bf16: 2e-2,
both sides round p and the output to bf16 at different places (|o| <= ~3).
Cache writes and the gathered view: bit for bit (the same casts and the same
quantization).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.ops import paged_attention as jpa
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.ops import decode_attention as tdec
from multimodal_unlearning_tpu_torch.ops import paged_attention as tpa

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _dense(rng, kind, L, B, H, S, D):
    k = rng.standard_normal((L, B, H, S, D), dtype=np.float32)
    v = rng.standard_normal((L, B, H, S, D), dtype=np.float32)
    if kind != "int8":
        return {"k": k, "v": v}
    cache = {}
    for name, x in (("k", k), ("v", v)):
        s = np.abs(x).max(-1, keepdims=True) / 127.0
        cache[name] = np.round(x / s).astype(np.int8)
        cache[name + "_s"] = np.swapaxes(s, -1, -2).astype(np.float32)  # [L,B,H,1,S]
    return cache


def _paged(dense, P, rng):
    """numpy pool {k, v[, k_s, v_s], table} holding the dense cache's rows."""
    L, B, H, S, D = dense["k"].shape
    MP = S // P
    table = (1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)
    pool = {"table": table}
    for name, x in dense.items():
        if name in ("k", "v"):
            out = np.zeros((L, H, B * MP + 1, P, D), x.dtype)
            out[:, :, table] = x.reshape(L, B, H, MP, P, D).transpose(0, 2, 1, 3, 4, 5)
        else:
            out = np.zeros((L, H, B * MP + 1, 1, P), x.dtype)
            out[:, :, table] = x.reshape(L, B, H, 1, MP, P).transpose(0, 2, 1, 4, 3, 5)
        pool[name] = out
    return pool


def _both(pool, kind):
    """The numpy pool as a JAX cache and a port cache; f32 K/V in bf16 for
    kind "bf16"."""
    jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    tdt = torch.bfloat16 if kind == "bf16" else torch.float32
    jc, tc = {}, {}
    for n, a in pool.items():
        cast = a.dtype == np.float32 and n in ("k", "v")
        jc[n] = jnp.asarray(a, jdt) if cast else jnp.asarray(a)
        tc[n] = torch.from_numpy(a).to(tdt) if cast else torch.from_numpy(a)
    return jc, tc, jdt, tdt


def _ragged_valid(rng, B, S, dead=None, gap_row=None):
    valid = np.zeros((B, S), np.int32)
    for b in range(B):
        start = int(rng.integers(0, S // 4))
        valid[b, start:start + int(rng.integers(1, S - start))] = 1
    if gap_row is not None:  # a prefix ending inside page 0, page 1 empty, then the rest
        valid[gap_row] = 0
        valid[gap_row, :100] = 1
        valid[gap_row, 256:400] = 1
    if dead is not None:
        valid[dead] = 0
    return valid


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_paged_decode_matches_jax(kind, impl):
    rng = np.random.default_rng(0)
    L, B, Hkv, G, S, D, P, layer = 2, 4, 2, 4, 512, 128, 128, 1
    pool = _paged(_dense(rng, kind, L, B, Hkv, S, D), P, rng)
    q = rng.standard_normal((B, Hkv * G, 1, D), dtype=np.float32)
    valid = _ragged_valid(rng, B, S, dead=3, gap_row=1)
    jc, tc, jdt, tdt = _both(pool, kind)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q, jdt), jc, layer, jnp.asarray(valid), impl=impl,
        interpret=impl == "pallas").astype(jnp.float32))
    got = tdec.decode_attention(torch.from_numpy(q).to(tdt), tc, layer,
                                torch.from_numpy(valid))
    assert got.dtype == tdt and tuple(got.shape) == (B, Hkv * G, 1, D)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=BF16_TOL if kind == "bf16" else F32_TOL, rtol=0)
    assert torch.all(got[3] == 0)  # the idle row: 0 on both sides


def test_gap_pages_and_page_counts_match_jax():
    """All-invalid pages between valid ones (the gap after a page-aligned
    shared prefix) add nothing, on pages of 16 through the port's plain
    version and of 128 through the JAX Pallas kernel; ``_page_counts``
    agrees with JAX's."""
    rng = np.random.default_rng(1)
    L, B, Hkv, G, S, D = 1, 2, 1, 8, 512, 128
    dense = _dense(rng, "f32", L, B, Hkv, S, D)
    valid = np.zeros((B, S), np.int32)
    valid[:, :100] = 1
    valid[:, 256:400] = 1
    valid[1, 480:] = 1
    q = rng.standard_normal((B, Hkv * G, 1, D), dtype=np.float32)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), {n: jnp.asarray(a) for n, a in _paged(dense, 128, rng).items()}, 0,
        jnp.asarray(valid), impl="pallas", interpret=True))
    for P in (16, 128):
        got = tpa.paged_decode_attention(
            torch.from_numpy(q), {n: torch.from_numpy(a) for n, a in _paged(dense, P, rng).items()},
            0, torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    masks = [valid, rng.integers(0, 2, (5, 64)).astype(np.int32),
             np.array([[1, 1, 0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 1, 0], [0] * 8], np.int32)]
    for m, P in zip(masks, (128, 16, 2)):
        np.testing.assert_array_equal(tpa._page_counts(torch.from_numpy(m), P).numpy(),
                                      np.asarray(jpa._page_counts(jnp.asarray(m), P)))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["spans", "fresh_page"])
def test_paged_chunk_matches_jax_kernel(kind, case):
    """C query tokens per row at logical columns offset.. against the JAX
    paged verify-chunk kernel (interpret mode): rows whose chunks lie in one
    page or straddle two, and chunks that start a page past every valid one
    (the kernel must still read them)."""
    rng = np.random.default_rng(2)
    if case == "spans":
        L, B, Hkv, G, S, C, offset = 2, 3, 2, 2, 256, 5, [5, 126, 200]
    else:
        L, B, Hkv, G, S, C, offset = 1, 2, 1, 8, 512, 4, [128, 256]
    D, P, layer = 128, 128, L - 1
    pool = _paged(_dense(rng, kind, L, B, Hkv, S, D), P, rng)
    q = rng.standard_normal((B, Hkv * G, C, D), dtype=np.float32)
    valid = np.zeros((B, S), np.int32)
    for b, off in enumerate(offset):
        valid[b, int(rng.integers(0, 4)):off] = 1  # left padding, then the prefix
    off = np.asarray(offset, np.int32)
    jc, tc, jdt, tdt = _both(pool, kind)
    want = np.asarray(jpa.paged_chunk_decode_attention(
        jnp.asarray(q, jdt), jc, layer, jnp.asarray(valid), jnp.asarray(off),
        interpret=True).astype(jnp.float32))
    got = tdec.chunk_decode_attention(torch.from_numpy(q).to(tdt), tc, layer,
                                      torch.from_numpy(valid), torch.from_numpy(off))
    assert got.dtype == tdt and tuple(got.shape) == (B, Hkv * G, C, D)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=BF16_TOL if kind == "bf16" else F32_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("C", [1, 3])
def test_cache_write_paged_matches_jax(kind, C):
    """Per-row writes through the block table (rows ending exactly at, and
    straddling, page boundaries) leave the port's pool equal to JAX's, and
    the gathered logical view equal to JAX ``gather_layer_kv``'s."""
    rng = np.random.default_rng(3)
    L, B, Hkv, S, D, P, layer = 2, 3, 2, 64, 16, 16, 1
    pool = _paged(_dense(rng, kind, L, B, Hkv, S, D), P, rng)
    k_new = rng.standard_normal((B, Hkv, C, D), dtype=np.float32)
    v_new = rng.standard_normal((B, Hkv, C, D), dtype=np.float32)
    offset = np.asarray([P - 1, 2 * P - 2, S - C - 1], np.int32)
    jc, tc, jdt, tdt = _both(pool, kind)
    xdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    tx = torch.bfloat16 if kind == "bf16" else torch.float32
    jout = jllama._cache_write_per_row(jc, jnp.asarray(k_new, xdt), jnp.asarray(v_new, xdt),
                                       layer, jnp.asarray(offset))
    tout = tllama._cache_write_per_row(tc, torch.from_numpy(k_new).to(tx),
                                       torch.from_numpy(v_new).to(tx), layer,
                                       torch.from_numpy(offset))
    assert tout is tc  # written in place
    for n in tc:
        np.testing.assert_array_equal(tc[n].float().numpy() if n != "table" else tc[n].numpy(),
                                      np.asarray(jout[n].astype(jnp.float32) if n != "table"
                                                 else jout[n]), err_msg=n)
    for lay in range(L):
        jk, jv = jpa.gather_layer_kv(jout, lay, jnp.float32)
        tk, tv = tpa.gather_layer_kv(tc, lay, torch.float32)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_and_dense_agree_in_the_port():
    """Through the port alone: a paged cache routes decode and chunk
    attention to the paged functions, which give the dense cache's result on
    the same logical columns, and a per-row write followed by attention
    reads the freshly written column."""
    rng = np.random.default_rng(4)
    L, B, Hkv, G, S, D, P = 2, 3, 2, 2, 64, 16, 8
    dense = {n: torch.from_numpy(a) for n, a in _dense(rng, "f32", L, B, Hkv, S, D).items()}
    pool = {n: torch.from_numpy(a)
            for n, a in _paged({n: t.numpy() for n, t in dense.items()}, P, rng).items()}
    k_new = torch.from_numpy(rng.standard_normal((B, Hkv, 1, D), dtype=np.float32))
    v_new = torch.from_numpy(rng.standard_normal((B, Hkv, 1, D), dtype=np.float32))
    offset = torch.tensor([7, 20, 63])
    valid = torch.zeros((B, S), dtype=torch.int32)
    for b in range(B):
        valid[b, :int(offset[b]) + 1] = 1
    assert tpa.is_paged(pool) and not tpa.is_paged(dense)
    tllama._cache_write_per_row(dense, k_new, v_new, 1, offset)
    tllama._cache_write_per_row(pool, k_new, v_new, 1, offset)
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, 1, D), dtype=np.float32))
    torch.testing.assert_close(tdec.decode_attention(q, pool, 1, valid),
                               tdec.decode_attention(q, dense, 1, valid), atol=0, rtol=0)
    qc = torch.from_numpy(rng.standard_normal((B, Hkv * G, 3, D), dtype=np.float32))
    off = torch.tensor([3, 30, 61])
    torch.testing.assert_close(tdec.chunk_decode_attention(qc, pool, 1, valid, off),
                               tdec.chunk_decode_attention(qc, dense, 1, valid, off),
                               atol=F32_TOL, rtol=0)
    with pytest.raises(ValueError, match="per row"):
        tllama._cache_write(pool, k_new, v_new, 0, 0)
