"""Verify-chunk attention (``chunk_decode_attention``) and the ``chunk_decode``
forward of the port against the JAX package's, on the CPU.

- ``chunk_decode_attention`` against the JAX Pallas kernels ``_chunk_kernel``
  / ``_chunk_kernel_q8`` in interpret mode, with per-row offsets, stale
  cache columns past the chunk and left padding below it (both invisible),
  MHA and GQA.  f32 and int8 caches with f32 queries: 1e-5 (the same
  arithmetic in another order; int8: the kernel keeps the scales outside the
  products, the port's plain version dequantizes first).  bf16: 2e-2, both
  sides round p and the output to bf16 at different places (|o| <= ~3).
- A ``chunk_decode`` forward of tiny-llama-test over C = 3 tokens against C
  single-token decode forwards of the port (as ``tests/test_speculative.py``
  holds the JAX package): f32 cache 5e-5, int8 cache 5e-3 (both read the
  quantized cache back; the values feeding it differ in the last f32 bits,
  which can move an int8 value by one step), and the cache equal where
  written to that precision.
- The same ``chunk_decode`` forward against the JAX package's: logits 1e-4
  and the cache 1e-5 (f32 sums in another order) / within one int8 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.ops import decode_attention as jdec
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.ops import decode_attention as tdec

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _cache(rng, kind, L, B, Hkv, Smax, D):
    k = rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32)
    v = rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32)
    if kind != "int8":
        return {"k": k, "v": v}
    cache = {}
    for name, x in (("k", k), ("v", v)):
        s = np.abs(x).max(-1, keepdims=True) / 127.0
        cache[name] = np.round(x / s).astype(np.int8)
        cache[name + "_s"] = np.swapaxes(s, -1, -2).astype(np.float32)
    return cache


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("G,C", [(1, 5), (2, 3)], ids=["mha_c5", "gqa_c3"])
def test_chunk_attention_matches_jax_kernel(kind, G, C):
    rng = np.random.default_rng(0)
    L, B, Hkv, Smax, D, layer = 2, 3, 2, 64, 16, 1
    cache = _cache(rng, kind, L, B, Hkv, Smax, D)
    q = rng.standard_normal((B, Hkv * G, C, D), dtype=np.float32)
    valid = np.zeros((B, Smax), np.int32)
    offset = np.asarray([12, 40, Smax - C], np.int32)
    valid[0, :12] = 1            # prefix 0..11, chunk at 12..
    valid[1, 5:33] = 1           # left padding 0..4, stale columns 33..39 below the chunk
    valid[2, 20:Smax - C] = 1    # chunk at the cache's end
    # row 1's columns past its chunk (offset+C..) hold stale values, kv_valid 0
    jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    tdt = torch.bfloat16 if kind == "bf16" else torch.float32
    jc = {n: jnp.asarray(a, jdt if a.dtype == np.float32 and not n.endswith("_s") else None)
          for n, a in cache.items()}
    want = np.asarray(jdec.chunk_decode_attention(
        jnp.asarray(q, jdt), jc, layer, jnp.asarray(valid), jnp.asarray(offset),
        impl="pallas", interpret=True).astype(jnp.float32))
    tc = {n: torch.from_numpy(a).to(tdt) if a.dtype == np.float32 and not n.endswith("_s")
          else torch.from_numpy(a) for n, a in cache.items()}
    got = tdec.chunk_decode_attention(torch.from_numpy(q).to(tdt), tc, layer,
                                      torch.from_numpy(valid), torch.from_numpy(offset))
    assert got.dtype == tdt and tuple(got.shape) == (B, Hkv * G, C, D)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=BF16_TOL if kind == "bf16" else F32_TOL, rtol=0)


def test_chunk_visibility_rule():
    valid = torch.tensor([[1, 1, 0, 0, 0, 0, 1, 0]])
    vis = tdec.chunk_visibility(valid, torch.tensor([3]), 2)
    assert vis.int().tolist() == [[[1, 1, 0, 1, 0, 0, 1, 0], [1, 1, 0, 1, 1, 0, 1, 0]]]


@pytest.fixture(scope="module")
def tiny():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.from_jax(jax.tree.map(np.asarray, params),
                             tconfig.LlamaConfig.from_registry(arch), device="cpu")
    return jcfg, params, model


B, S, C, SMAX = 2, 12, 3, 64


def _prefilled(model, cache_dtype, ids, mask):
    cache = tllama.init_kv_cache(model.cfg, B, SMAX, dtype=cache_dtype, device="cpu")
    valid = torch.zeros((B, SMAX), dtype=torch.int32)
    valid[:, :S] = torch.from_numpy(mask)
    model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), kv_cache=cache,
          cache_offset=0, kv_valid_mask=valid, compute_dtype=torch.float32)
    return cache, valid


def _inputs(jcfg):
    rng = np.random.default_rng(1)
    ids = rng.integers(3, jcfg.vocab_size, (B, S))
    mask = np.ones((B, S), np.int64)
    ids[0, :4] = 0
    mask[0, :4] = 0
    chunk = rng.integers(3, jcfg.vocab_size, (B, C))
    return ids, mask, chunk


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_chunk_forward_matches_sequential_decodes(tiny, cache_dtype):
    jcfg, _, model = tiny
    ids, mask, chunk = _inputs(jcfg)
    plen = torch.from_numpy(mask.sum(-1))
    offsets = torch.tensor([S, S + 1])  # row 1 one column further, as after uneven acceptance

    cache_a, valid_a = _prefilled(model, cache_dtype, ids, mask)
    seq = []
    for i in range(C):
        valid_a[torch.arange(B), offsets + i] = 1
        out = model(torch.from_numpy(chunk[:, i:i + 1]), attention_mask=torch.ones((B, 1)),
                    positions=(plen + i)[:, None], kv_cache=cache_a, cache_offset=offsets + i,
                    kv_valid_mask=valid_a, compute_dtype=torch.float32)
        seq.append(out["logits"][:, 0])

    cache_b, valid_b = _prefilled(model, cache_dtype, ids, mask)
    out = model(torch.from_numpy(chunk), attention_mask=torch.ones((B, C)),
                positions=plen[:, None] + torch.arange(C)[None], kv_cache=cache_b,
                cache_offset=offsets, kv_valid_mask=valid_b, compute_dtype=torch.float32,
                chunk_decode=True)
    tol = 5e-5 if cache_dtype == torch.float32 else 5e-3
    for i in range(C):
        np.testing.assert_allclose(out["logits"][:, i].numpy(), seq[i].numpy(), atol=tol,
                                   rtol=tol, err_msg=f"position {i}")
    for name in cache_a:
        np.testing.assert_allclose(cache_b[name].float().numpy(), cache_a[name].float().numpy(),
                                   atol=1e-5 if name.endswith("_s") or cache_dtype != torch.int8
                                   else 1.0, rtol=1e-5)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_chunk_forward_matches_jax(tiny, cache_dtype):
    jcfg, params, model = tiny
    ids, mask, chunk = _inputs(jcfg)
    plen = mask.sum(-1).astype(np.int32)
    offsets = np.asarray([S, S + 2], np.int32)
    jdt = jnp.int8 if cache_dtype == torch.int8 else jnp.float32
    jcache = jllama.init_kv_cache(jcfg, B, SMAX, dtype=jdt)
    jvalid = jnp.zeros((B, SMAX), jnp.int32).at[:, :S].set(jnp.asarray(mask))
    fwd = lambda *a, **kw: jllama.forward(params, jcfg, *a, compute_dtype=jnp.float32, **kw)
    jcache = fwd(jnp.asarray(ids), attention_mask=jnp.asarray(mask), kv_cache=jcache,
                 cache_offset=0, kv_valid_mask=jvalid)["kv_cache"]
    jout = fwd(jnp.asarray(chunk), attention_mask=jnp.ones((B, C), jnp.int32),
               positions=jnp.asarray(plen[:, None] + np.arange(C)[None]), kv_cache=jcache,
               cache_offset=jnp.asarray(offsets), kv_valid_mask=jvalid, chunk_decode=True)

    cache, valid = _prefilled(model, cache_dtype, ids, mask)
    out = model(torch.from_numpy(chunk), attention_mask=torch.ones((B, C)),
                positions=torch.from_numpy(plen[:, None] + np.arange(C)[None]), kv_cache=cache,
                cache_offset=torch.from_numpy(offsets), kv_valid_mask=valid,
                compute_dtype=torch.float32, chunk_decode=True)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), atol=1e-4,
                               rtol=0)
    for name, want in jout["kv_cache"].items():
        got = cache[name].numpy()
        if name in ("k", "v") and cache_dtype == torch.int8:
            assert np.abs(got.astype(np.int32) - np.asarray(want, np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
