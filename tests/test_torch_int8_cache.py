"""The port's int8 KV cache against the JAX package's, on the CPU.

- Quantize-at-write (``llama._cache_write`` at a column, and
  ``_cache_write_per_row`` at per-row columns, C = 1 and C = 3): the int8
  values and the f32 scales must be BIT-equal to the JAX package's (both
  compute amax/127 in f32, one IEEE division per element and round half
  to even), including the clamp of a start past Smax - C.
- The int8 decode route (``decode_attention`` on an int8 cache) against
  the JAX Pallas kernel ``_kernel_q8`` in interpret mode on live rows and
  against its XLA path on an all-invalid row (the port gives 0 there, the
  Pallas kernel the mean of V).  f32 queries, 1e-5: the JAX kernel keeps
  the scales outside the dots and the port's plain version dequantizes
  first, which changes only the order of f32 products.
- A prefill + decode of tiny-llama-test into an int8 cache: logits within
  1e-4 (f32, sums in another order).  The projections feeding the cache
  differ in the last f32 bit, so there the scales agree to 1e-5 relative
  and the int8 values to one step (a value on a rounding boundary).
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

ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4
L, B, H, SMAX, D = 2, 3, 2, 32, 16


def _caches():
    jcfg = jllama.LlamaConfig(vocab_size=8, hidden_size=H * D, intermediate_size=8,
                              num_layers=L, num_heads=H, num_kv_heads=H)
    tcfg = tconfig.LlamaConfig(vocab_size=8, hidden_size=H * D, intermediate_size=8,
                               num_layers=L, num_heads=H, num_kv_heads=H)
    return (jllama.init_kv_cache(jcfg, B, SMAX, dtype=jnp.int8),
            tllama.init_kv_cache(tcfg, B, SMAX, dtype=torch.int8, device="cpu"))


def _same(tc, jc):
    assert set(tc) == set(jc) == {"k", "v", "k_s", "v_s"}
    for name in tc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


def test_init_int8_cache_layout():
    jc, tc = _caches()
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
    assert tuple(tc["k_s"].shape) == (L, B, H, 1, SMAX)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_write_at_column_is_bit_exact(dtype):
    rng = np.random.default_rng(0)
    jc, tc = _caches()
    for layer, off, S in ((0, 0, 7), (1, 5, 11), (0, 20, 12)):
        k = rng.standard_normal((B, H, S, D), dtype=np.float32) * 3
        v = rng.standard_normal((B, H, S, D), dtype=np.float32)
        k[0, 0, 0] = 0.0  # an all-zero vector: scale 0, values 0
        jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
        jc = jllama._cache_write(jc, jk, jv, layer, off)
        tdt = getattr(torch, dtype)
        tllama._cache_write(tc, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                            layer, off)
    _same(tc, jc)
    assert float(tc["k_s"][0, 0, 0, 0, 0]) == 0.0


@pytest.mark.parametrize("C", [1, 3])
def test_cache_write_per_row_is_bit_exact(C):
    rng = np.random.default_rng(1)
    jc, tc = _caches()
    # row 2 starts past Smax - C: both clamp the start to Smax - C
    for layer, offs in ((0, [0, 7, SMAX - 1]), (1, [3, 12, 30]), (1, [4, 0, 2])):
        k = rng.standard_normal((B, H, C, D), dtype=np.float32)
        v = rng.standard_normal((B, H, C, D), dtype=np.float32) * 0.1
        off = np.asarray(offs, np.int32)
        jc = jllama._cache_write_per_row(jc, jnp.asarray(k), jnp.asarray(v), layer,
                                         jnp.asarray(off))
        tllama._cache_write(tc, torch.from_numpy(k), torch.from_numpy(v), layer,
                            torch.from_numpy(off))
    _same(tc, jc)


@pytest.mark.parametrize("G", [1, 2], ids=["mha", "gqa"])
def test_int8_decode_matches_jax(G):
    rng = np.random.default_rng(2)
    layer, Hkv, Smax = 1, 2, 64
    jcfg = jllama.LlamaConfig(vocab_size=8, hidden_size=Hkv * D, intermediate_size=8,
                              num_layers=L, num_heads=Hkv, num_kv_heads=Hkv)
    jc = jllama.init_kv_cache(jcfg, B, Smax, dtype=jnp.int8)
    k = rng.standard_normal((B, Hkv, Smax, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Smax, D), dtype=np.float32)
    jc = jllama._cache_write(jc, jnp.asarray(k), jnp.asarray(v), layer, 0)
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    q = rng.standard_normal((B, Hkv * G, 1, D), dtype=np.float32)
    valid = np.zeros((B, Smax), np.int32)
    valid[0, :9] = 1
    valid[1, 4:40] = 1
    valid[1, 55] = 1
    # row 2 all-invalid: an idle engine slot
    got = tdec.decode_attention(torch.from_numpy(q), tc, layer, torch.from_numpy(valid)).numpy()
    pallas = np.asarray(jdec.decode_attention(jnp.asarray(q), jc, layer, jnp.asarray(valid),
                                              impl="interpret"))
    xla = np.asarray(jdec.decode_attention(jnp.asarray(q), jc, layer, jnp.asarray(valid),
                                           impl="xla"))
    np.testing.assert_allclose(got[:2], pallas[:2], atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(got, xla, atol=ATTN_TOL, rtol=0)
    assert np.all(got[2] == 0)


def test_int8_prefill_and_decode_match_jax():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    model = convert.from_jax(jax.tree.map(np.asarray, params),
                             tconfig.LlamaConfig.from_registry(arch), device="cpu")
    rng = np.random.default_rng(3)
    Bq, S, Smax = 2, 10, 32
    ids = rng.integers(3, jcfg.vocab_size, (Bq, S)).astype(np.int32)
    mask = np.ones((Bq, S), np.int32)
    mask[1, :4] = 0
    valid = np.zeros((Bq, Smax), np.int32)
    valid[:, :S] = mask
    jcache = jllama.init_kv_cache(jcfg, Bq, Smax, dtype=jnp.int8)
    tcache = tllama.init_kv_cache(model.cfg, Bq, Smax, dtype=torch.int8, device="cpu")
    jout = jllama.forward(params, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                          kv_cache=jcache, cache_offset=0, kv_valid_mask=jnp.asarray(valid),
                          compute_dtype=jnp.float32)
    tout = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                 kv_cache=tcache, cache_offset=0, kv_valid_mask=torch.from_numpy(valid),
                 compute_dtype=torch.float32)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=LOGIT_TOL, rtol=0)
    jcache = jout["kv_cache"]
    pos = mask.sum(-1)
    cols = np.full((Bq,), S, np.int32)
    for step in range(2):
        tok = rng.integers(3, jcfg.vocab_size, (Bq, 1)).astype(np.int32)
        valid[:, S + step] = 1
        kw = dict(attention_mask=np.ones((Bq, 1), np.int32), positions=(pos + step)[:, None],
                  kv_valid_mask=valid)
        jout = jllama.forward(params, jcfg, jnp.asarray(tok), kv_cache=jcache,
                              cache_offset=jnp.asarray(cols + step), compute_dtype=jnp.float32,
                              **{n: jnp.asarray(a) for n, a in kw.items()})
        tout = model(torch.from_numpy(tok).long(), kv_cache=tcache,
                     cache_offset=torch.from_numpy(cols + step), compute_dtype=torch.float32,
                     **{n: torch.from_numpy(np.array(a)) for n, a in kw.items()})
        jcache = jout["kv_cache"]
        np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                                   atol=LOGIT_TOL, rtol=0)
    for name in ("k", "v"):
        diff = tcache[name].numpy().astype(np.int32) - np.asarray(jcache[name], np.int32)
        assert np.abs(diff).max() <= 1 and np.mean(diff != 0) < 0.01, name
        np.testing.assert_allclose(tcache[name + "_s"].numpy(), np.asarray(jcache[name + "_s"]),
                                   rtol=1e-5, atol=0)
