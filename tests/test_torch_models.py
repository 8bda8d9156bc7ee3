"""The port's models (CPU, f32) against the JAX package's on the same
weights, carried across by ``models/convert.py``: llama without a cache,
llama prefill into a cache followed by three decode steps (tiny-llama-test),
the ViT tower and the whole LLaVA forward with pixels (tiny-llava-test).
Tolerance 1e-4 on logits and features (f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu.models import vit as jvit
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny_llama():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def tiny_llava():
    arch = get_model_identifiers("tiny-llava-test").arch
    jcfg = jllava.LlavaConfig.from_registry(arch)
    params = jllava.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tconfig.LlavaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, model


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_llama_no_cache(tiny_llama):
    jcfg, params, model = tiny_llama
    rng = np.random.default_rng(0)
    ids = rng.integers(3, jcfg.vocab_size, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, :3] = 0
    want = jllama.forward(params, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                          compute_dtype=jnp.float32)["logits"]
    got = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                compute_dtype=torch.float32)["logits"]
    _close(got, want)


def test_llama_prefill_then_decode(tiny_llama):
    """Left-padded prefill into a cache slab, then three single-token steps
    with per-row cache columns, as the serving engine drives them."""
    jcfg, params, model = tiny_llama
    rng = np.random.default_rng(1)
    B, S, smax = 2, 16, 24
    ids = np.zeros((B, S), np.int32)
    mask = np.zeros((B, S), np.int32)
    ids[0, 4:] = rng.integers(3, jcfg.vocab_size, S - 4)
    mask[0, 4:] = 1
    ids[1] = rng.integers(3, jcfg.vocab_size, S)
    mask[1] = 1
    jcache = jllama.init_kv_cache(jcfg, B, smax, dtype=jnp.float32)
    tcache = tllama.init_kv_cache(model.cfg, B, smax, dtype=torch.float32, device="cpu")
    jout = jllama.forward(params, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                          kv_cache=jcache, cache_offset=0, kv_valid_mask=jnp.asarray(mask),
                          compute_dtype=jnp.float32, last_logit_only=True)
    tout = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                 kv_cache=tcache, cache_offset=0, kv_valid_mask=torch.from_numpy(mask),
                 compute_dtype=torch.float32, last_logit_only=True)
    _close(tout["logits"], jout["logits"])
    jcache = jout["kv_cache"]
    valid = np.zeros((B, smax), np.int32)
    valid[:, :S] = mask
    tok = np.asarray(jnp.argmax(jout["logits"][:, -1], -1)).astype(np.int32)
    pos, col = mask.sum(1), np.full((B,), S)
    for _ in range(3):
        valid[np.arange(B), col] = 1
        jout = jllama.forward(
            params, jcfg, jnp.asarray(tok[:, None]), positions=jnp.asarray(pos[:, None]),
            kv_cache=jcache, cache_offset=jnp.asarray(col, jnp.int32),
            kv_valid_mask=jnp.asarray(valid), compute_dtype=jnp.float32)
        tout = model(torch.from_numpy(tok[:, None]).long(),
                     positions=torch.from_numpy(pos[:, None]), kv_cache=tcache,
                     cache_offset=torch.from_numpy(col), kv_valid_mask=torch.from_numpy(valid),
                     compute_dtype=torch.float32)
        _close(tout["logits"], jout["logits"])
        jcache = jout["kv_cache"]
        tok = np.asarray(jnp.argmax(jout["logits"][:, -1], -1)).astype(np.int32)
        pos, col = pos + 1, col + 1
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_vit_features(tiny_llava):
    jcfg, params, model = tiny_llava
    pix = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jvit.forward(params["vision_tower"], jcfg.vision, jnp.asarray(pix),
                        compute_dtype=jnp.float32)
    got = model.vision_tower(torch.from_numpy(pix), compute_dtype=torch.float32)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_llava_forward_with_pixels(tiny_llava):
    jcfg, params, model = tiny_llava
    rng = np.random.default_rng(3)
    n = jcfg.num_image_tokens
    ids = rng.integers(3, jcfg.image_token_id, (2, n + 10)).astype(np.int32)
    ids[:, 3:3 + n] = jcfg.image_token_id
    pix = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jllava.forward(params, jcfg, jnp.asarray(ids), pixel_values=jnp.asarray(pix),
                          compute_dtype=jnp.float32)["logits"]
    got = model(torch.from_numpy(ids).long(), pixel_values=torch.from_numpy(pix),
                compute_dtype=torch.float32)["logits"]
    _close(got, want)


def test_convert_rejects_a_short_tree(tiny_llama):
    jcfg, params, model = tiny_llama
    tree = jax.tree.map(np.asarray, params)
    del tree["layers"]["q_proj"]
    with pytest.raises(KeyError):
        convert.from_jax(tree, model.cfg, device="cpu")
