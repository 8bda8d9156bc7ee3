"""The port's sampled decoding (``evaluation/sampling.py``, the sampled
route of ``evaluation/generate.py`` and of the serving engine) against the
JAX package's, f32 on the CPU.

- The threefry copy: per-row keys, fold-ins, random bits and uniforms equal
  ``jax.random``'s exactly, for a grid of seeds, fold indices and vocab
  sizes; the Gumbel noise agrees to a few f32 ulps (``log`` rounds its last
  bits differently).
- ``process_logits`` equals JAX's within 1e-6 (temperature, top-k, top-p and
  all three); sampled tokens equal JAX's exactly; top_k=1 is greedy.
- ``greedy_generate(do_sample=True)`` streams equal JAX's token for token
  (explicit seeds, the default ``arange(B)`` seeds, an eos); a second seed
  gives another stream.
- The engine's sampled streams equal each request's solo
  ``greedy_generate(do_sample=True)`` stream under slot churn, pipelined;
  sampling with speculation raises as in JAX.
- Preemption (ROADMAP queue 2): on a pool so tight that a slot is preempted
  and recomputed, the JAX engine draws the re-admitted request's tokens
  with fold indices restarting at 0, so its stream leaves the stream of a
  roomy pool after the preemption; the port goes on at index
  ``len(tokens)``, and its tight-pool streams equal the roomy pool's (and
  the JAX engine's roomy-pool streams).

The weights are the tiny llama's, drawn by the port (quicker than JAX's
init) and carried across as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.evaluation import generate as jgen
from multimodal_unlearning_tpu.evaluation import sampling as jsamp
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.evaluation import generate as tgen
from multimodal_unlearning_tpu_torch.evaluation import sampling as tsamp
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.serve import ServingEngine

SAMPLE = dict(temperature=0.9, top_k=40, top_p=0.95)


@pytest.fixture(scope="module")
def llama_setup():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    model = tllama.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcommon.model_tree(model))
    return jcfg, params, tcfg, model


def _jax_keys(seeds, idx):
    return jax.vmap(jax.random.fold_in)(jsamp.row_keys(jnp.asarray(seeds, jnp.int32)),
                                        jnp.asarray(idx, jnp.int32))


@pytest.mark.parametrize("vocab", [1, 7, 1001])
def test_bits_and_uniforms_equal_jax(vocab):
    seeds = np.array([0, 1, 7, 123456, 2 ** 31 - 1], np.int64)
    tkeys = tsamp.row_keys(torch.from_numpy(seeds))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(
        jsamp.row_keys(jnp.asarray(seeds, jnp.int32))).astype(np.int64))
    for i in (0, 5, 70000):
        idx = np.full(len(seeds), i)
        jk = _jax_keys(seeds, idx)
        tk = tsamp.fold_in(tkeys, torch.from_numpy(idx))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        jbits = np.stack([np.asarray(jax.random.bits(k, (vocab,))) for k in jk])
        np.testing.assert_array_equal(tsamp.random_bits(tk, vocab).numpy(),
                                      jbits.astype(np.int64))
        tiny = jnp.finfo(jnp.float32).tiny
        ju = np.stack([np.asarray(jax.random.uniform(k, (vocab,), minval=tiny)) for k in jk])
        np.testing.assert_array_equal(tsamp.uniform(tk, vocab).numpy(), ju)
        jg = np.stack([np.asarray(jax.random.gumbel(k, (vocab,))) for k in jk])
        np.testing.assert_allclose(tsamp.gumbel(tk, vocab).numpy(), jg, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.5), (0.7, 50, 0.9), (1e-9, 0, 1.0)])
def test_process_logits_and_tokens_equal_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 500)) * 3).astype(np.float32)
    want = np.asarray(jsamp.process_logits(jnp.asarray(logits), temperature, top_k, top_p))
    got = tsamp.process_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    seeds, idx = np.arange(6) * 11, np.arange(6) * 3 + 1
    jt = np.asarray(jsamp.sample_token(jsamp.row_keys(jnp.asarray(seeds, jnp.int32)),
                                       jnp.asarray(idx, jnp.int32), jnp.asarray(logits),
                                       temperature, top_k, top_p))
    tt = tsamp.sample_token(tsamp.row_keys(torch.from_numpy(seeds)), torch.from_numpy(idx),
                            torch.from_numpy(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(tt.numpy(), jt)
    greedy = tsamp.sample_token(tsamp.row_keys(torch.from_numpy(seeds)), torch.from_numpy(idx),
                                torch.from_numpy(logits), temperature, 1)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def _prompts(rng, vocab, lens, multiple=16):
    S = -(-max(lens) // multiple) * multiple
    ids = np.zeros((len(lens), S), np.int32)
    mask = np.zeros((len(lens), S), np.int32)
    for r, n in enumerate(lens):
        ids[r, S - n:] = rng.integers(3, vocab, n)
        mask[r, S - n:] = 1
    return ids, mask


@pytest.mark.parametrize("seeds,eos", [([5, 9, 1234], None), (None, 17)],
                         ids=["seeds", "default_seeds_eos"])
def test_generate_sampled_equals_jax(llama_setup, seeds, eos):
    jcfg, params, tcfg, model = llama_setup
    ids, mask = _prompts(np.random.default_rng(1), jcfg.vocab_size, [5, 12, 9])
    kw = dict(max_new_tokens=10, pad_token_id=0, eos_token_id=eos, do_sample=True,
              sample_seeds=seeds, **SAMPLE)
    want = np.asarray(jgen.greedy_generate(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                           cache_dtype=jnp.float32,
                                           compute_dtype=jnp.float32, **kw))
    got = tgen.greedy_generate(model, tcfg, ids, mask, cache_dtype=torch.float32,
                               compute_dtype=torch.float32, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if seeds is not None:
        other = tgen.greedy_generate(model, tcfg, ids, mask, cache_dtype=torch.float32,
                                     compute_dtype=torch.float32,
                                     **dict(kw, sample_seeds=[s + 1 for s in seeds])).numpy()
        assert (other != got).any()


def _solo(model, tcfg, prompt, max_new, seed):
    ids, mask = np.zeros((1, 16), np.int32), np.zeros((1, 16), np.int32)
    ids[0, 16 - len(prompt):] = prompt
    mask[0, 16 - len(prompt):] = 1
    return tgen.greedy_generate(model, tcfg, ids, mask, max_new_tokens=max_new, pad_token_id=0,
                                cache_dtype=torch.float32, compute_dtype=torch.float32,
                                do_sample=True, sample_seeds=[seed], **SAMPLE)[0].tolist()


def test_engine_sampled_streams_equal_solo_generate(llama_setup):
    _, _, tcfg, model = llama_setup
    rng = np.random.default_rng(2)
    specs = [(5, 7), (11, 4), (3, 8), (8, 6)]
    prompts = [rng.integers(3, tcfg.vocab_size, p).tolist() for p, _ in specs]
    seeds = [101, 202, 303, 404]
    eng = ServingEngine(model, tcfg, "llama", num_slots=2, max_len=128, chunk=3,
                        bucket_multiple=16, pad_token_id=0, cache_dtype=torch.float32,
                        compute_dtype=torch.float32, device="cpu", **SAMPLE)
    reqs = [eng.submit(p, m, sample_seed=s) for p, (_, m), s in zip(prompts, specs, seeds)]
    got = eng.drain(reqs)
    for toks, prompt, (_, n), seed in zip(got, prompts, specs, seeds):
        assert toks == _solo(model, tcfg, prompt, n, seed), seed
    # the default seed is the request's uid; another seed, another stream
    eng2 = ServingEngine(model, tcfg, "llama", num_slots=2, max_len=128, chunk=3,
                         bucket_multiple=16, pad_token_id=0, cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu", **SAMPLE)
    r = eng2.submit(prompts[2], 8)
    assert eng2.drain([r])[0] == _solo(model, tcfg, prompts[2], 8, r.uid)
    assert got[2] != eng2.drain([eng2.submit(prompts[2], 8, sample_seed=304)])[0]
    with pytest.raises(ValueError, match="speculate_k"):
        ServingEngine(model, tcfg, "llama", device="cpu", speculate_k=2, temperature=1.0)


def test_preemption_keeps_the_stream_jax_does_not(llama_setup):
    jcfg, params, tcfg, model = llama_setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, jcfg.vocab_size, 20).tolist() for _ in range(6)]
    kw = dict(num_slots=4, max_len=256, chunk=4, bucket_multiple=16, pad_token_id=0,
              page_size=16, temperature=1.0)

    def run(engine):
        reqs = [engine.submit(p, 40, sample_seed=10 + i) for i, p in enumerate(prompts)]
        return engine.drain(reqs), engine.stats()["preemptions"]

    jax_out = {}
    for pool in (13, None):  # 13 pages: growth preempts; None: the dense capacity
        jax_out[pool] = run(JaxEngine(params, jcfg, "llama", cache_dtype=jnp.float32,
                                      compute_dtype=jnp.float32, pipeline=False,
                                      kv_pool_pages=pool, **kw))
    port = {pool: run(ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                                    compute_dtype=torch.float32, device="cpu",
                                    kv_pool_pages=pool, **kw)) for pool in (13, None)}
    assert jax_out[13][1] >= 1 and port[13][1] >= 1 and port[None][1] == 0
    # the JAX fault: some preempted stream leaves its roomy-pool stream
    assert jax_out[13][0] != jax_out[None][0]
    # the port keeps every stream, and its streams are JAX's roomy ones
    assert port[13][0] == port[None][0] == jax_out[None][0]
