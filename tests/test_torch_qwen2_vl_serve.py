"""Qwen2-VL's serving engine in the port against the JAX package's (CPU,
f32, ``tiny-qwen2vl-test``; the same weights, drawn by the port, its biases
given random values, and carried across as numpy; the JAX engine runs with
``pipeline=False``): speculation; chunked prefill (the image in the first
chunk, text chunks after it); a registered prefix holding the image (text
suffixes continue at the prefix's M-RoPE delta).  Plain one-token decode
follows every prefill in the last two, and the chunked run's streams are
also held equal to the port's plain engine, the prefix run's to the full
prompts through it.  ``greedy_generate`` and ``cli/serve.py`` are in
``test_torch_qwen2_vl_generate.py``.

Token streams must be IDENTICAL: both sides compute in f32 with the same
weights, and only an exact tie of random logits could flip a token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import qwen2_vl as jqwen
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import qwen2_vl as tqwen
from multimodal_unlearning_tpu_torch.serve import ServingEngine

FAMILY = "tiny-qwen2vl-test"
NEW = 10
KW = dict(num_slots=2, max_len=192, chunk=3, bucket_multiple=16, pad_token_id=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    arch = get_model_identifiers(FAMILY).arch
    jcfg, tcfg = jqwen.QwenVLConfig.from_registry(arch), tconfig.QwenVLConfig.from_registry(arch)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(
        tqwen.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if str(p[-1].key).endswith("bias") else x, tree)
    g = jcfg.default_grid
    n_img = jcfg.num_image_tokens
    pix = rng.standard_normal((g[1] * g[2], jcfg.vision.patch_dim)).astype(np.float32)
    image = ([jcfg.vision_start_token_id] + [jcfg.image_token_id] * n_img
             + [jcfg.vision_end_token_id])
    prompts = []
    for i, n in enumerate((9, 21, 14)):
        text = rng.integers(3, 240, n)
        if i != 1:  # repetitive text: the 2-gram lookup fires
            text = np.tile(text[:3], -(-n // 3))[:n]
        prompts.append(([1] + image + text.tolist()) if i != 1 else [1] + text.tolist())
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), convert.from_jax(tree, tcfg, device="cpu"),
            pix, prompts, image)


def _streams(eng, jobs, prefix=None):
    reqs = [eng.submit(p, n, pixel_values=x, prefix=prefix) for p, n, x in jobs]
    eng.drain(reqs)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("opts", [dict(speculate_k=3, spec_ref_len=16), dict(prefill_chunk=32)],
                         ids=["spec", "chunked"])
def test_engine_streams_match_jax(setup, opts):
    jcfg, tcfg, jp, model, pix, prompts, image = setup
    jobs = [(p, NEW, pix if jcfg.image_token_id in p else None) for p in prompts]
    if opts.get("prefill_chunk"):  # text past the first chunk, the image inside it
        rng = np.random.default_rng(3)
        jobs.append(([1] + image + rng.integers(3, 240, 70).tolist(), NEW, pix))
    jeng = JaxEngine(jp, jcfg, "qwen2_vl", cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                     pipeline=False, **KW, **opts)
    teng = ServingEngine(model, tcfg, "qwen2_vl", cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu", **KW, **opts)
    got = _streams(teng, jobs)
    assert got == _streams(jeng, jobs)
    assert [len(t) for t in got] == [NEW] * len(jobs)
    if opts.get("prefill_chunk"):
        assert teng.stats()["prefill_chunks"] == jeng.stats()["prefill_chunks"] >= 2
        # and the same as the port's monolithic prefill
        plain = ServingEngine(model, tcfg, "qwen2_vl", cache_dtype=torch.float32,
                              compute_dtype=torch.float32, device="cpu", **KW)
        assert _streams(plain, jobs) == got
    if opts.get("speculate_k"):
        assert teng.stats()["tokens_per_round"] == pytest.approx(jeng.stats()["tokens_per_round"])


def test_prefix_with_an_image_matches_jax(setup):
    """A registered prefix holding the image: text suffixes continue at the
    prefix's rope delta; the streams equal the JAX engine's and the full
    prompts' on the port's plain engine."""
    jcfg, tcfg, jp, model, pix, prompts, image = setup
    preamble = [1] + image + [40, 41, 42]
    suffixes = [p[len(image) + 1:] if image[1] in p else p[1:] for p in prompts]  # text only
    jeng = JaxEngine(jp, jcfg, "qwen2_vl", cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                     pipeline=False, **KW)
    teng = ServingEngine(model, tcfg, "qwen2_vl", cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu", **KW)
    jobs = [(s, NEW, None) for s in suffixes]
    got = _streams(teng, jobs, prefix=teng.register_prefix(preamble, pixel_values=pix))
    assert got == _streams(jeng, jobs, prefix=jeng.register_prefix(preamble, pixel_values=pix))
    full = ServingEngine(model, tcfg, "qwen2_vl", cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu", **KW)
    assert _streams(full, [(preamble + s, NEW, pix) for s in suffixes]) == got
