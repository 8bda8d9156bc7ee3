"""The port's ``evaluation/generate.greedy_generate`` against the JAX
package's, f32 on the CPU, the same weights (drawn by the port, as the
JAX tree, and back through ``models/convert.py``).  Token ids must be IDENTICAL for:

- the plain route without an eos, and with an eos (the token row 0 emits
  third on the free run, so that row finishes early and pads after it);
- the speculative route (``speculate_k=4``), without a ``draft_ref`` and
  with one (the free run's own tokens, so drafts are accepted): equal to
  JAX's speculative route and to the port's plain route;
- an int8 KV cache;
- LLaVA prompts with an image (``pixel_values``), plain and speculative.

``do_sample=True`` with speculation raises (``test_torch_sampling.py``
holds the sampled route).  Identity holds because both sides compute in f32
with the same weights; a difference in the last bits of a logit could flip
only an exact tie, which random f32 logits do not produce here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.evaluation import generate as jgen
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli.common import model_tree
from multimodal_unlearning_tpu_torch.evaluation import generate as tgen
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models import llava as tllava

NEW = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(init, tcfg, seed):
    """(JAX tree, port model) of the same weights: drawn by the port (a JAX
    init costs a compile per leaf), taken as the JAX tree in numpy, and
    carried back into a port model by ``models/convert.py``."""
    tree = jax.tree.map(lambda t: t.numpy(),
                        model_tree(init(tcfg, torch.Generator().manual_seed(seed), device="cpu")))
    return jax.tree.map(jnp.asarray, tree), convert.from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def llama_setup():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    params, model = _weights(tllama.init_params, tcfg, 0)
    rng = np.random.default_rng(0)
    prompts = []
    for i, n in enumerate((24, 9, 31)):
        p = rng.integers(3, jcfg.vocab_size, n)
        if i != 1:  # repetitive prompts: the 2-gram lookup fires
            p = np.tile(p[:3], -(-n // 3))[:n]
        prompts.append(p.tolist())
    ids, mask = tgen.pad_prompts(prompts, 0)
    return jcfg, params, tcfg, model, ids, mask


def _both(jparams, jcfg, model, tcfg, ids, mask, *, is_vlm=False, pix=None, cache="f32",
          **kw):
    """(JAX ids, port ids, port stats) of one greedy_generate call."""
    want = jgen.greedy_generate(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=NEW, pad_token_id=0,
        pixel_values=None if pix is None else jnp.asarray(pix), is_vlm=is_vlm,
        cache_dtype=jnp.int8 if cache == "int8" else jnp.float32,
        compute_dtype=jnp.float32, **kw)
    got, stats = tgen.greedy_generate(
        model, tcfg, ids, mask, max_new_tokens=NEW, pad_token_id=0, pixel_values=pix,
        is_vlm=is_vlm, cache_dtype=torch.int8 if cache == "int8" else torch.float32,
        compute_dtype=torch.float32, return_stats=True, **kw)
    return np.asarray(want), got.numpy(), stats


@pytest.fixture(scope="module")
def free_run(llama_setup):
    jcfg, params, tcfg, model, ids, mask = llama_setup
    want, got, stats = _both(params, jcfg, model, tcfg, ids, mask)
    return want, got, stats


def test_plain_matches_jax(free_run):
    want, got, stats = free_run
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, NEW) and stats["forwards"] == NEW - 1


def test_plain_eos_pads_after_it(llama_setup, free_run):
    jcfg, params, tcfg, model, ids, mask = llama_setup
    eos = int(free_run[1][0, 2])
    want, got, _ = _both(params, jcfg, model, tcfg, ids, mask, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    row = got[0].tolist()
    stop = row.index(0)
    assert stop <= 2 and set(row[stop:]) == {0} and eos not in row


@pytest.mark.parametrize("case", ["spec_eos", "spec_draft"])
def test_speculative_matches_jax_and_plain(llama_setup, free_run, case):
    jcfg, params, tcfg, model, ids, mask = llama_setup
    kw = dict(speculate_k=4)
    if case == "spec_eos":
        kw["eos_token_id"] = int(free_run[1][0, 2])
        plain = _both(params, jcfg, model, tcfg, ids, mask, eos_token_id=kw["eos_token_id"])[1]
    else:
        # the free run's own tokens as the lookup corpus: drafts are accepted
        kw["draft_ref"] = free_run[1]
        plain = free_run[1]
    want, got, stats = _both(params, jcfg, model, tcfg, ids, mask, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    if case == "spec_draft":
        # every row emitted its NEW tokens in fewer verify rounds than the
        # plain route's NEW - 1 steps (the loop stops at the first look at
        # ``finished`` after the last row is done)
        assert stats["forwards"] < NEW - 1


def test_int8_cache_matches_jax(llama_setup):
    jcfg, params, tcfg, model, ids, mask = llama_setup
    want, got, _ = _both(params, jcfg, model, tcfg, ids, mask, cache="int8")
    np.testing.assert_array_equal(got, want)


def test_image_prompts_match_jax():
    arch = get_model_identifiers("tiny-llava-test").arch
    jcfg = jllava.LlavaConfig.from_registry(arch)
    tcfg = tconfig.LlavaConfig.from_registry(arch)
    params, model = _weights(tllava.init_params, tcfg, 2)
    rng = np.random.default_rng(3)
    n_img = jcfg.num_image_tokens
    prompts = []
    for n in (20, 7):
        p = rng.integers(3, 250, n).tolist()
        prompts.append(p[:2] + [jcfg.image_token_id] * n_img + p[2:])
    ids, mask = tgen.pad_prompts(prompts, 0)
    pix = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want, got, _ = _both(params, jcfg, model, tcfg, ids, mask, is_vlm=True, pix=pix)
    np.testing.assert_array_equal(got, want)
    spec = tgen.greedy_generate(model, tcfg, ids, mask, max_new_tokens=NEW, pad_token_id=0,
                                pixel_values=pix, is_vlm=True, cache_dtype=torch.float32,
                                compute_dtype=torch.float32, speculate_k=4, draft_ref=got)
    np.testing.assert_array_equal(spec.numpy(), want)


def test_sampling_and_mesh_raise(llama_setup):
    """Sampling with speculation raises as in the JAX package (the verify
    round checks drafts against the argmax); mesh is not ported."""
    _, _, tcfg, model, ids, mask = llama_setup
    with pytest.raises(ValueError, match="speculate_k"):
        tgen.greedy_generate(model, tcfg, ids, mask, max_new_tokens=2, pad_token_id=0,
                             do_sample=True, speculate_k=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        tgen.greedy_generate(model, tcfg, ids, mask, max_new_tokens=2, pad_token_id=0,
                             mesh=object())
