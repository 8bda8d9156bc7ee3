"""Multi-LoRA serving in the port (``models/lora.stack_adapters``, the
per-row bank of ``models/llama.apply_lora_delta``, the engine's
``adapters``) against the JAX package's, f32 on the CPU.

- ``stack_adapters`` equals JAX's bank leaf for leaf (each adapter's scale
  folded into its ``b``; decoder leaves stacked on axis 1, flat ones on 0).
- A bank forward with per-row ``lora_ids`` equals JAX's bank forward within
  1e-5 and, row by row, the port's single-adapter forward; the engine's
  per-row gathered form (``PER_ROW``) equals the bank; a bank without ids
  raises ValueError.
- Mixed-adapter engine streams are token-identical to the JAX engine's with
  the same adapters: a llama on a paged pool with speculation and a prefix
  registered per adapter; LLaVA with images (the projector's adapters); and
  Qwen2-VL with images (the merger's adapters).  The port's mixed streams
  also equal those of engines that each hold one adapter.
- An unknown adapter is a KeyError (submit and register_prefix), a request
  naming another adapter than its prefix's a ValueError, as in JAX.

The weights are drawn by the port (``init_params``, quicker than JAX's init)
and carried across as numpy, and so are the adapters (the port's
``init_model_lora`` with random ``b``).  The JAX engines run with
``pipeline=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.models import qwen2_vl as jqwen
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models import llava as tllava
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.models import qwen2_vl as tqwen
from multimodal_unlearning_tpu_torch.serve import ServingEngine
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path, tree_map

KW = dict(num_slots=3, max_len=192, chunk=3, bucket_multiple=16, pad_token_id=0)
NEW = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adapter(model, seed, r=4):
    """An adapter tree with random ``b`` (init_lora's b = 0 is a no-op), as
    JAX arrays and as the port's tensors."""
    gen = torch.Generator().manual_seed(seed)
    tree = tlora.init_model_lora(model, r, gen)
    tree = tree_map(lambda x: (torch.randn(x.shape, generator=gen) * 0.05 if x.abs().max() == 0
                               else x).detach(), tree)
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree), tree


def _family(name, seed):
    """JAX's and the port's model of a tiny family on the same weights
    (drawn by the port, which is quicker than JAX's init) and two adapters."""
    arch = get_model_identifiers(name).arch
    kind = getattr(arch, "kind", None) or "llama"
    jmod, tmod, ccls = {"llama": (jllama, tllama, "LlamaConfig"),
                        "llava": (jllava, tllava, "LlavaConfig"),
                        "qwen2_vl": (jqwen, tqwen, "QwenVLConfig")}[kind]
    jcfg = getattr(jmod, ccls).from_registry(arch)
    tcfg = getattr(tconfig, ccls).from_registry(arch)
    model = tmod.init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcommon.model_tree(model))
    adapters = {"a1": (*_adapter(model, seed + 1), 2.0), "a2": (*_adapter(model, seed + 2), 0.5)}
    return jcfg, tcfg, params, model, adapters


@pytest.fixture(scope="module")
def llama_setup():
    return _family("tiny-llama-test", 0)


def test_stack_adapters_equals_jax(llama_setup):
    *_, adapters = llama_setup
    (jt1, tt1, s1), (jt2, tt2, s2) = adapters.values()
    want = jlora.stack_adapters([jt1, jt2], [s1, s2])
    got = tlora.stack_adapters([tt1, tt2], [s1, s2])
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, want)))
    got = dict(tree_leaves_with_path(got))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_bank_equals_scalar_lora_and_jax(llama_setup):
    jcfg, tcfg, params, model, adapters = llama_setup
    (jt1, tt1, s1), (jt2, tt2, s2) = adapters.values()
    ids = np.random.default_rng(0).integers(3, jcfg.vocab_size, (3, 10))
    jzero = jax.tree.map(jnp.zeros_like, jt1)
    jbank = jlora.stack_adapters([jzero, jt1, jt2], [0.0, s1, s2])
    rows = np.array([1, 2, 0])
    want = np.asarray(jllama.forward(params, jcfg, jnp.asarray(ids, jnp.int32), lora=jbank,
                                     lora_scale=1.0, lora_ids=jnp.asarray(rows),
                                     compute_dtype=jnp.float32)["logits"])
    tbank = tlora.stack_adapters([tree_map(torch.zeros_like, tt1), tt1, tt2], [0.0, s1, s2])
    ids_t, rows_t = torch.from_numpy(ids), torch.from_numpy(rows)
    with torch.no_grad():
        got = model(ids_t, lora=tbank, lora_scale=1.0, lora_ids=rows_t,
                    compute_dtype=torch.float32)["logits"]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        per_row = tree_map(lambda x: x.index_select(1 if x.ndim == 4 else 0, rows_t), tbank)
        same = model(ids_t, lora=per_row, lora_scale=1.0, lora_ids=tllama.PER_ROW,
                     compute_dtype=torch.float32)["logits"]
        np.testing.assert_array_equal(same.numpy(), got.numpy())
        for row, (tree, scale) in enumerate([(tt1, s1), (tt2, s2), (None, 0.0)]):
            one = model(ids_t[row:row + 1], lora=tree, lora_scale=scale,
                        compute_dtype=torch.float32)["logits"]
            np.testing.assert_allclose(got[row:row + 1].numpy(), one.numpy(), rtol=2e-5,
                                       atol=2e-5)
        with pytest.raises(ValueError, match="lora_ids"):
            model(ids_t, lora=tbank, lora_scale=1.0, compute_dtype=torch.float32)


def _jobs(rng, cfg, lens, image=None, pix=None):
    """(prompt, pixels) per request; every other one with the image."""
    out = []
    for i, n in enumerate(lens):
        text = rng.integers(3, 240, n)
        if i % 3 == 0:  # repetitive text: the 2-gram lookup fires
            text = np.tile(text[:3], -(-n // 3))[:n]
        with_image = image is not None and i % 2 == 0
        out.append(((image if with_image else []) + text.tolist(),
                    pix if with_image else None))
    return out


def _run(eng, jobs, names, prefixes=None):
    reqs = []
    for (prompt, pix), name in zip(jobs, names):
        pre = None if prefixes is None else prefixes[name]
        reqs.append(eng.submit(prompt, NEW, pixel_values=pix, adapter=name, prefix=pre))
    eng.drain(reqs)
    return [r.tokens for r in reqs]


def _engines(jcfg, tcfg, params, model, adapters, kind, **opts):
    jeng = JaxEngine(params, jcfg, kind, cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                     pipeline=False, adapters={k: (j, s) for k, (j, _, s) in adapters.items()},
                     **dict(KW, **opts))
    teng = ServingEngine(model, tcfg, kind, cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu",
                         adapters={k: (t, s) for k, (_, t, s) in adapters.items()},
                         **dict(KW, **opts))
    return jeng, teng


NAMES = [None, "a1", "a2", "a1", None, "a2"]


def test_llama_paged_spec_prefix_equal_jax(llama_setup):
    """A paged pool, speculation, and a system prompt registered per
    adapter (and for the base): mixed streams equal JAX's, and the port's
    equal engines that hold only their request's adapter."""
    jcfg, tcfg, params, model, adapters = llama_setup
    rng = np.random.default_rng(1)
    jobs = _jobs(rng, jcfg, (9, 21, 14, 6, 17, 11))
    system = rng.integers(3, 240, 13).tolist()
    opts = dict(page_size=16, speculate_k=3, spec_ref_len=16)
    jeng, teng = _engines(jcfg, tcfg, params, model, adapters, "llama", **opts)
    jpre = {n: jeng.register_prefix(system, adapter=n) for n in (None, "a1", "a2")}
    tpre = {n: teng.register_prefix(system, adapter=n) for n in (None, "a1", "a2")}
    want = _run(jeng, jobs, NAMES, jpre)
    got = _run(teng, jobs, NAMES, tpre)
    assert got == want
    plain = _run(ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                               compute_dtype=torch.float32, device="cpu",
                               adapters={k: (t, s) for k, (_, t, s) in adapters.items()}, **KW),
                 [(system + p, x) for p, x in jobs], NAMES)
    assert plain == got
    for name in ("a1", "a2", None):
        only = {} if name is None else {name: adapters[name][1:]}
        eng = ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                            compute_dtype=torch.float32, device="cpu", adapters=only, **KW)
        picked = [j for j, n in zip(jobs, NAMES) if n == name]
        solo = _run(eng, [(system + p, x) for p, x in picked], [name] * len(picked))
        assert solo == [g for g, n in zip(got, NAMES) if n == name], name
    # each adapter changes some stream: else the checks above prove nothing
    base = _run(ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                              compute_dtype=torch.float32, device="cpu", **KW),
                [(system + p, x) for p, x in jobs], [None] * len(jobs))
    for name in ("a1", "a2", None):
        differ = [b != g for b, g, n in zip(base, got, NAMES) if n == name]
        assert any(differ) if name else not any(differ), name


@pytest.mark.parametrize("family", ["tiny-llava-test", "tiny-qwen2vl-test"])
def test_vlm_adapters_with_images_equal_jax(family):
    """The projector's (LLaVA) or the merger's (Qwen2-VL) adapters through
    image prompts, dense cache."""
    jcfg, tcfg, params, model, adapters = _family(family, 3)
    rng = np.random.default_rng(4)
    if family == "tiny-llava-test":
        image = [jcfg.image_token_id] * jcfg.num_image_tokens
        pix = rng.standard_normal((jcfg.vision.image_size, jcfg.vision.image_size,
                                   3)).astype(np.float32)
        kind = "llava"
    else:
        g = jcfg.default_grid
        image = ([jcfg.vision_start_token_id] + [jcfg.image_token_id] * jcfg.num_image_tokens
                 + [jcfg.vision_end_token_id])
        pix = rng.standard_normal((g[1] * g[2], jcfg.vision.patch_dim)).astype(np.float32)
        kind = "qwen2_vl"
    jobs = _jobs(rng, jcfg, (7, 12, 9, 5), image, pix)
    jeng, teng = _engines(jcfg, tcfg, params, model, adapters, kind, max_len=256)
    assert _run(teng, jobs, NAMES[:4]) == _run(jeng, jobs, NAMES[:4])


def test_unknown_adapter_and_prefix_mismatch(llama_setup):
    jcfg, tcfg, params, model, adapters = llama_setup
    teng = ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu",
                         adapters={"a1": adapters["a1"][1:]}, **KW)
    with pytest.raises(KeyError):
        teng.submit([5, 6, 7], 4, adapter="nope")
    with pytest.raises(KeyError):
        teng.register_prefix([5, 6, 7], adapter="nope")
    pid = teng.register_prefix([5, 6, 7], adapter="a1")
    with pytest.raises(ValueError, match="prefix"):
        teng.submit([8, 9], 4, prefix=teng.register_prefix([5, 6]), adapter="a1")
    assert teng.submit([8, 9], 4, prefix=pid).lora_id == 1  # the prefix's adapter
