"""Qwen2-VL and Qwen2.5-VL in the port (CPU, f32) against the JAX package on
the same weights and inputs: the vision tower (both versions, uniform and
ragged windows), the window partition, the M-RoPE positions and rope delta,
``mrope_select``, the whole forward (with and without pixels, and decode
steps continuing from the prefill's rope delta) and the configurations.
The HF bridge, the processor, the quantized routes and the merger's LoRA
merge are in ``test_torch_qwen2_vl_io.py``.

The weights are drawn by the port and cross as numpy through
``models/convert.py``; the biases and norm scales, zero and one at init,
get random values first, so that each one matters.

Tolerances: the tower's output and the logits to 1e-4 absolute (f32, the
same operations in another order; measured ~1e-6); positions, rope deltas,
window partitions and ``mrope_select`` exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import qwen2_vl as jqwen
from multimodal_unlearning_tpu.ops import rope as jrope
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models import qwen2_vl as tqwen
from multimodal_unlearning_tpu_torch.ops import rope as trope

FAMILIES = ["tiny-qwen2vl-test", "tiny-qwen25vl-test"]
IDS = ["qwen2vl", "qwen25vl"]
# Qwen2.5's tower at 24 px with patch 4: a 3x3 grid of merge units under
# windows of 2x2 units -> windows of 4, 2, 2 and 1 units (ragged)
RAGGED = dict(embed_dim=32, depth=2, num_heads=2, out_hidden_size=64, patch_size=4,
              version="2.5", intermediate_size=48, window_size=16,
              fullatt_block_indexes=(1,), image_size=24)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX forward compiled once per input structure (eager, each of its ops
# compiles on its own, several times slower here)
JFWD = jax.jit(jqwen.forward, static_argnames=("cfg", "compute_dtype", "last_logit_only"))


def _cfgs(family):
    arch = get_model_identifiers(family).arch
    return jqwen.QwenVLConfig.from_registry(arch), tconfig.QwenVLConfig.from_registry(arch)


def _perturbed(tree, seed):
    """Biases and norm scales get random values (zero and one at init)."""
    rng = np.random.default_rng(seed)

    def pert(path, x):
        name = str(path[-1].key)
        if name.endswith("bias") or name == "scale":
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(pert, tree)


def _weights(module, seed):
    """(JAX tree as jnp, port model) of one set of weights."""
    tree = _perturbed(jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(module)), seed)
    return tree


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, family in enumerate(FAMILIES):
        jcfg, tcfg = _cfgs(family)
        tree = _weights(tqwen.init_params(tcfg, torch.Generator().manual_seed(i), device="cpu"),
                        i)
        out[family] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                       convert.from_jax(tree, tcfg, device="cpu"))
    return out


def _pixels(cfg, B, seed):
    g = cfg.default_grid
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, g[0] * g[1] * g[2], cfg.vision.patch_dim)).astype(np.float32)


def _tower(case, models):
    if case == "ragged":
        jv, tv = jqwen.QwenVisionConfig(**RAGGED), tconfig.QwenVisionConfig(**RAGGED)
        tree = _weights(tqwen.QwenVisionTower(tv, device="cpu").init_params(
            torch.Generator().manual_seed(5)), 5)
        return jv, tv, jax.tree.map(jnp.asarray, tree), convert.from_jax(tree, tv, device="cpu")
    jcfg, tcfg, jp, model = models[case]
    return jcfg.vision, tcfg.vision, jp["vision_tower"], model.vision_tower


@pytest.mark.parametrize("case", FAMILIES + ["ragged"], ids=IDS + ["qwen25vl_ragged"])
def test_vision_forward_matches_jax(models, case):
    jv, tv, jp, tower = _tower(case, models)
    g = tv.image_size // tv.patch_size
    grid = (1, g, g)
    if case != "tiny-qwen2vl-test":
        assert _window_partition_uniform(tv, grid) == (case != "ragged")
    pix = np.random.default_rng(3).standard_normal((2, g * g, tv.patch_dim)).astype(np.float32)
    want = jqwen.vision_forward(jp, jv, jnp.asarray(pix), grid=grid, compute_dtype=jnp.float32)
    with torch.no_grad():
        got = tqwen.vision_forward(tower, tv, torch.from_numpy(pix), grid=grid,
                                   compute_dtype=torch.float32)
    assert got.shape == want.shape == (2, g * g // 4, tv.out_hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _window_partition_uniform(cfg, grid):
    return tqwen._window_partition(cfg, grid)[-1]


@pytest.mark.parametrize("grid", [(1, 8, 8), (1, 6, 6), (2, 6, 10)], ids=["uniform", "ragged",
                                                                       "two_frames"])
def test_window_partition_matches_jax(grid):
    jv, tv = jqwen.QwenVisionConfig(**RAGGED), tconfig.QwenVisionConfig(**RAGGED)
    want = jqwen._window_partition(jv, grid)
    got = tqwen._window_partition(tv, grid)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)
    assert got[-1] == want[-1] == (grid == (1, 8, 8))


def _prompts(cfg, with_image, left_pad):
    rng = np.random.default_rng(11)
    n = cfg.num_image_tokens
    ids = rng.integers(3, 200, (3, n + 14)).astype(np.int32)
    mask = np.ones_like(ids)
    if with_image:
        ids[0, 3:3 + n] = cfg.image_token_id
        ids[2, 6:6 + n] = cfg.image_token_id
    if left_pad:
        mask[1, :5] = 0
        mask[2, :2] = 0
        ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "text"])
@pytest.mark.parametrize("family", FAMILIES, ids=IDS)
def test_mrope_positions_match_jax(family, with_image):
    jcfg, tcfg = _cfgs(family)
    ms = jcfg.vision.spatial_merge_size
    g = jcfg.default_grid
    gm = (g[0], g[1] // ms, g[2] // ms)
    ids, mask = _prompts(jcfg, with_image, left_pad=True)
    jpos, jdelta = jqwen.mrope_positions(jnp.asarray(ids), jnp.asarray(mask),
                                         jcfg.image_token_id, gm)
    tpos, tdelta = tqwen.mrope_positions(torch.from_numpy(ids), torch.from_numpy(mask),
                                         tcfg.image_token_id, gm)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tdelta.numpy(), np.asarray(jdelta))
    assert (tdelta.numpy()[[0, 2]] != 0).all() == with_image


def test_mrope_select_matches_jax():
    """The selection is exact on the same tables (the two packages' cos and
    sin tables differ in an ulp here and there: the CPU's libm)."""
    head_dim, section = 16, (2, 3, 3)
    jcos, jsin = jrope.rope_table(64, head_dim)
    tcos, tsin = torch.from_numpy(np.array(jcos)), torch.from_numpy(np.array(jsin))
    pos = np.random.default_rng(2).integers(0, 64, (3, 2, 9))
    want = jrope.mrope_select(jcos, jsin, jnp.asarray(pos), section, head_dim)
    got = trope.mrope_select(tcos, tsin, torch.from_numpy(pos), section, head_dim)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "text"])
@pytest.mark.parametrize("family", FAMILIES, ids=IDS)
def test_forward_matches_jax(models, family, with_image):
    """Teacher-forced logits and rope deltas, left-padded rows."""
    jcfg, tcfg, jp, model = models[family]
    ids, mask = _prompts(jcfg, with_image, left_pad=True)
    pix = _pixels(jcfg, 3, 4) if with_image else None
    want = JFWD(jp, cfg=jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                pixel_values=None if pix is None else jnp.asarray(pix),
                compute_dtype=jnp.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                    pixel_values=None if pix is None else torch.from_numpy(pix),
                    compute_dtype=torch.float32)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(got["rope_delta"].numpy(), np.asarray(want["rope_delta"]))


@pytest.mark.parametrize("family", FAMILIES, ids=IDS)
def test_decode_continues_from_the_rope_delta(models, family):
    """A prefill of image prompts into a cache, then two decode steps at
    2-D positions that continue from the prefill's rope delta."""
    jcfg, tcfg, jp, model = models[family]
    ids, mask = _prompts(jcfg, True, left_pad=True)
    pix = _pixels(jcfg, 3, 4)
    B, S = ids.shape
    smax = S + 8
    valid = np.zeros((B, smax), np.int32)
    valid[:, :S] = mask
    jcache = jllama.init_kv_cache(jcfg.decoder, B, smax, dtype=jnp.float32)
    tcache = tllama.init_kv_cache(tcfg.decoder, B, smax, dtype=torch.float32, device="cpu")
    jo = JFWD(jp, cfg=jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
              pixel_values=jnp.asarray(pix), kv_cache=jcache, kv_valid_mask=jnp.asarray(valid),
              compute_dtype=jnp.float32, last_logit_only=True)
    with torch.no_grad():
        to = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                   pixel_values=torch.from_numpy(pix), kv_cache=tcache,
                   kv_valid_mask=torch.from_numpy(valid), compute_dtype=torch.float32,
                   last_logit_only=True)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), atol=1e-4, rtol=0)
    jcache, delta, tdelta = jo["kv_cache"], jo["rope_delta"], to["rope_delta"]
    assert (tdelta.numpy()[[0, 2]] < 0).all()  # 4 or 16 image tokens span 2 or 4 positions
    plen = mask.sum(axis=1)
    tok = np.argmax(np.asarray(jo["logits"])[:, -1], axis=-1).astype(np.int32)
    for t in range(2):
        valid[:, S + t] = 1
        pos = (plen + t)[:, None].astype(np.int32)
        jd = JFWD(jp, cfg=jcfg, input_ids=jnp.asarray(tok[:, None]), positions=jnp.asarray(pos),
                  rope_delta=delta, kv_cache=jcache, cache_offset=jnp.int32(S + t),
                  kv_valid_mask=jnp.asarray(valid), compute_dtype=jnp.float32,
                  attention_mask=jnp.ones((B, 1), jnp.int32))
        with torch.no_grad():
            td = model(torch.from_numpy(tok[:, None]).long(),
                       positions=torch.from_numpy(pos) + tdelta[:, None], kv_cache=tcache,
                       cache_offset=S + t,
                       kv_valid_mask=torch.from_numpy(valid), compute_dtype=torch.float32,
                       attention_mask=torch.ones((B, 1), dtype=torch.int32))
        np.testing.assert_allclose(td["logits"].numpy(), np.asarray(jd["logits"]), atol=1e-4,
                                   rtol=0, err_msg=f"decode step {t}")
        jcache = jd["kv_cache"]
        tok = np.argmax(np.asarray(jd["logits"])[:, -1], axis=-1).astype(np.int32)


def test_config_fields_match_jax():
    for family in FAMILIES + ["qwen-vl2-2b", "qwen-vl-3b"]:
        jcfg, tcfg = _cfgs(family)
        assert dataclasses.asdict(tcfg.vision) == dataclasses.asdict(jcfg.vision)
        jd = dataclasses.asdict(jcfg.decoder)
        assert {k: jd[k] for k in dataclasses.asdict(tcfg.decoder)} == dataclasses.asdict(
            tcfg.decoder)
        assert tcfg.num_image_tokens == jcfg.num_image_tokens
        assert tcfg.default_grid == jcfg.default_grid
