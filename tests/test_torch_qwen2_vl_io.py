"""Qwen2-VL's edges in the port (CPU, f32) against the JAX package: the HF
bridge both ways (both tower versions, the tied ``lm_head``), the
processor's qwen path (patches, resizing, collation with the vision wrap),
the JAX package's image-placeholder fault on the full-size families, and
the decoder's q/k/v biases on every projection route (dense, W8A16, W8A8
with LoRA and the int8 dx, int4) at M-RoPE positions, and the LoRA merge
of the merger's adapters inside the tower.

Tolerances: token ids, labels and the HF tensors exactly; patches to 1e-6
(the same f32 arithmetic, PIL's 8-bit resize on both sides); logits of the
dense, W8A16 and int4 routes to 1e-4 absolute (f32, another summation
order); W8A8 re-quantizes activations per row, where a rounding can flip on
f32 roundoff: logits to 1e-2 absolute and the adapters' gradients under
the int8 dx to a cosine of at least 0.999; the merged tree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.data import processor as jproc
from multimodal_unlearning_tpu.models import hf_bridge as jhf
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.models import qwen2_vl as jqwen
from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.data import processor as tproc
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import hf_bridge as thf
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.models import qwen2_vl as tqwen
from multimodal_unlearning_tpu_torch.utils import quantize as tq

FAMILIES = ["tiny-qwen2vl-test", "tiny-qwen25vl-test"]
IDS = ["qwen2vl", "qwen25vl"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed):
    """Biases and norm scales get random values (zero and one at init)."""
    rng = np.random.default_rng(seed)

    def pert(path, x):
        name = str(path[-1].key)
        if name.endswith("bias") or name == "scale":
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(pert, tree)


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, family in enumerate(FAMILIES):
        arch = get_model_identifiers(family).arch
        jcfg = jqwen.QwenVLConfig.from_registry(arch)
        tcfg = tconfig.QwenVLConfig.from_registry(arch)
        tree = _perturbed(jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(
            tqwen.init_params(tcfg, torch.Generator().manual_seed(i), device="cpu"))), i)
        out[family] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                       convert.from_jax(tree, tcfg, device="cpu"))
    return out


@pytest.mark.parametrize("family", FAMILIES, ids=IDS)
def test_hf_bridge_both_ways(models, family):
    jcfg, tcfg, jp, model = models[family]
    tree = tcommon.model_tree(model)
    want = jhf.qwen2vl_to_hf(jax.tree.map(np.asarray, jp))
    got = thf.qwen2vl_to_hf(tree)
    assert got.keys() == want.keys()
    assert any(k.endswith("self_attn.q_proj.bias") for k in got)
    assert "lm_head.weight" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # back from the JAX package's state dict, and the JAX reader on the port's
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in want.items()}
    back = thf.qwen2vl_from_hf(sd, jcfg.decoder.num_layers, jcfg.vision.depth)
    jback = jhf.qwen2vl_from_hf({k: v.numpy() for k, v in got.items()},
                                jcfg.decoder.num_layers, jcfg.vision.depth)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jback)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0])
    assert flat_t.keys() == flat_j.keys() == flat_w.keys()
    for k, w in flat_w.items():
        np.testing.assert_array_equal(flat_t[k].numpy(), w, err_msg=str(k))
        np.testing.assert_array_equal(flat_j[k], w, err_msg=str(k))
    # a tied lm_head (Qwen2-VL-2B's) falls back to the embedding table
    del sd["lm_head.weight"]
    tied = thf.qwen2vl_from_hf(sd, jcfg.decoder.num_layers, jcfg.vision.depth)
    np.testing.assert_array_equal(tied["language_model"]["lm_head"].numpy(),
                                  np.asarray(jp["language_model"]["embed_tokens"]).T)


@pytest.mark.parametrize("family", ["qwen-vl2-2b", "qwen-vl-3b"])
def test_jax_image_placeholder_fault(family):
    """The JAX package's qwen template writes a literal ``<image>``, which
    the byte tokenizer of the full-size families (image token
    ``<|image_pad|>``) encodes as bytes: no image token, no vision start or
    end, and the image features are never spliced in.  The port writes the
    tokenizer's placeholder: 144 image tokens (336 px, 24x24 patches merged
    2x2) between vision start and vision end."""
    sample = {"question": "Who is this?", "answer": "A person.",
              "image": np.zeros((32, 32, 3), np.uint8)}
    arch = get_model_identifiers(family).arch
    img, vs, ve = (int(arch[k]) for k in ("image_token_id", "vision_start_token_id",
                                          "vision_end_token_id"))
    jids = np.asarray(jcommon.build_processor(get_model_identifiers(family), {}).encode_sample(
        sample, 4096)[0])
    assert (jids == img).sum() == (jids == vs).sum() == (jids == ve).sum() == 0
    tp = tcommon.build_processor(get_model_identifiers(family), {})
    tids = np.asarray(tp.encode_sample(sample, 4096)[0])
    assert (tids == img).sum() == 144
    start = int(np.flatnonzero(tids == vs)[0])
    assert (tids == vs).sum() == (tids == ve).sum() == 1
    assert (tids[start + 1:start + 145] == img).all() and tids[start + 145] == ve
    batch = tp.collate([sample], 4096)
    assert batch["pixel_values"].shape == (1, 576, 1176)


@pytest.mark.parametrize("family", FAMILIES, ids=IDS)
def test_processor_matches_jax(family):
    jp = jcommon.build_processor(get_model_identifiers(family), {})
    tp = tcommon.build_processor(get_model_identifiers(family), {})
    size = tp.image_size
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8),   # at the resolution
              rng.integers(0, 256, (40, 56, 3), dtype=np.uint8),       # resized by PIL
              rng.random((size, size, 3)).astype(np.float32)]          # floats, not resized
    for img in images:
        np.testing.assert_allclose(tp.preprocess(img), jproc.preprocess_image_qwen(
            img, size, jp.patch_size, jp.spatial_merge_size), atol=1e-6, rtol=0)
    arr = rng.standard_normal((size, size, 3)).astype(np.float32)
    np.testing.assert_array_equal(tproc.qwen_patchify(arr, tp.patch_size),
                                  jproc.qwen_patchify(arr, jp.patch_size))
    assert tproc.smart_resize(40, 56) == jproc.smart_resize(40, 56)
    assert tproc.smart_resize(3000, 1000) == jproc.smart_resize(3000, 1000)
    samples = [{"question": "Who?", "answer": "Someone here.", "image": images[0]},
               {"question": "What is it called?", "answer": "A thing.", "image": None},
               {"question": "Where?", "answer": "There.", "image": images[1]}]
    for side in ("left", "right"):
        jp.padding_side = tp.padding_side = side
        want = jp.collate(samples, 256, return_answers=True)
        got = tp.collate(samples, 256, return_answers=True)
        assert got.keys() == want.keys()
        for k in want:
            if k == "pixel_values":
                np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_processor_refuses_an_unknown_vision_mode():
    with pytest.raises(NotImplementedError, match="vision_mode"):
        tproc.MMProcessor(tcommon.build_processor(get_model_identifiers(FAMILIES[0]),
                                                  {}).tokenizer, vision_mode="siglip")


WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2, qkv_bias=True, mrope_section=[8, 12, 12])


@pytest.fixture(scope="module")
def wide_qwen2():
    """A 256-wide Qwen2 decoder (q/k/v biases), as numpy, and LoRA adapters
    with nonzero b."""
    arch = dict(get_model_identifiers("tiny-qwen2vl-test").arch.to_dict()["decoder"], **WIDE)
    jcfg = jllama.LlamaConfig.from_registry(arch)
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    assert tcfg.qkv_bias and tcfg.mrope_section == (8, 12, 12)
    tree = _perturbed(jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(
        tllama.init_params(tcfg, torch.Generator().manual_seed(7), device="cpu"))), 7)
    rng = np.random.default_rng(7)
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        if p[-1].key == "b" else np.asarray(x),
        jlora.init_model_lora(tree, 4, jax.random.PRNGKey(7)))
    return jcfg, tcfg, tree, adapters


@pytest.fixture
def int8_flags_off():
    yield
    jllama.enable_int8_compute(False)
    jq.enable_int8_bwd(False)
    tllama.enable_int8_compute(False)
    tq.enable_int8_bwd(False)


@pytest.mark.parametrize("route", ["dense", "w8a16", "w8a8", "int4"])
def test_qkv_bias_on_every_projection_route(wide_qwen2, route, int8_flags_off):
    """The bias lands after the product's rescale and the LoRA delta, never
    quantized; logits (and, under W8A8 with the int8 dx, the adapters'
    gradients) against the JAX package at M-RoPE positions."""
    jcfg, tcfg, tree, adapters = wide_qwen2
    spec = {"dense": None, "w8a16": "int8", "w8a8": "int8", "int4": "int4"}[route]
    jparams = jax.tree.map(jnp.asarray, tree)
    if spec:
        jparams = jcommon.quantize_base_params(jparams, "llama", spec)
    model = convert.from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert isinstance(model.layers.q_bias, torch.nn.Parameter)
    if route == "w8a8":
        for mod, qmod in ((jllama, jq), (tllama, tq)):
            mod.enable_int8_compute(True)
            qmod.enable_int8_bwd(True)
    lora = route != "int4"  # LoRA over an int4 base is a later slice
    rng = np.random.default_rng(8)
    ids = rng.integers(3, 500, (2, 13)).astype(np.int32)
    pos = np.stack([np.arange(13)] * 3)[:, None].repeat(2, 1)
    pos[1:, :, 4:8] = rng.integers(0, 6, (2, 2, 4))  # an image-like span

    def jloss(ad):
        out = jllama.forward(jparams, jcfg, jnp.asarray(ids), positions=jnp.asarray(pos),
                             compute_dtype=jnp.float32, lora=ad if lora else None,
                             lora_scale=2.0)["logits"]
        return jnp.sum(out * jnp.cos(jnp.arange(out.shape[-1]))), out

    tad = convert.adapters_from_jax(adapters, device="cpu") if lora else None
    tout = model(torch.from_numpy(ids).long(), positions=torch.from_numpy(pos),
                 compute_dtype=torch.float32, lora=tad, lora_scale=2.0)["logits"]
    if route != "w8a8":
        (_, want) = jloss(jax.tree.map(jnp.asarray, adapters))
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
        return
    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, adapters))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(want), atol=1e-2, rtol=0)
    (tout * torch.cos(torch.arange(tout.shape[-1]).float())).sum().backward()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jgrad)[0]:
        t = tad
        for k in path:
            t = t[k.key]
        g, w = t.grad.numpy().ravel(), np.asarray(leaf).ravel()
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert cos > 0.999, (path, cos)


def test_merge_model_folds_the_merger_adapters(models):
    """LoRA on the merger (inside the tower) merges there, as the JAX
    package's ``merge_model`` does; the decoder's adapters as before."""
    jcfg, tcfg, jp, model = models["tiny-qwen2vl-test"]
    rng = np.random.default_rng(10)
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        if p[-1].key == "b" else np.asarray(x),
        jlora.init_model_lora(jp, 4, jax.random.PRNGKey(3)))
    assert set(adapters) == {"language_model", "projector"}
    assert set(tlora.init_model_lora(model, 4, torch.Generator().manual_seed(0))) == set(
        adapters)
    want = jlora.merge_model(jp, jax.tree.map(jnp.asarray, adapters), 4.0)
    got = tlora.merge_model(model, convert.adapters_from_jax(adapters, device="cpu"), 4.0)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k].numpy(), np.asarray(w), atol=1e-6, rtol=0,
                                   err_msg=str(k))
    merged_fc1 = flat_g[tuple(jax.tree_util.DictKey(k) for k in
                              ("vision_tower", "merger", "fc1"))].numpy()
    assert not np.allclose(merged_fc1, np.asarray(jp["vision_tower"]["merger"]["fc1"]))
