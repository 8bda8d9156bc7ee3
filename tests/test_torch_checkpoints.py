"""Checkpoints across the two packages (CPU): HF-layout models, raw adapters
and quantized checkpoints written by either package and read by the other,
each loaded tensor becoming the model's own parameter (no second copy);
``merge_model`` against the JAX package's.

Tolerances.  Files: exact (the same bytes).  ``merge_model`` in f32: 1e-6
absolute and relative (the fold's [in, r] x [r, out] product is summed in
another order by the two libraries; weights and deltas are O(0.1-1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load, save_file as np_save

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.config.registry import get_model_identifiers as jget
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.train import checkpoints as jckpt
from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.train import checkpoints as tckpt
from multimodal_unlearning_tpu_torch.utils.quantize import QTensor, QTensor4

FAMILY = "tiny-llava-test"
WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree.float() if isinstance(tree, torch.Tensor)
                                         and tree.dtype == torch.bfloat16 else tree)}


def _jax_model(seed=0):
    return jcommon.init_or_load_params(jget(FAMILY), None, seed=seed, dtype=jnp.float32)[2]


def _wide_entry():
    entry = get_model_identifiers(FAMILY).to_dict()
    entry["arch"]["decoder"] = dict(entry["arch"]["decoder"], **WIDE)
    entry["arch"]["image_token_id"] = 500
    return entry


def test_hf_checkpoints_cross_both_ways(tmp_path):
    jparams = _jax_model()
    jcommon.save_model(tmp_path / "jax", jget(FAMILY), jparams)
    _, mcfg, model = tcommon.init_or_load_params(get_model_identifiers(FAMILY),
                                                 str(tmp_path / "jax"), dtype=torch.float32,
                                                 device="cpu")
    want = convert.from_jax(jax.tree.map(np.asarray, jparams), mcfg, device="cpu")
    for (n, p), (m, q) in zip(model.named_parameters(), want.named_parameters()):
        assert n == m and torch.equal(p, q), n

    tcommon.save_model(tmp_path / "port", get_model_identifiers(FAMILY), model)
    a, b = np_load(str(tmp_path / "port/model.safetensors")), \
        np_load(str(tmp_path / "jax/model.safetensors"))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    _, _, back = jcommon.init_or_load_params(jget(FAMILY), str(tmp_path / "port"),
                                             dtype=jnp.float32)
    got, ref = _flat(jax.tree.map(np.asarray, back)), _flat(tcommon.model_tree(model))
    assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in got)


def test_adapters_cross_both_ways(tmp_path):
    adapters = jlora.init_model_lora(_jax_model(), 4, jax.random.PRNGKey(1))
    jckpt.save_adapter(tmp_path / "jax", adapters, 8.0, meta={"forget_loss": "x"})
    tree, scale = tckpt.load_adapter(tmp_path / "jax")
    assert scale == 8.0
    want = _flat(jax.tree.map(np.asarray, adapters))
    assert _flat(tree).keys() == want.keys()
    assert all(np.array_equal(_flat(tree)[k], want[k]) for k in want)
    tckpt.save_adapter(tmp_path / "port", tree, 2.0)
    back, scale = jckpt.load_adapter(tmp_path / "port")
    assert scale == 2.0
    assert all(np.array_equal(_flat(jax.tree.map(np.asarray, back))[k], want[k]) for k in want)


@pytest.mark.parametrize("fmt", ["hf", "int8"])
def test_a_checkpoint_loads_into_a_model_without_storage(tmp_path, monkeypatch, fmt):
    """``init_or_load_params`` builds its model on the meta device only (no
    dense model beside the loaded tensors, none for a quantized file
    either), and what it returns holds real tensors throughout."""
    from multimodal_unlearning_tpu.models import llava as jllava
    from multimodal_unlearning_tpu_torch.models import llava as tllava

    entry = _wide_entry()
    params = jllava.init_params(jllava.LlavaConfig.from_registry(entry["arch"]),
                                jax.random.PRNGKey(0))
    if fmt == "hf":
        jcommon.save_model(tmp_path, entry, params)
    else:
        params["language_model"] = jq.quantize_tree(params["language_model"])
        jckpt.save_quantized_checkpoint(tmp_path, params, meta={"bits": "int8"})
    built = []
    init = tllava.Llava.__init__
    monkeypatch.setattr(tllava.Llava, "__init__", lambda self, cfg, *, device=None, **kw: (
        built.append(str(device)), init(self, cfg, device=device, **kw))[1])
    _, _, model = tcommon.init_or_load_params(entry, str(tmp_path), dtype=torch.float32,
                                              device="cpu")
    assert built == ["meta"]
    tensors = list(model.parameters()) + list(model.buffers())
    assert {t.device.type for t in tensors} == {"cpu"}
    assert all(t.is_contiguous() or t.dtype == torch.int8 for t in tensors)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_from_jax_takes_tensors_on_the_device_as_they_are(quantized):
    """A tree of tensors already on the device in the model's dtype (a
    loaded checkpoint) becomes the model's parameters with no copy; a numpy
    tree is copied once."""
    params = jax.tree.map(np.asarray, _jax_model())
    if quantized:
        params["language_model"] = jax.tree.map(
            np.asarray, jq.quantize_tree(params["language_model"], min_elems=1))
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    mcfg = tcommon.build_model_config(get_model_identifiers(FAMILY))
    model = convert.from_jax(tree, mcfg, device="cpu")
    got = {"/".join(k.split(".")): v for k, v in model.state_dict().items()}
    want = dict(_leaves(tree))
    assert got.keys() == want.keys()
    for k, leaf in want.items():
        if not k.endswith("/q"):  # int8 values are re-laid in_contiguous
            assert got[k].data_ptr() == leaf.data_ptr(), k
    again = convert.from_jax(params, mcfg, device="cpu")
    for (n, p), (m, q) in zip(model.state_dict().items(), again.state_dict().items()):
        assert n == m and torch.equal(p, q) and p.data_ptr() != q.data_ptr(), n


def _legacy(q4: np.ndarray) -> np.ndarray:
    """The legacy on-disk form of a q4 leaf: the int4 values, flat, as
    uint8 nibble pairs (even index low)."""
    v = np.asarray(jq.unpack_int4(jnp.asarray(q4))).reshape(-1).astype(np.int16)
    v = np.where(v < 0, v + 16, v).astype(np.uint8)
    return (v[0::2] | (v[1::2] << 4)).astype(np.uint8)


@pytest.mark.parametrize("bits", ["int8", "int4", "int4-legacy"])
def test_quantized_checkpoints_load_as_qtensors(tmp_path, bits):
    from multimodal_unlearning_tpu.models import llava as jllava

    entry = _wide_entry()
    jcfg = jllava.LlavaConfig.from_registry(entry["arch"])
    params = jllava.init_params(jcfg, jax.random.PRNGKey(0))
    params["language_model"] = jq.quantize_tree(params["language_model"],
                                                bits=8 if bits == "int8" else 4)
    jckpt.save_quantized_checkpoint(tmp_path, params, meta={"bits": bits})
    if bits == "int4-legacy":
        flat = np_load(str(tmp_path / "model.quant.safetensors"))
        shapes = {}
        for k in [k for k in flat if k.endswith("/q4")]:
            q4 = flat.pop(k)
            key = k[:-1]  # <leaf>/q, as the legacy writer named it
            shapes[key] = [*q4.shape[:-2], q4.shape[-2] * 2, q4.shape[-1]]
            flat[key] = _legacy(q4)
        np_save(flat, str(tmp_path / "model.quant.safetensors"))
        (tmp_path / "quantize_meta.json").write_text(
            '{"bits": "int4", "int4_shapes": %s}' % str(shapes).replace("'", '"'))
    jtree, _ = jckpt.load_quantized_checkpoint(tmp_path, jnp.float32)
    _, _, model = tcommon.init_or_load_params(entry, str(tmp_path), dtype=torch.float32,
                                              device="cpu")
    leaves = {n: m for n, m in model.named_modules() if isinstance(m, (QTensor, QTensor4))}
    assert leaves, "nothing was loaded quantized"
    for name, leaf in leaves.items():
        node = jtree
        for part in name.split("."):
            node = node[part]
        qname = "q4" if isinstance(leaf, QTensor4) else "q"
        assert (qname == "q4") == bits.startswith("int4"), name
        assert np.array_equal(getattr(leaf, qname).numpy(), np.asarray(node[qname])), name
        assert np.array_equal(leaf.s.numpy(), np.asarray(node["s"])), name
    assert model.vision_tower.patch_embed.dtype == torch.float32


def _random_b(adapters, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, adapters)


@pytest.mark.parametrize("consume", [False, True], ids=["keep", "consume"])
@pytest.mark.parametrize("base", ["dense", "int8"])
def test_merge_model_equals_jax(base, consume):
    from multimodal_unlearning_tpu.models import llava as jllava

    if base == "dense":
        params = _jax_model()
        mcfg = tcommon.build_model_config(get_model_identifiers(FAMILY))
    else:
        entry = _wide_entry()
        params = jllava.init_params(jllava.LlavaConfig.from_registry(entry["arch"]),
                                    jax.random.PRNGKey(0))
        params["language_model"] = jq.quantize_tree(params["language_model"])
        mcfg = tcommon.build_model_config(entry)
    adapters = _random_b(jlora.init_model_lora(params, 4, jax.random.PRNGKey(1)), 2)
    want = _flat(jax.tree.map(np.asarray, jlora.merge_model(params, adapters, 8.0)))
    model = convert.from_jax(jax.tree.map(np.asarray, params), mcfg, device="cpu")
    tad = convert.adapters_from_jax(jax.tree.map(np.asarray, adapters), device="cpu")
    got = _flat(tlora.merge_model(model, tad, 8.0, consume=consume))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    if consume:
        assert not list(model.parameters()), "consume left leaves in the model"


def test_merge_dtype_is_honoured_on_a_dense_base():
    params = _jax_model()
    mcfg = tcommon.build_model_config(get_model_identifiers(FAMILY))
    adapters = _random_b(jlora.init_model_lora(params, 4, jax.random.PRNGKey(1)), 3)
    model = convert.from_jax(jax.tree.map(np.asarray, params), mcfg, device="cpu")
    tad = convert.adapters_from_jax(jax.tree.map(np.asarray, adapters), device="cpu")
    f32 = tlora.merge_model(model, tad, 8.0)
    bf16 = tlora.merge_model(model, tad, 8.0, out_dtype=torch.bfloat16)
    a, b = _flat(f32), _flat(bf16)
    for path, leaf in _leaves(bf16):
        assert leaf.dtype == torch.bfloat16, path
    for k in a:  # the cast of the f32 merge, nothing else
        assert np.array_equal(b[k], torch.from_numpy(a[k]).to(torch.bfloat16).float().numpy()), k


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_train_state_round_trip(tmp_path):
    from multimodal_unlearning_tpu_torch.train import optim, trainer

    adapters = convert.adapters_from_jax(
        jax.tree.map(np.asarray, _random_b(jlora.init_model_lora(
            _jax_model(), 4, jax.random.PRNGKey(1)), 4)), device="cpu")
    tx = optim.make_optimizer("adamw", 1e-3)
    state = trainer.create_train_state(adapters, tx)
    state = trainer.TrainState(step=state.step + 3, trainable=state.trainable,
                               opt_state=dict(state.opt_state, count=state.step + 3))
    ck = tckpt.TrainStateCheckpointer(tmp_path, keep_last=1)
    ck.save(2, state)
    ck.save(3, state)
    ck.wait()
    assert tckpt.latest_train_state_step(tmp_path) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3"]
    fresh = trainer.create_train_state(_zeros_like(adapters), tx)
    back = tckpt.restore_train_state(tmp_path, 3, fresh)
    assert int(back.step) == 3 and int(back.opt_state["count"]) == 3
    for (p, x), (_, y) in zip(_leaves(back.trainable), _leaves(state.trainable)):
        assert torch.equal(x, y) and x.requires_grad, p


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict)
            else torch.zeros_like(v).requires_grad_() for k, v in tree.items()}
