"""The port's training forward (CPU, f32 compute) against the JAX package's
on the same weights and adapters, carried across by ``models/convert.py``
(dense trees, int8-quantized trees, LoRA adapter trees): the decoder with
LoRA (``lm_head`` included), ``capture_layer`` and ``return_hidden``; a
quantized decoder under W8A16 (dequant route) and under W8A8 with both
backward routes; LLaVA with projector LoRA and an int8 embedding table; and
rematerialisation, which must change no value.

Tolerances.  f32 and W8A16 run the same f32 math in another summation order:
logits to 2e-4, LoRA gradients to 2e-4 of each leaf's largest entry.  Under
W8A8 the activations are re-quantized per row, and a value that lies within
float roundoff of a rounding boundary can round to the other side on one of
the two frameworks; one flip moves one int8 step (1/127 of the row's
maximum) through a 256-wide product, so whole-model agreement is held at 5e-2
on logits of size ~1 and 5e-2 of each gradient leaf's largest entry (the
function-level parity of the W8A8 products is exact to roundoff, see
``test_torch_quantize.py``).
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
from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.utils import quantize as tq
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path

TIGHT, LOOSE = 2e-4, 5e-2
SCALE = 2.0
DECODER = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
               num_heads=4, num_kv_heads=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_b(adapters, seed):
    """LoRA ``b`` starts at zero, where the adapters do nothing and ``a``
    gets no gradient: give it values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, adapters)


@pytest.fixture
def int8_flags_off():
    yield
    jllama.enable_int8_compute(False)
    jq.enable_int8_bwd(False)
    tllama.enable_int8_compute(False)
    tq.enable_int8_bwd(False)


@pytest.fixture(scope="module")
def decoder():
    jcfg = jllama.LlamaConfig(**DECODER)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    adapters = jlora.init_lora(params["layers"], 4, jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    adapters["lm_head"] = {
        "a": jnp.asarray(rng.standard_normal((256, 4)).astype(np.float32) / 16),
        "b": jnp.zeros((4, 512), jnp.float32)}
    adapters = _randomize_b(adapters, 2)
    ids = rng.integers(3, 512, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, :4] = 0
    weight = rng.standard_normal((2, 12, 512)).astype(np.float32)
    return jcfg, params, jq.quantize_tree(params), adapters, ids, mask, weight


def _jax_decoder(jcfg, params, adapters, ids, mask, weight, **kw):
    def loss(lora):
        out = jllama.forward(params, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             lora=lora, lora_scale=SCALE, compute_dtype=jnp.float32, **kw)
        return jnp.sum(out["logits"] * weight) / weight.size, out
    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(adapters)
    return out, grads


def _torch_decoder(model, adapters, ids, mask, weight, **kw):
    out = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                lora=adapters, lora_scale=SCALE, compute_dtype=torch.float32, **kw)
    loss = torch.sum(out["logits"] * torch.from_numpy(weight)) / weight.size
    leaves = tree_leaves_with_path(adapters)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves])
    return out, {path: g for (path, _), g in zip(leaves, grads)}


def _check_grads(got, want, tol):
    want = {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g.numpy(), w, atol=tol * np.abs(w).max(), rtol=0,
                                   err_msg="/".join(path))


def test_decoder_lora_capture_hidden(decoder):
    jcfg, params, _, adapters, ids, mask, weight = decoder
    model = convert.from_jax(_np(params), tconfig.LlamaConfig(**DECODER), device="cpu")
    tad = convert.adapters_from_jax(_np(adapters), device="cpu")
    want, want_g = _jax_decoder(jcfg, params, adapters, ids, mask, weight, capture_layer=0,
                                return_hidden=True)
    got, got_g = _torch_decoder(model, tad, ids, mask, weight, capture_layer=0,
                                return_hidden=True)
    for key in ("logits", "captured", "hidden"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=TIGHT, rtol=0, err_msg=key)
    assert got["captured"].dtype == torch.float32 and got["kv_cache"] is None
    _check_grads(got_g, want_g, TIGHT)
    plain = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                  compute_dtype=torch.float32)
    assert plain["captured"] is None and plain["hidden"] is None


@pytest.mark.parametrize("mode", ["w8a16", "w8a8", "w8a8_int8_dx"])
def test_quantized_decoder_matches_jax(decoder, int8_flags_off, mode):
    jcfg, _, qparams, adapters, ids, mask, weight = decoder
    model = convert.from_jax(_np(qparams), tconfig.LlamaConfig(**DECODER), device="cpu")
    assert isinstance(model.layers.q_proj, tq.QTensor) and model.layers.q_proj.q.dtype == torch.int8
    assert isinstance(model.embed_tokens, tq.QTensor)
    assert isinstance(model.layers.k_proj, torch.nn.Parameter)  # 128 wide: stays float
    tad = convert.adapters_from_jax(_np(adapters), device="cpu")
    for mod, qmod in ((jllama, jq), (tllama, tq)):
        mod.enable_int8_compute(mode != "w8a16")
        qmod.enable_int8_bwd(mode == "w8a8_int8_dx")
    want, want_g = _jax_decoder(jcfg, qparams, adapters, ids, mask, weight)
    got, got_g = _torch_decoder(model, tad, ids, mask, weight)
    tol = TIGHT if mode == "w8a16" else LOOSE
    np.testing.assert_allclose(got["logits"].detach().numpy(), np.asarray(want["logits"]),
                               atol=tol, rtol=0)
    _check_grads(got_g, want_g, tol)


@pytest.mark.parametrize("policy", [None, "save_attn", "save_attn_ffn", "dots", "dots_no_batch"])
def test_remat_changes_no_value(decoder, int8_flags_off, policy):
    """W8A8 + int8 dx + LoRA, the forget step's setting: logits and every
    LoRA gradient with remat equal those without, bit for bit."""
    _, _, qparams, adapters, ids, mask, weight = decoder
    model = convert.from_jax(_np(qparams), tconfig.LlamaConfig(**DECODER), device="cpu")
    tad = convert.adapters_from_jax(_np(adapters), device="cpu")
    tllama.enable_int8_compute(True)
    tq.enable_int8_bwd(True)
    base, base_g = _torch_decoder(model, tad, ids, mask, weight)
    got, got_g = _torch_decoder(model, tad, ids, mask, weight, remat=True, remat_policy=policy)
    assert torch.equal(got["logits"], base["logits"])
    for path in base_g:
        assert torch.equal(got_g[path], base_g[path]), path


def test_unported_training_options_raise(decoder):
    _, params, _, adapters, ids, mask, _ = decoder
    model = convert.from_jax(_np(params), tconfig.LlamaConfig(**DECODER), device="cpu")
    tids = torch.from_numpy(ids).long()
    with pytest.raises(ValueError):
        model(tids, remat=True, remat_policy="everything", compute_dtype=torch.float32)
    bank = {"layers": {"q_proj": {"a": torch.zeros(2, 3, 256, 4), "b": torch.zeros(2, 3, 4, 256)}}}
    # a bank is ported (multi-LoRA serving); without per-row ids it raises,
    # as in the JAX package
    with pytest.raises(ValueError, match="lora_ids"):
        model(tids, lora=bank, lora_scale=1.0, compute_dtype=torch.float32)


@pytest.mark.parametrize("mode", ["w8a16"])
def test_llava_training_forward_matches_jax(int8_flags_off, mode):
    """LLaVA with projector and decoder LoRA over a 256-wide decoder whose
    embedding table and LM head are int8 too (the f32 LLaVA is held by the
    train-step test)."""
    arch = get_model_identifiers("tiny-llava-test").arch.to_dict()
    if mode == "w8a16":
        arch["decoder"] = dict(arch["decoder"], **DECODER)
        arch["image_token_id"] = 500
    jcfg = jllava.LlavaConfig.from_registry(arch)
    tcfg = tconfig.LlavaConfig.from_registry(arch)
    params = jllava.init_params(jcfg, jax.random.PRNGKey(3))
    if mode == "w8a16":
        params["language_model"] = jq.quantize_tree(params["language_model"])
    adapters = _randomize_b(jlora.init_model_lora(params, 4, jax.random.PRNGKey(4)), 6)
    assert set(adapters) == {"language_model", "projector"}
    rng = np.random.default_rng(7)
    n = jcfg.num_image_tokens
    ids = rng.integers(3, 250, (2, n + 10)).astype(np.int32)
    ids[:, 3:3 + n] = jcfg.image_token_id
    pix = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    weight = rng.standard_normal((2, n + 10, jcfg.decoder.vocab_size)).astype(np.float32)

    def loss(lora):
        out = jllava.forward(params, jcfg, jnp.asarray(ids), pixel_values=jnp.asarray(pix),
                             lora=lora, lora_scale=SCALE, capture_layer=1,
                             compute_dtype=jnp.float32)
        return jnp.sum(out["logits"] * weight) / weight.size, out
    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(adapters)

    model = convert.from_jax(_np(params), tcfg, device="cpu")
    tad = convert.adapters_from_jax(_np(adapters), device="cpu")
    got = model(torch.from_numpy(ids).long(), pixel_values=torch.from_numpy(pix), lora=tad,
                lora_scale=SCALE, capture_layer=1, remat=True, remat_policy="save_attn",
                compute_dtype=torch.float32)
    tloss = torch.sum(got["logits"] * torch.from_numpy(weight)) / weight.size
    leaves = tree_leaves_with_path(tad)
    grads = torch.autograd.grad(tloss, [leaf for _, leaf in leaves])
    np.testing.assert_allclose(got["logits"].detach().numpy(), np.asarray(want["logits"]),
                               atol=TIGHT, rtol=0)
    np.testing.assert_allclose(got["captured"].detach().numpy(), np.asarray(want["captured"]),
                               atol=TIGHT, rtol=0)
    _check_grads({p: g for (p, _), g in zip(leaves, grads)}, want_g, TIGHT)
    # the frozen base carries no gradient and the vision tower built no graph
    assert not any(p.requires_grad for p in model.parameters())


def test_init_model_lora_layout_matches_jax():
    arch = get_model_identifiers("tiny-llava-test").arch
    jcfg = jllava.LlavaConfig.from_registry(arch)
    params = jllava.init_params(jcfg, jax.random.PRNGKey(3))
    want = jlora.init_model_lora(params, 4, jax.random.PRNGKey(0))
    model = convert.from_jax(_np(params), tconfig.LlavaConfig.from_registry(arch), device="cpu")
    got = tlora.init_model_lora(model, 4, torch.Generator().manual_seed(0))
    want_shapes = {tuple(k.key for k in p): x.shape
                   for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    got_leaves = dict(tree_leaves_with_path(got))
    assert {p: tuple(x.shape) for p, x in got_leaves.items()} == want_shapes
    for path, x in got_leaves.items():
        assert x.requires_grad and x.is_leaf
        if path[-1] == "b":
            assert torch.all(x == 0)
        else:  # gaussian times in^-0.5
            assert abs(x.std().item() * x.shape[-2] ** 0.5 - 1.0) < 0.2, path
    assert tlora.lora_scale(8, 32) == jlora.lora_scale(8, 32) == 4.0
    no_proj = tlora.init_model_lora(model, 4, torch.Generator().manual_seed(0), projector=False)
    assert set(no_proj) == {"language_model"}


def test_count_params_matches_jax(decoder, capsys):
    from multimodal_unlearning_tpu.utils import pytree as jpytree
    from multimodal_unlearning_tpu_torch.utils import pytree as tpytree

    _, params, qparams, adapters, *_ = decoder
    tcfg = tconfig.LlamaConfig(**DECODER)
    for tree in (params, qparams):  # a quantized leaf counts its values and its scales
        model = convert.from_jax(_np(tree), tcfg, device="cpu")
        assert tpytree.count_params(model) == jpytree.count_params(tree)
    tad = convert.adapters_from_jax(_np(adapters), device="cpu")
    assert tpytree.count_params(tad) == jpytree.count_params(adapters)
    model = convert.from_jax(_np(qparams), tcfg, device="cpu")
    assert (tpytree.print_trainable_parameters(tad, model)
            == jpytree.print_trainable_parameters(adapters, qparams))
    assert "trainable%" in capsys.readouterr().out
