"""QLoRA over a grouped-int4 base (CPU, f32) against the JAX package, inputs
from a numpy seed:

- the gradient of x through the W4A16 product: the port's ``int4_matmul``
  (at 8 rows, the rows B8 takes, on its plain version here; at 1,040 rows,
  the dequant route) and ``grouped_int4_matmul`` against ``jax.grad`` of the
  JAX package's ``int4_matmul`` (its XLA route, the one it differentiates);
  each backward counted once in ``INT4_BWD_CALLS``;
- ``init_model_lora`` over an int4 base: every adapter's shape the JAX
  package's (``in`` twice the packed dimension);
- one SGD step of ``grad_diff_forget_ce_retain_ce`` with LoRA r 4 over the
  int4-quantized 256-wide llama (the tiny presets are narrower than 256 and
  quantize nothing), the same adapters and batch;
- ``merge_model`` over the int4 base: the dense tree the JAX package's
  merge gives.

Tolerances: dx 1e-5 absolute (the same f32 products, summed per group here
and over the whole dequantized weight there); the loss and gradient norm
1e-5 relative, updated adapters 1e-5 absolute; the merged tree 1e-6
absolute (the same dequantize-then-fold order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.cli import mm_forget as jforget
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.train import optim as joptim
from multimodal_unlearning_tpu.train import trainer as jtrainer
from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.ops import int4_matmul as ti
from multimodal_unlearning_tpu_torch.train import optim as toptim
from multimodal_unlearning_tpu_torch.train import trainer as ttrainer
from multimodal_unlearning_tpu_torch.utils import quantize as tq
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path, tree_map

LOSS = "grad_diff_forget_ce_retain_ce"
SCALE = 4.0
WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("M", [8, 1040], ids=["b8_rows", "dequant_rows"])
def test_dx_matches_jax_grad(M):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((512, 384)).astype(np.float32) * 0.05
    x = rng.standard_normal((M, 512)).astype(np.float32)
    cot = rng.standard_normal((M, 384)).astype(np.float32)
    jqt = jq.quantize_leaf_int4(jnp.asarray(w))
    want = np.asarray(jax.grad(lambda a: (jq.int4_matmul(a, jqt["q4"], jqt["s"])
                                          * cot).sum())(jnp.asarray(x)))
    qt = tq.quantize_leaf_int4(torch.from_numpy(w))
    for fn in (tq.int4_matmul, ti.grouped_int4_matmul):
        before = dict(ti.INT4_BWD_CALLS)
        xt = torch.from_numpy(x).requires_grad_()
        (got,) = torch.autograd.grad(fn(xt, qt["q4"], qt["s"]), xt, torch.from_numpy(cot))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        assert ti.INT4_BWD_CALLS[(M, 512, 384)] == before.get((M, 512, 384), 0) + 1


@pytest.fixture(scope="module")
def int4_llama():
    """The 256-wide llama quantized to grouped int4 by the JAX package (its
    tree) and carried across (the port's model), random adapters with b
    off zero, and one batch."""
    arch = get_model_identifiers("tiny-llama-test").arch.to_dict()
    arch.update(WIDE)
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jcommon.quantize_base_params(jllama.init_params(jcfg, jax.random.PRNGKey(3)),
                                          "llama", "int4")
    rng = np.random.default_rng(3)
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, jlora.init_model_lora(params, 4, jax.random.PRNGKey(4)))

    def split():
        ids = rng.integers(3, 500, (2, 24)).astype(np.int32)
        labels = ids.copy()
        labels[:, :6] = -100
        mask = np.ones_like(ids)
        mask[1, :3] = 0
        return {"input_ids": ids, "attention_mask": mask, "labels": labels}

    tree = jax.tree.map(np.asarray, params)
    model = convert.from_jax(tree, tconfig.LlamaConfig.from_registry(arch), device="cpu")
    assert sum(isinstance(m, tq.QTensor4) for m in model.modules()) == 7
    return jcfg, params, adapters, model, {"forget": split(), "retain": split()}


def test_init_model_lora_shapes_over_int4(int4_llama):
    _, params, _, model, _ = int4_llama
    want = jlora.init_model_lora(params, 4, jax.random.PRNGKey(0))
    got = tlora.init_model_lora(model, 4, torch.Generator().manual_seed(0))
    want = {tuple(k.key for k in p): x.shape
            for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {p: tuple(x.shape) for p, x in tree_leaves_with_path(got)}
    assert got == want
    assert got[("layers", "gate_proj", "a")] == (2, 256, 4)  # 2 x the packed 128


def test_lora_step_over_int4_matches_jax(int4_llama):
    jcfg, params, adapters, model, batch = int4_llama
    combine = lambda tr, fr: (fr, tr)  # noqa: E731
    japply = jforget.make_apply_fn("llama", jcfg, lora_cfg=SCALE, compute_dtype=jnp.float32)
    tapply = tforget.make_apply_fn("llama", model.cfg, lora_cfg=SCALE,
                                   compute_dtype=torch.float32)
    jtx, ttx = joptim.make_optimizer("sgd", 0.1), toptim.make_optimizer("sgd", 0.1)
    jstep = jtrainer.make_train_step(japply, jtx, loss_type=LOSS, donate=False, combine=combine)
    tstep = ttrainer.make_train_step(tapply, ttx, loss_type=LOSS, combine=combine)
    tadapters = convert.adapters_from_jax(jax.tree.map(np.asarray, adapters), device="cpu")
    before = sum(ti.INT4_BWD_CALLS.values())
    jstate, jm = jstep(jtrainer.create_train_state(adapters, jtx), params, None,
                       jax.tree.map(jnp.asarray, batch))
    tstate, tm = tstep(ttrainer.create_train_state(tadapters, ttx), model, None,
                       tree_map(torch.from_numpy, batch))
    # a backward through each int4 product whose input an adapter reaches, in
    # each of the two forwards (forget, retain): q, o, gate, up and down of
    # both layers (k and v, 128 wide, stay float) but layer 0's q, whose
    # input is the embedding, and lm_head
    assert sum(ti.INT4_BWD_CALLS.values()) - before == 2 * (2 * 5 - 1 + 1)
    for key in ("loss", "forget_loss", "retain_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    want = {tuple(k.key for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jstate.trainable)[0]}
    got = dict(tree_leaves_with_path(tstate.trainable))
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], atol=1e-5, rtol=0,
                                   err_msg="/".join(path))
    moved = got[("layers", "q_proj", "a")].detach().numpy()
    assert np.abs(moved - np.asarray(adapters["layers"]["q_proj"]["a"])).max() > 1e-3


def test_merge_over_int4_matches_jax(int4_llama):
    _, params, adapters, model, _ = int4_llama
    want = jlora.merge_model(params, adapters, SCALE)
    tadapters = convert.adapters_from_jax(jax.tree.map(np.asarray, adapters), device="cpu")
    got = dict(tree_leaves_with_path(tlora.merge_model(model, tadapters, SCALE)))
    want = {tuple(k.key for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.dtype == torch.float32 and not tq.is_qtensor(leaf), path
        np.testing.assert_allclose(leaf.numpy(), want[path], atol=1e-6, rtol=0,
                                   err_msg="/".join(path))
