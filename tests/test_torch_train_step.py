"""The slice as a whole (CPU): ``make_apply_fn`` + ``make_train_step`` of the
port against the JAX package's on a tiny LLaVA, same weights, adapters and
batch (numpy, through ``models/convert.py``): two AdamW steps of
``grad_diff_forget_ce_retain_ce`` with remat ``save_attn`` in f32, the same on
a 256-wide decoder under W8A8 with the int8 dx backward, one step with
``grad_accum=2``, and a non-finite batch, which must leave parameters and
moments untouched.

Tolerances.  f32: loss and gradient norm to 1e-5 relative; updated adapters
to 2e-6 absolute (entries of size ~0.1; Adam's first steps are ~lr * sign(g),
so only an entry whose gradient lies within roundoff of 0 could differ more).
W8A8: activations and gradients are re-quantized per row and a rounding can
flip on float roundoff (where none flips the losses agree to all printed
digits; where one does, a CE of ~7 moves by up to ~1e-2 by the second step):
losses to 3e-2 absolute, gradient norm to 2e-2 relative, and per leaf the
cosine between the two sides' parameter changes at least 0.97 (0.99 is
typical; a sign flip of a near-zero gradient entry moves that entry by
2 * lr under Adam).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import mm_forget as jforget
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.train import optim as joptim
from multimodal_unlearning_tpu.train import trainer as jtrainer
from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.train import optim as toptim
from multimodal_unlearning_tpu_torch.train import trainer as ttrainer
from multimodal_unlearning_tpu_torch.utils import quantize as tq
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path, tree_map

LOSS = "grad_diff_forget_ce_retain_ce"
SCALE, LR, WD = 4.0, 1e-3, 0.01
WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(wide: bool, seed: int):
    arch = get_model_identifiers("tiny-llava-test").arch.to_dict()
    if wide:
        arch["decoder"] = dict(arch["decoder"], **WIDE)
        arch["image_token_id"] = 500
    jcfg = jllava.LlavaConfig.from_registry(arch)
    tcfg = tconfig.LlavaConfig.from_registry(arch)
    params = jllava.init_params(jcfg, jax.random.PRNGKey(seed))
    if wide:
        params["language_model"] = jq.quantize_tree(params["language_model"])
    adapters = jlora.init_model_lora(params, 4, jax.random.PRNGKey(seed + 1))
    rng = np.random.default_rng(seed)
    # b starts at zero, where a gets no gradient: give it values
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, adapters)
    n, V = jcfg.num_image_tokens, jcfg.decoder.vocab_size

    def split():
        ids = rng.integers(3, min(V, 250), (2, n + 12)).astype(np.int32)
        ids[:, 2:2 + n] = jcfg.image_token_id
        labels = ids.copy()
        labels[:, :n + 4] = -100
        mask = np.ones_like(ids)
        mask[1, :2] = 0
        return {"input_ids": ids, "attention_mask": mask, "labels": labels,
                "pixel_values": rng.standard_normal((2, 32, 32, 3)).astype(np.float32)}

    batches = [{"forget": split(), "retain": split()} for _ in range(2)]
    model = convert.from_jax(_np(params), tcfg, device="cpu")
    tadapters = convert.adapters_from_jax(_np(adapters), device="cpu")
    return jcfg, tcfg, params, adapters, model, tadapters, batches


def _steps(jcfg, tcfg, grad_accum=1):
    kw = dict(remat=True, remat_policy="save_attn")
    japply = jforget.make_apply_fn("llava", jcfg, lora_cfg=SCALE, compute_dtype=jnp.float32, **kw)
    tapply = tforget.make_apply_fn("llava", tcfg, lora_cfg=SCALE, compute_dtype=torch.float32,
                                   **kw)
    jtx = joptim.make_optimizer("adamw", LR, weight_decay=WD)
    ttx = toptim.make_optimizer("adamw", LR, weight_decay=WD)
    jstep = jtrainer.make_train_step(japply, jtx, loss_type=LOSS, donate=False,
                                     grad_accum=grad_accum, combine=lambda tr, fr: (fr, tr))
    tstep = ttrainer.make_train_step(tapply, ttx, loss_type=LOSS, grad_accum=grad_accum,
                                     combine=lambda tr, fr: (fr, tr))
    return jstep, jtx, tstep, ttx


def _jnp(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch(batch):
    return tree_map(torch.from_numpy, batch)


def _flat(jtree):
    return {tuple(k.key for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}


@pytest.fixture
def int8_flags_off():
    yield
    jllama.enable_int8_compute(False)
    jq.enable_int8_bwd(False)
    tllama.enable_int8_compute(False)
    tq.enable_int8_bwd(False)


def test_two_train_steps_match_jax_f32():
    jcfg, tcfg, params, adapters, model, tadapters, batches = _setup(False, 0)
    jstep, jtx, tstep, ttx = _steps(jcfg, tcfg)
    jstate = jtrainer.create_train_state(adapters, jtx)
    tstate = ttrainer.create_train_state(tadapters, ttx)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, params, None, _jnp(batch))
        tstate, tm = tstep(tstate, model, None, _torch(batch))
        assert set(tm) == set(jm)
        for key in ("loss", "forget_loss", "retain_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
        assert int(tm["skipped_nonfinite"]) == int(jm["skipped_nonfinite"]) == 0
        want = _flat(jstate.trainable)
        for path, leaf in tree_leaves_with_path(tstate.trainable):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path], atol=2e-6, rtol=0,
                                       err_msg=f"step {i} {'/'.join(path)}")
            assert leaf.requires_grad and leaf.is_leaf
    assert int(tstate.step) == int(jstate.step) == 2
    # the step is functional: the adapters it was given are as they were
    np.testing.assert_array_equal(
        tadapters["projector"]["fc1"]["a"].detach().numpy(),
        np.asarray(adapters["projector"]["fc1"]["a"]))


def test_two_train_steps_match_jax_w8a8(int8_flags_off):
    jcfg, tcfg, params, adapters, model, tadapters, batches = _setup(True, 1)
    assert isinstance(model.language_model.layers.q_proj, tq.QTensor)
    for mod, qmod in ((jllama, jq), (tllama, tq)):
        mod.enable_int8_compute(True)
        qmod.enable_int8_bwd(True)
    jstep, jtx, tstep, ttx = _steps(jcfg, tcfg)
    jstate = jtrainer.create_train_state(adapters, jtx)
    tstate = ttrainer.create_train_state(tadapters, ttx)
    start = _flat(adapters)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, params, None, _jnp(batch))
        tstate, tm = tstep(tstate, model, None, _torch(batch))
        for key in ("loss", "forget_loss", "retain_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=3e-2, rtol=0,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-2)
    want = _flat(jstate.trainable)
    for path, leaf in tree_leaves_with_path(tstate.trainable):
        dt = (leaf.detach().numpy() - start[path]).ravel()
        dj = (want[path] - start[path]).ravel()
        cos = float(dt @ dj / (np.linalg.norm(dt) * np.linalg.norm(dj)))
        assert cos > 0.97, ("/".join(path), cos)
        assert np.abs(dt).max() <= 2.5 * 2 * LR  # two Adam steps move an entry by ~lr each


def test_grad_accum_matches_jax():
    jcfg, tcfg, params, adapters, model, tadapters, batches = _setup(False, 2)
    jstep, jtx, tstep, ttx = _steps(jcfg, tcfg, grad_accum=2)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), *batches)
    jstate, jm = jstep(jtrainer.create_train_state(adapters, jtx), params, None, _jnp(stacked))
    tstate, tm = tstep(ttrainer.create_train_state(tadapters, ttx), model, None,
                       _torch(stacked))
    for key in ("loss", "forget_loss", "retain_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    want = _flat(jstate.trainable)
    for path, leaf in tree_leaves_with_path(tstate.trainable):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], atol=2e-6, rtol=0,
                                   err_msg="/".join(path))
    # metrics are means over the micro-batches
    _, _, single, ttx1 = _steps(jcfg, tcfg)
    losses = [float(single(ttrainer.create_train_state(tadapters, ttx1), model, None,
                           _torch(b))[1]["loss"]) for b in batches]
    np.testing.assert_allclose(float(tm["loss"]), np.mean(losses), rtol=1e-5)


def test_nonfinite_batch_leaves_state_untouched():
    _, tcfg, _, _, model, tadapters, batches = _setup(False, 3)
    _, _, tstep, ttx = _steps(None, tcfg)
    state = ttrainer.create_train_state(tadapters, ttx)
    state, _ = tstep(state, model, None, _torch(batches[0]))  # non-trivial moments
    bad = _torch(batches[1])
    bad["forget"]["pixel_values"][0, 0, 0, 0] = float("inf")
    new, m = tstep(state, model, None, bad)
    assert int(m["skipped_nonfinite"]) == 1 and not np.isfinite(float(m["loss"]))
    assert int(new.step) == int(state.step) + 1  # the step counter still advances
    assert int(new.opt_state["count"]) == int(state.opt_state["count"])
    for tree_new, tree_old in ((new.trainable, state.trainable),
                               (new.opt_state["mu"], state.opt_state["mu"]),
                               (new.opt_state["nu"], state.opt_state["nu"])):
        for (path, a), (_, b) in zip(tree_leaves_with_path(tree_new),
                                     tree_leaves_with_path(tree_old)):
            assert torch.equal(a.detach(), b.detach()), path
    # with the guard off the same batch poisons the parameters
    _, _, raw, ttx2 = _steps(None, tcfg)
    raw = ttrainer.make_train_step(
        tforget.make_apply_fn("llava", tcfg, lora_cfg=SCALE, compute_dtype=torch.float32),
        ttx2, loss_type=LOSS, combine=lambda tr, fr: (fr, tr), skip_nonfinite=False)
    poisoned, m2 = raw(state, model, None, bad)
    assert "skipped_nonfinite" not in m2
    assert not all(torch.isfinite(x).all() for _, x in tree_leaves_with_path(poisoned.trainable))


def test_unported_train_step_options_raise():
    # Qwen2-VL is ported now; the cv stack's ResNet is not
    with pytest.raises(NotImplementedError, match="not ported"):
        tforget.make_apply_fn("resnet", None)


@pytest.mark.parametrize("kind", ["llama", "llava", "qwen2_vl"])
def test_ported_kinds_construct(kind):
    assert callable(tforget.make_apply_fn(kind, None))


def test_port_bench_control_flow_on_the_cpu():
    """The port's bench set-up at a tiny preset on the CPU: its steps run and
    move the loss, the int8 switches are on during them and off again after
    ``teardown``, and ``main`` takes no option but the device."""
    from multimodal_unlearning_tpu_torch import bench

    try:
        b = bench.setup("tiny-llava-test", device="cpu", dtype=torch.float32, seq_len=24)
        assert tllama.INT8_COMPUTE and tq.INT8_BWD
        dt, seen = bench.run_steps(b, 2)
    finally:
        bench.teardown()
    assert dt > 0 and len(seen) == 2 and int(b.state.step) == 3
    assert all(np.isfinite(m["loss"]) and not m["skipped_nonfinite"] for m in seen)
    assert seen[0]["loss"] != seen[-1]["loss"]
    assert not tllama.INT8_COMPUTE and not tq.INT8_BWD
    for arg in ("no_such_argument=1", "steps=2"):
        with pytest.raises(KeyError):
            bench.main([arg])
