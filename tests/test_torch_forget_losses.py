"""The port's unlearning losses against the JAX package's (CPU, f32): every
loss type on the same student and teacher outputs, value, metrics and the
gradient with respect to the student's logits and captured activations;
``l_regularization`` from zero and from the initial model; RMU's control
vector; and one RMU step through ``make_train_step`` on a dense 8-layer
llama (RMU reads layer 7), built the same in both packages.

Tolerances.  Losses and metrics: 1e-5 relative (f32 reductions over a few
thousand terms).  Gradients: 1e-5 relative plus 1e-6 of the largest entry
absolute (entries near zero carry the reductions' absolute roundoff).  The
RMU step: loss and gradient norm 1e-5 relative, parameters 2e-6 absolute
after the update (Adam's first step moves an entry by ~lr = 1e-3; only an
entry whose gradient is within roundoff of 0 could differ more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import mm_forget as jforget
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.train import losses as jl
from multimodal_unlearning_tpu.train import optim as jo
from multimodal_unlearning_tpu.train import trainer as jt
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.train import losses as tl
from multimodal_unlearning_tpu_torch.train import optim as to
from multimodal_unlearning_tpu_torch.train import trainer as tt
from multimodal_unlearning_tpu_torch.utils.pytree import (
    param_tree, tree_leaves, tree_leaves_with_path, tree_map)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: under parallel
    test workers, torch's default of one thread per core oversubscribes the
    machine and its small ops slow down by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5
B, S, V, H, K = 2, 9, 37, 8, 3
BETA = 0.7  # npo_nlp takes beta 1: a fractional power of a negative log-ratio is NaN
SKU_ARGS = {"bad_weight": 2.5, "random_weight": 1.0, "normal_weight": 0.5}

# (loss type, loss_args, dpo_fix)
CASES = {
    "grad_diff_forget_ce_retain_ce": ("grad_diff_forget_ce_retain_ce", None, False),
    "grad_diff_forget_entropy_retain_ce": ("grad_diff_forget_entropy_retain_ce", None, False),
    "grad_diff_forget_kl_retain_kl": ("grad_diff_forget_kl_retain_kl", None, False),
    "grad_diff_forget_ce_retain_kl": ("grad_diff_forget_ce_retain_kl", None, False),
    "grad_diff_forget_KL_retain_ce": ("grad_diff_forget_KL_retain_ce", None, False),
    "retain_ft": ("retain_ft", None, False),
    "grad_ascent": ("grad_ascent", None, False),
    "scrub": ("scrub", None, False),
    "KL": ("KL", None, False),
    "llmu": ("llmu", None, False),
    "rmu": ("rmu", None, False),
    "rmu_nlp": ("rmu", {"rmu_nlp": True}, False),
    "npo": ("npo", None, False),
    "npo_nlp": ("npo", {"npo_nlp": True}, False),
    "idk": ("idk", None, False),
    "eco_ft": ("eco_ft", None, False),
    "dpo": ("dpo", None, False),
    "dpo_fix": ("dpo", None, True),
    "sku": ("sku", SKU_ARGS, False),
    "sku_default_weights": ("sku", None, False),
}


def _inputs(nlp: bool, seed=0):
    """Per split: labels, the student's logits and activations (the
    differentiated inputs) and the teacher's.  npo_nlp's log1p of the log
    probability ratio is finite only above -1: there the teacher is the
    student at 1.2x its logits (ratios in about (-0.3, 2.3)); elsewhere the
    teacher is the student plus unit noise, which keeps the KL terms well
    away from 0 (near it their f32 cancellation leaves 1e-4 relative error)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    const, student = {}, {}
    for split, lead in (("forget", (B,)), ("retain", (B,)), ("idk", (B,)), ("random", (B, K))):
        labels = rng.integers(0, V, lead + (S,))
        labels[..., :3] = -100
        labels[..., 0, 5] = -100
        logits, acts = f32(*lead, S, V) * 2, f32(*lead, S, H)
        student[split] = {"s_logits": logits, "s_acts": acts}
        const[split] = {"labels": labels, "input_ids": labels.clip(0),
                        "t_logits": 1.2 * logits if nlp else logits + f32(*lead, S, V),
                        "t_acts": acts + 0.3 * f32(*lead, S, H)}
    return const, student


def _apply(prefix):
    def fn(part, capture_layer=None):
        return {"logits": part[f"{prefix}_logits"],
                "captured": None if capture_layer is None else part[f"{prefix}_acts"]}
    return fn


def _control_vec(loss_args):
    rng = np.random.default_rng(7)
    shape = (1, 1, H) if loss_args and loss_args.get("rmu_nlp") else (B, 1, H)
    return rng.random(shape).astype(np.float32) * 3


@pytest.mark.parametrize("case", list(CASES))
def test_loss_value_and_gradient_match_jax(case):
    loss_type, loss_args, dpo_fix = CASES[case]
    nlp = bool(loss_args and loss_args.get("npo_nlp"))
    const, student = _inputs(nlp)
    cv = _control_vec(loss_args)
    kw = dict(beta=1.0 if nlp else BETA, loss_args=loss_args, dpo_fix=dpo_fix)

    def jloss(sp):
        batch = {s: {**{k: jnp.asarray(v) for k, v in const[s].items()}, **sp[s]}
                 for s in const}
        return jl.compute_forget_loss(loss_type, batch, student=_apply("s"),
                                      teacher=_apply("t"), control_vec=jnp.asarray(cv), **kw)

    (want, wm), wgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, student))

    tstudent = tree_map(lambda x: torch.from_numpy(x).requires_grad_(), student)
    batch = {s: {**{k: torch.from_numpy(v) for k, v in const[s].items()}, **tstudent[s]}
             for s in const}
    got, gm = tl.compute_forget_loss(loss_type, batch, student=_apply("s"), teacher=_apply("t"),
                                     control_vec=torch.from_numpy(cv), **kw)
    leaves = tree_leaves_with_path(tstudent)
    grads = torch.autograd.grad(got, [x for _, x in leaves], allow_unused=True)

    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    assert set(gm) == set(wm)
    for k in gm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=RTOL, atol=1e-6, err_msg=k)
    for (path, x), g in zip(leaves, grads):
        w = np.asarray(wgrad[path[0]][path[1]])
        if g is None:  # an input this loss never reads
            assert not w.any(), path
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-6 * np.abs(w).max(),
                                   err_msg="/".join(path))
    assert tl.loss_needs_teacher(loss_type) == jl.loss_needs_teacher(loss_type)
    assert tl.batch_return_pairs(loss_type) == jl.batch_return_pairs(loss_type)


def test_loss_errors():
    part = {"labels": torch.zeros((1, 3), dtype=torch.long)}
    student = lambda p, **kw: {"logits": torch.zeros((1, 3, 5)), "captured": torch.zeros(1, 3, 4)}
    with pytest.raises(ValueError, match="control vector"):
        tl.compute_forget_loss("rmu", {"forget": part, "retain": part}, student=student,
                               teacher=student)
    with pytest.raises(ValueError, match="teacher"):
        tl.compute_forget_loss("npo", {"forget": part}, student=student)


def _reg_trees(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    trainable = {"layers": {"w": f(3, 5, 4), "norm": f(3, 5)}, "head": f(4, 6), "bias": f(6)}
    init = jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
                        trainable)
    # a leaf equal to its initial value, and a slice of one: L1's gradient 0 there
    init["bias"] = trainable["bias"].copy()
    init["layers"]["w"][1] = trainable["layers"]["w"][1]
    trainable["head"][0, :3] = 0.0
    return trainable, init


@pytest.mark.parametrize("l_norm_from", ["zero", "init"])
@pytest.mark.parametrize("lams", [(0.3, 0.0), (0.0, 0.02), (0.3, 0.02)], ids=["l1", "l0", "both"])
def test_l_regularization_matches_jax(l_norm_from, lams):
    l1, l0 = lams
    trainable, init = _reg_trees(np.random.default_rng(4))
    jinit = None if l_norm_from == "zero" else jax.tree.map(jnp.asarray, init)
    want, wgrad = jax.value_and_grad(
        lambda t: jl.l_regularization(t, jinit, l1_lambda=l1, l0_lambda=l0))(
        jax.tree.map(jnp.asarray, trainable))

    tp = tree_map(lambda x: torch.from_numpy(x).requires_grad_(), trainable)
    tinit = None if l_norm_from == "zero" else tree_map(torch.from_numpy, init)
    got = tl.l_regularization(tp, tinit, l1_lambda=l1, l0_lambda=l0)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    leaves = tree_leaves_with_path(tp)
    if not l1:
        assert not got.requires_grad  # L0: a value, no gradient
        return
    grads = torch.autograd.grad(got, [x for _, x in leaves])
    flat = {tuple(k.key for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(wgrad)[0]}
    for (path, _), g in zip(leaves, grads):
        np.testing.assert_array_equal(g.numpy(), flat[path], err_msg="/".join(path))
        # the in-place form the train step adds to its gradients
        tinit_leaf = None if tinit is None else dict(tree_leaves_with_path(tinit))[path]
        np.testing.assert_array_equal(
            tl.l1_grad(dict(leaves)[path].detach(), tinit_leaf, l1).numpy(), flat[path])
    if l_norm_from == "init":
        g = dict(zip([p for p, _ in leaves], grads))
        assert not g[("bias",)].any() and not g[("layers", "w")][1].any()


def test_make_control_vec():
    gen = lambda: torch.Generator().manual_seed(3)
    v = tl.make_control_vec(gen(), 4, 16)
    assert v.shape == (4, 1, 16) and v.dtype == torch.float32 and (v >= 0).all()
    np.testing.assert_allclose(float(torch.linalg.vector_norm(v)), 300.0, rtol=1e-6)
    assert torch.equal(v, tl.make_control_vec(gen(), 4, 16))
    w = np.asarray(jl.make_control_vec(jax.random.PRNGKey(3), 4, 16))
    np.testing.assert_allclose(np.linalg.norm(w), 300.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# RMU through make_train_step on a dense 8-layer llama
# ---------------------------------------------------------------------------

ARCH = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=8, num_heads=4,
            num_kv_heads=2)
LR = 1e-3


def _llama_batch(rng):
    def split():
        ids = rng.integers(3, ARCH["vocab_size"], (2, 12)).astype(np.int32)
        labels = ids.copy()
        labels[:, :4] = -100
        mask = np.ones_like(ids)
        mask[1, :2] = 0
        return {"input_ids": ids, "attention_mask": mask, "labels": labels}
    return {"forget": split(), "retain": split()}


@pytest.mark.parametrize("opt,accum", [("sgd", 1), ("sgd", 2), ("adamw", 1), ("adamw_q8", 2)])
def test_rmu_train_step_matches_jax(opt, accum):
    """One RMU step of a dense tree, updated in place.  SGD carries the
    gradients' f32 roundoff into the parameters unscaled: 1e-7 absolute
    (lr 0.1).  Adam divides each entry by its own magnitude, so an entry
    whose gradient is within roundoff of 0 can move by up to +-lr on either
    side: for AdamW and adamw_q8 the per-leaf cosine between the two sides'
    parameter changes is at least 0.999 and 99% of the entries agree to
    2e-6."""
    jcfg = jllama.LlamaConfig.from_registry(ARCH)
    tcfg = tconfig.LlamaConfig.from_registry(ARCH)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    cv = rng.random((2, 1, ARCH["hidden_size"])).astype(np.float32)
    cv *= 300.0 / np.linalg.norm(cv)
    batches = [_llama_batch(rng) for _ in range(accum)]
    batch = batches[0] if accum == 1 else jax.tree.map(lambda *x: np.stack(x), *batches)
    lr = 0.1 if opt == "sgd" else LR

    jtx = jo.make_optimizer(opt, lr, weight_decay=0.01, max_grad_norm=1.0)
    japply = jforget.make_apply_fn("llama", jcfg, compute_dtype=jnp.float32)
    jstep = jt.make_train_step(japply, jtx, loss_type="rmu", grad_accum=accum, donate=False)
    jstate = jt.create_train_state(params, jtx, control_vec=jnp.asarray(cv))
    # a teacher apart from the student: at student == teacher the retain
    # term's gradient is roundoff, which Adam would scale up to +-lr
    tparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    jstate, jm = jstep(jstate, None, tparams, jax.tree.map(jnp.asarray, batch))

    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    teacher = convert.from_jax(jax.tree.map(np.asarray, tparams), tcfg, device="cpu")
    trainable = param_tree(model)
    for p in tree_leaves(trainable):
        p.requires_grad_(True)
    ttx = to.make_optimizer(opt, lr, weight_decay=0.01, max_grad_norm=1.0)
    tapply = tforget.make_apply_fn("llama", tcfg, compute_dtype=torch.float32, model=model)
    tstep = tt.make_train_step(tapply, ttx, loss_type="rmu", grad_accum=accum)
    state = tt.create_train_state(trainable, ttx, control_vec=torch.from_numpy(cv))
    new, tm = tstep(state, None, teacher, tree_map(torch.from_numpy, batch))

    for key in ("loss", "forget_loss", "retain_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL, err_msg=key)
    assert int(tm["skipped_nonfinite"]) == 0 and int(new.step) == 1
    # in place: the state's trainable tree is the model's own parameters
    assert new.trainable is state.trainable and new.trainable["norm"] is model.norm
    flat = lambda tree: {tuple(k.key for k in p): np.asarray(x)
                         for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want, start = flat(jstate.trainable), flat(params)
    for path, leaf in tree_leaves_with_path(new.trainable):
        got, name = leaf.detach().numpy(), "/".join(path)
        if opt == "sgd":
            np.testing.assert_allclose(got, want[path], atol=1e-7, rtol=0, err_msg=name)
            continue
        dt, dj = (got - start[path]).ravel(), (want[path] - start[path]).ravel()
        if not dj.any():  # RMU reads layer 7's output: the final norm gets no gradient
            assert not dt.any(), name
            continue
        assert dt @ dj / (np.linalg.norm(dt) * np.linalg.norm(dj)) >= 0.999, name
        assert np.mean(np.abs(dt - dj) > 2e-6) <= 1e-2, name
    assert max(np.abs(want[p] - start[p]).max() for p in want) > 0
