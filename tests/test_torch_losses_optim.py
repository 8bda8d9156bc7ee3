"""The port's losses, schedule, decay mask, clipping and AdamW/SGD (CPU, f32)
against the JAX package's (optax chains) on the same numpy inputs.

Tolerances: losses are f32 reductions over a few hundred terms: 1e-5
relative.  The optimizer is held over several steps with changing gradients:
parameters and moments to 1e-6 absolute on values of size ~1 (the same f32
elementwise math; only ``b ** count`` and the schedule's division may round
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_unlearning_tpu.train import losses as jl
from multimodal_unlearning_tpu.train import optim as jo
from multimodal_unlearning_tpu_torch.train import losses as tl
from multimodal_unlearning_tpu_torch.train import optim as to
from multimodal_unlearning_tpu_torch.utils.pytree import tree_map

RTOL = 1e-5


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    B, S, V = 2, 9, 37
    out = {}
    for split in ("forget", "retain"):
        labels = rng.integers(0, V, (B, S))
        labels[:, :3] = -100
        labels[1, 5] = -100
        out[split] = {"labels": labels,
                      "logits": rng.standard_normal((B, S, V)).astype(np.float32) * 2,
                      "teacher": rng.standard_normal((B, S, V)).astype(np.float32) * 2}
    return out


def test_loss_pieces(batch):
    lg, lb = batch["forget"]["logits"], batch["forget"]["labels"]
    tlg, tlb = torch.from_numpy(lg), torch.from_numpy(lb)
    np.testing.assert_allclose(tl.ce_loss(tlg, tlb), jl.ce_loss(jnp.asarray(lg), jnp.asarray(lb)),
                               rtol=RTOL)
    np.testing.assert_allclose(tl.seq_sum_ce(tlg, tlb),
                               jl.seq_sum_ce(jnp.asarray(lg), jnp.asarray(lb)), rtol=RTOL)
    np.testing.assert_allclose(tl.logits2logprobs(tlg), jl.logits2logprobs(jnp.asarray(lg)),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tl.logits2probs(tlg), jl.logits2probs(jnp.asarray(lg)),
                               rtol=RTOL, atol=1e-7)
    other = batch["retain"]["logits"]
    np.testing.assert_allclose(
        tl.kl_div(tl.logits2logprobs(tlg), tl.logits2logprobs(torch.from_numpy(other))),
        jl.kl_div(jl.logits2logprobs(jnp.asarray(lg)), jl.logits2logprobs(jnp.asarray(other))),
        rtol=RTOL)
    np.testing.assert_allclose(tl.mse(tlg, torch.from_numpy(other)),
                               jl.mse(jnp.asarray(lg), jnp.asarray(other)), rtol=RTOL)
    # bf16 logits get f32 math; all labels ignored gives 0, not NaN
    assert tl.ce_loss(tlg.bfloat16(), tlb).dtype == torch.float32
    assert tl.ce_loss(tlg, torch.full_like(tlb, -100)) == 0


LOSS_TYPES = ["retain_ft", "grad_ascent", "grad_diff_forget_ce_retain_ce",
              "grad_diff_forget_entropy_retain_ce", "grad_diff_forget_kl_retain_kl",
              "grad_diff_forget_ce_retain_kl"]


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_compute_forget_loss(batch, loss_type):
    def japply(key):
        return lambda part, **kw: {"logits": jnp.asarray(part[key]), "captured": None}

    def tapply(key):
        return lambda part, **kw: {"logits": torch.from_numpy(part[key]), "captured": None}

    jbatch = {s: {"labels": jnp.asarray(p["labels"]), **{k: p[k] for k in ("logits", "teacher")}}
              for s, p in batch.items()}
    tbatch = {s: {"labels": torch.from_numpy(p["labels"]),
                  **{k: p[k] for k in ("logits", "teacher")}} for s, p in batch.items()}
    want, wm = jl.compute_forget_loss(loss_type, jbatch, student=japply("logits"),
                                      teacher=japply("teacher"), beta=0.7)
    got, gm = tl.compute_forget_loss(loss_type, tbatch, student=tapply("logits"),
                                     teacher=tapply("teacher"), beta=0.7)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert set(gm) == set(wm)
    for k in gm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=RTOL, atol=1e-6)
    assert tl.loss_needs_teacher(loss_type) == jl.loss_needs_teacher(loss_type)
    assert tl.batch_return_pairs(loss_type) == jl.batch_return_pairs(loss_type)


def test_invalid_and_teacherless_losses():
    with pytest.raises(ValueError):
        tl.compute_forget_loss("no_such_loss", {}, student=None)
    part = {"labels": torch.zeros((1, 3), dtype=torch.long)}
    student = lambda p, **kw: {"logits": torch.zeros((1, 3, 5)), "captured": None}
    with pytest.raises(ValueError, match="teacher"):
        tl.compute_forget_loss("grad_diff_forget_kl_retain_ce",
                               {"forget": part, "retain": part}, student=student)


def test_hf_linear_schedule():
    for warm, total in ((0, 10), (3, 10), (5, 0)):
        js, ts = jo.hf_linear_schedule(2e-4, warm, total), to.hf_linear_schedule(2e-4, warm, total)
        for c in range(0, 13):
            np.testing.assert_allclose(float(ts(c)), float(js(c)), rtol=1e-6, atol=1e-12)
    assert float(to.hf_linear_schedule(1.0, 2, 10)(0)) == 0.0  # the first step runs at lr 0


def _params(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "language_model": {"layers": {"q_proj": {"a": f(3, 6, 2), "b": f(3, 2, 6)},
                                      "input_layernorm": f(3, 6), "q_bias": f(3, 6)},
                           "norm": f(6)},
        "vision_tower": {"layers": {"fc1": f(3, 6, 4), "ln1": {"scale": f(3, 6), "bias": f(3, 6)}},
                         "post_ln": {"scale": f(6)}},
        "projector": {"fc1": f(6, 4), "fc1_bias": f(4)},
    }


def test_decay_masks():
    params = _params(np.random.default_rng(1))
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    assert to.hf_decay_mask(tp) == jo.hf_decay_mask(jp)
    # reachability: per-layer [L, 1, ..] factors on stacked leaves, scalars elsewhere
    used = np.array([1.0, 1.0, 0.0], np.float32)

    def reach(tree, as_array):
        def leaf(path, x):
            if path[:2] == ("vision_tower", "layers"):
                return as_array(used.reshape((3,) + (1,) * (x.ndim - 1)))
            return path[:2] != ("vision_tower", "post_ln")
        return leaf

    from multimodal_unlearning_tpu_torch.utils.pytree import tree_map_with_path
    treach = tree_map_with_path(reach(tp, torch.from_numpy), tp)
    jreach = jax.tree_util.tree_map_with_path(
        lambda p, x: reach(jp, jnp.asarray)(tuple(k.key for k in p), x), jp)
    got, want = to.decay_mask_tree(tp, treach), jo.decay_mask_tree(jp, jreach)
    flat_w = {tuple(k.key for k in p): v for p, v in
              jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, bool))[0]}
    from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path
    for path, m in tree_leaves_with_path(got):
        w = flat_w[path]
        if isinstance(m, bool):
            assert isinstance(w, bool) and m == w, path
        else:
            np.testing.assert_array_equal(m.numpy(), np.asarray(w))
    assert got["vision_tower"]["layers"]["fc1"].shape == (3, 1, 1)
    assert got["vision_tower"]["layers"]["ln1"]["scale"] is False


def test_clip_by_global_norm_torch():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    for max_norm in (1.0, 1e3):
        want, _ = jo.clip_by_global_norm_torch(max_norm).update(
            jax.tree.map(jnp.asarray, grads), optax.EmptyState())
        got = to.clip_by_global_norm_torch(tree_map(torch.from_numpy, grads), max_norm)
        np.testing.assert_allclose(got["a"], want["a"], rtol=1e-6)
        np.testing.assert_allclose(got["b"]["c"], want["b"]["c"], rtol=1e-6)
    np.testing.assert_allclose(to.global_norm(tree_map(torch.from_numpy, grads)),
                               optax.global_norm(jax.tree.map(jnp.asarray, grads)), rtol=1e-6)


OPTIMIZERS = {
    "adamw_plain": dict(name="adamw", lr=1e-2),
    "adamw_decay": dict(name="adamw", lr=1e-2, weight_decay=0.1),
    "adamw_torch_sched_clip": dict(name="adamw_torch", lr=1e-2, weight_decay=0.1,
                                   warmup_steps=2, total_steps=6, max_grad_norm=1.0),
    "adamw_reachable": dict(name="adamw_bnb_8bit_f32", lr=1e-2, weight_decay=0.1,
                            reachable=True),
    "sgd_sched": dict(name="sgd", lr=1e-1, warmup_steps=1, total_steps=5),
}


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_steps_match_optax(case):
    kw = dict(OPTIMIZERS[case])
    name, lr = kw.pop("name"), kw.pop("lr")
    rng = np.random.default_rng(3)
    params = _params(rng)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("reachable", False):
        del jkw["reachable"], tkw["reachable"]
        factor = np.array([1.0, 0.0, 1.0], np.float32)

        def mask_of(as_array):
            def leaf(path, x):
                if path[-1] in ("a", "b", "fc1") and x.ndim == 3:
                    return as_array(factor.reshape(3, 1, 1))
                return True
            return leaf

        from multimodal_unlearning_tpu_torch.utils.pytree import tree_map_with_path
        tkw["reachable_mask"] = lambda p: tree_map_with_path(mask_of(torch.from_numpy), p)
        jkw["reachable_mask"] = lambda p: jax.tree_util.tree_map_with_path(
            lambda path, x: mask_of(jnp.asarray)(tuple(k.key for k in path), x), p)
    jtx = jo.make_optimizer(name, lr, **jkw)
    ttx = to.make_optimizer(name, lr, **tkw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32)
                             * (3.0 if step == 1 else 0.3), params)
        ju, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update(tree_map(torch.from_numpy, grads), tstate, tp)
        tp = to.apply_updates(tp, tu)
        # jax flattens both dict trees in sorted-key order
        got_leaves = jax.tree.leaves(tree_map(lambda t: t.numpy(), tp))
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jp)[0], got_leaves):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {path}")
    assert int(tstate["count"]) == 5
    if name != "sgd":
        adam = [s for s in jax.tree.leaves(jstate, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")][0]
        np.testing.assert_allclose(tstate["mu"]["projector"]["fc1"], adam.mu["projector"]["fc1"],
                                   atol=1e-6)
        np.testing.assert_allclose(tstate["nu"]["projector"]["fc1"], adam.nu["projector"]["fc1"],
                                   atol=1e-6)


def test_bf16_parameters_keep_bf16_moments_and_unported_optimizers_raise():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    tx = to.make_optimizer("adamw", 1e-2, weight_decay=0.01)
    st = tx.init(p)
    upd, st = tx.update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}, st, p)
    assert st["mu"]["w"].dtype == torch.bfloat16 and st["nu"]["w"].dtype == torch.bfloat16
    assert to.apply_updates(p, upd)["w"].dtype == torch.bfloat16
    # adamw_q8 (and its alias) keeps int8 / uint8 blocks with f32 scales
    for name in ("adamw_q8", "adamw_bnb_8bit"):
        st = to.make_optimizer(name, 1e-3).init(p)
        assert st["m"]["w"]["q"].dtype == torch.int8 and st["v"]["w"]["q"].dtype == torch.uint8
        assert st["m"]["w"]["scale"].dtype == torch.float32
    with pytest.raises(ValueError):
        to.make_optimizer("lion", 1e-3)
