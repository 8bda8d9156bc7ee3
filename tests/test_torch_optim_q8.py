"""``adamw_q8`` and the in-place (dense) optimizer step of the port (CPU).

- ``adamw_q8`` against the JAX package's over 5 steps on a tree with a leaf
  that is not a multiple of 256 entries, an all-zero leaf with zero
  gradients, bf16 and f32 parameters, a per-layer decay mask, the clip and
  the schedule.  Parameters and dequantized moments to 1e-6 absolute: the
  same f32 elementwise math on the same gradients; the quantized values must
  be equal (a flipped rounding would show as a whole quantum).  The bf16
  leaf sits in the cases without the clip: optax's global norm rounds a
  bf16 leaf's squares and its sum of squares to bf16 (the port keeps them in
  f32), which moves the clip scale by up to ~2**-9 and every later update
  with it.
- ``step_`` (in place, a stacked leaf a layer slice at a time) equals
  ``update`` + ``apply_updates`` (the whole leaf at once) bit for bit, and
  writes nothing where ``ok`` is false.
- A partitioned tree (``None`` slots, as ``partition_tree`` leaves them)
  through ``init``, ``update``, ``step_`` and a train-state checkpoint.
- A kill-and-resume of the forget CLI at ``LoRA.r=0`` with ``adamw_q8`` and
  RMU's control vector resumes bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from multimodal_unlearning_tpu.train import optim as jo
from multimodal_unlearning_tpu.utils import pytree as jpytree
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.train import checkpoints as tckpt
from multimodal_unlearning_tpu_torch.train import optim as to
from multimodal_unlearning_tpu_torch.train import trainer as tt
from multimodal_unlearning_tpu_torch.utils import pytree as tpytree
from multimodal_unlearning_tpu_torch.utils.pytree import (
    tree_leaves, tree_leaves_with_path, tree_map)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: under parallel
    test workers, torch's default of one thread per core oversubscribes the
    machine and its small ops slow down by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {  # the leaves held in bf16 (see the module docstring) under "bf16"
    "plain": dict(name="adamw_q8", lr=1e-2, bf16=("head",)),
    "decay_clip_sched": dict(name="adamw_q8", lr=1e-2, weight_decay=0.1, warmup_steps=2,
                             total_steps=6, max_grad_norm=1.0, reachable=True, bf16=()),
    "bnb_alias_decay_mask": dict(name="adamw_bnb_8bit", lr=3e-3, weight_decay=0.05,
                                 reachable=True, bf16=("head",)),
}


def _params(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "layers": {"w": f(3, 8, 40),  # 960 entries: the last block padded
                   "input_layernorm": f(3, 8)},
        "zero": np.zeros((300,), np.float32),
        "head": f(2, 256),
    }


def _reach(as_array):
    used = np.array([1.0, 0.0, 1.0], np.float32)

    def leaf(path, x):
        if path == ("layers", "w"):
            return as_array(used.reshape(3, 1, 1))
        return True
    return leaf


def _grads(rng, params, step):
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32)
                     * (3.0 if step == 1 else 0.3), params)
    g["zero"] = np.zeros_like(g["zero"])
    return g


def _jcast(tree, bf16):
    return {k: _jcast(v, bf16) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32) for k, v in tree.items()}


def _tcast(tree, bf16):
    return {k: _tcast(v, bf16) if isinstance(v, dict) else
            torch.from_numpy(v).to(torch.bfloat16 if k in bf16 else torch.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_q8_matches_jax(case):
    kw = dict(CASES[case])
    name, lr, bf16 = kw.pop("name"), kw.pop("lr"), kw.pop("bf16")
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("reachable", False):
        del jkw["reachable"], tkw["reachable"]
        tkw["reachable_mask"] = lambda p: tpytree.tree_map_with_path(_reach(torch.from_numpy), p)
        jkw["reachable_mask"] = lambda p: jax.tree_util.tree_map_with_path(
            lambda path, x: _reach(jnp.asarray)(tuple(k.key for k in path), x), p)
    rng = np.random.default_rng(3)
    params = _params(rng)
    jtx, ttx = jo.make_optimizer(name, lr, **jkw), to.make_optimizer(name, lr, **tkw)
    jp, tp = _jcast(params, bf16), _tcast(params, bf16)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        grads = _grads(rng, params, step)
        ju, jstate = jtx.update(_jcast(grads, bf16), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update(_tcast(grads, bf16), tstate, tp)
        tp = to.apply_updates(tp, tu)
        want = {tuple(k.key for k in p): x for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
        for path, leaf in tree_leaves_with_path(tp):
            assert leaf.dtype == (torch.bfloat16 if path[-1] in bf16 else torch.float32)
            np.testing.assert_allclose(leaf.float().numpy(), np.asarray(want[path], np.float32),
                                       atol=1e-6, rtol=0, err_msg=f"step {step} {path}")
    q8 = [s for s in jax.tree.leaves(jstate, is_leaf=lambda x: hasattr(x, "m"))
          if hasattr(s, "m")][0]
    assert int(tstate["count"]) == int(q8.count) == 5
    for key in ("m", "v"):
        jtree = getattr(q8, key)
        for path, leaf in tree_leaves_with_path(tp):
            jq = jtree
            for k in path:
                jq = jq[k]
            tq = tstate[key]
            for k in path:
                tq = tq[k]
            assert tq["q"].dtype == (torch.int8 if key == "m" else torch.uint8)
            np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq.q))
            np.testing.assert_allclose(
                to.dequantize_moment(tq, leaf.shape).numpy(),
                np.asarray(jo._dequantize(jq.q, jq.scale, leaf.shape)), atol=1e-6, rtol=0,
                err_msg=f"{key} {path}")
    # the all-zero leaf stays zero, its moments zero with unit scales
    assert not tp["zero"].any() and not tstate["m"]["zero"]["q"].any()


def _stacked(rng, bf16):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    tree = {"layers": {"w": f(4, 16, 32), "odd": f(4, 3, 5), "norm": f(4, 16)},
            "emb": f(10, 8)}
    if bf16:
        tree["layers"]["w"] = tree["layers"]["w"].bfloat16()
    return tree


def _reach4(p):
    return tpytree.tree_map_with_path(
        lambda path, x: torch.tensor([1.0, 0.0, 1.0, 1.0]).reshape(4, 1, 1)
        if path == ("layers", "w") else True, p)


def _steps(name, tree, inplace, n=3):
    """``n`` steps of ``name`` (decay with a per-layer mask, the schedule,
    the clip) on a copy of ``tree``: (params, state) after them."""
    tx = to.make_optimizer(name, 1e-2, weight_decay=0.1, warmup_steps=1, total_steps=5,
                           max_grad_norm=0.5, reachable_mask=_reach4)
    params = tree_map(torch.clone, tree)
    state = tx.init(params)
    for step in range(n):
        grads = tree_map(lambda x: torch.randn(x.shape, generator=torch.Generator().manual_seed(
            step)).to(x.dtype) * 2, params)
        if inplace:
            tx.step_(grads, state, params, ok=torch.tensor(True))
        else:
            upd, state = tx.update(grads, state, params)
            params = to.apply_updates(params, upd)
    return tx, params, state


def _assert_same_bits(a, b):
    for (path, x), (_, y) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("name", ["adamw", "adamw_q8", "sgd"])
def test_chunked_inplace_step_equals_whole_leaf_step(name, monkeypatch):
    """``step_`` walking every stacked leaf a layer slice at a time (the 16x32
    slices are two 256-blocks each; the 3x5 slices are not block-aligned, so
    adamw_q8 takes that leaf whole) equals the same step on whole leaves bit
    for bit, over 3 steps, bf16 and f32 leaves; a step with ``ok`` false
    then changes no bit and does not advance the count."""
    tree = _stacked(np.random.default_rng(5), bf16=True)
    _, p_whole, s_whole = _steps(name, tree, inplace=True)
    monkeypatch.setattr(to, "CHUNK_ELEMS", 0)
    tx, p_chunk, s_chunk = _steps(name, tree, inplace=True)
    _assert_same_bits({"p": p_chunk, "s": s_chunk}, {"p": p_whole, "s": s_whole})
    bad = tree_map(lambda x: torch.full_like(x, float("nan")), p_chunk)
    tx.step_(bad, s_chunk, p_chunk, ok=torch.tensor(False))
    _assert_same_bits({"p": p_chunk, "s": s_chunk}, {"p": p_whole, "s": s_whole})
    assert int(s_chunk["count"]) == 3


@pytest.mark.parametrize("name", ["adamw", "adamw_q8", "sgd"])
def test_inplace_step_equals_functional_update(name, monkeypatch):
    """``step_`` (in place, by layer slices) equals ``update`` +
    ``apply_updates`` bit for bit over 3 steps.  The bf16 leaf only under
    adamw_q8, whose state has the same dtypes on both paths: the functional
    AdamW keeps the f32 moments that clipped (f32) gradients give a bf16
    leaf, as JAX does, while the in-place step rounds them into the
    parameter-dtype moments it holds (``ROADMAP.md`` queue 2)."""
    monkeypatch.setattr(to, "CHUNK_ELEMS", 0)
    tree = _stacked(np.random.default_rng(5), bf16=name == "adamw_q8")
    _, p_fun, s_fun = _steps(name, tree, inplace=False)
    _, p_in, s_in = _steps(name, tree, inplace=True)
    _assert_same_bits({"p": p_in, "s": s_in}, {"p": p_fun, "s": s_fun})


def test_partition_and_merge_match_jax():
    rng = np.random.default_rng(0)
    tree = {"vision_tower": {"layers": {"w": rng.standard_normal((2, 3))}, "post_ln": {
        "scale": rng.standard_normal(3)}}, "language_model": {"norm": rng.standard_normal(3)},
        "projector": {"fc1": rng.standard_normal((3, 3))}}
    pred = "vision_tower"
    jm, jr = jpytree.partition_tree(tree, jpytree.path_predicate(pred))
    tm, tr = tpytree.partition_tree(tree, tpytree.path_predicate(pred))
    assert jax.tree.structure(tm, is_leaf=lambda x: x is None) == jax.tree.structure(
        jm, is_leaf=lambda x: x is None)
    assert [p for p, _ in tree_leaves_with_path(tm)] == [("vision_tower", "layers", "w"),
                                                         ("vision_tower", "post_ln", "scale")]
    assert tr["vision_tower"]["layers"]["w"] is None and jr["vision_tower"]["layers"]["w"] is None
    merged = tpytree.merge_trees(tr, tm)
    assert all(a is b for a, b in zip(tree_leaves(merged), tree_leaves(tree)))
    assert tree_map(lambda x: x.shape, tm)["language_model"]["norm"] is None


@pytest.mark.parametrize("name", ["adamw", "adamw_q8"])
def test_partitioned_tree_through_optimizer_and_checkpoint(name, tmp_path):
    """``None`` slots stay ``None`` through init, the global norm, the clip,
    ``update``, ``step_`` and a train-state round trip; only the real leaves
    are written and read."""
    rng = np.random.default_rng(1)
    full = {"vision_tower": {"w": torch.randn(3, 4)},
            "language_model": {"layers": {"q": torch.randn(2, 4, 4)}, "norm": torch.ones(4)}}
    frozen, trainable = tpytree.partition_tree(full, tpytree.path_predicate("vision_tower"))
    for p in tree_leaves(trainable):
        p.requires_grad_(True)
    tx = to.make_optimizer(name, 1e-2, weight_decay=0.1, max_grad_norm=1.0)
    state = tt.create_train_state(trainable, tx, control_vec=torch.rand(2, 1, 4),
                                  keep_init=True)
    grads = tree_map(lambda x: torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)), trainable)
    assert grads["vision_tower"]["w"] is None
    assert torch.isfinite(to.global_norm(grads))
    upd, _ = tx.update(grads, state.opt_state, trainable)
    assert upd["vision_tower"]["w"] is None and upd["language_model"]["norm"].shape == (4,)
    tx.step_(grads, state.opt_state, trainable)
    moments = state.opt_state["m" if name == "adamw_q8" else "mu"]
    assert moments["vision_tower"]["w"] is None
    tckpt.save_train_state(tmp_path, 1, state)
    template = tt.create_train_state(
        tree_map(lambda x: torch.zeros_like(x).requires_grad_(), trainable), tx,
        control_vec=torch.zeros(2, 1, 4), keep_init=True)
    back = tckpt.restore_train_state(tmp_path, 1, template)
    fields = lambda st: {k: getattr(st, k) for k in ("step", "trainable", "opt_state",
                                                      "control_vec", "init_trainable")}
    pairs = list(zip(tree_leaves_with_path(fields(back)), tree_leaves_with_path(fields(state))))
    assert len(pairs) == len(tckpt._state_flat(state))
    for (path, a), (_, b) in pairs:
        assert torch.equal(a.detach(), b.detach()), path
    assert back.trainable["vision_tower"]["w"] is None
    assert tpytree.merge_trees(back.trainable, frozen)["vision_tower"]["w"] is full[
        "vision_tower"]["w"]


FORGET_DIR = tregistry.config_dir() / "mm"


def test_forget_cli_r0_q8_rmu_kill_and_resume(tmp_path, monkeypatch):
    """LoRA.r=0 (the vision tower frozen), adamw_q8 and RMU (control vector
    in the train state) on a tiny LLaVA whose decoder has the 8 layers RMU
    reads: killed right after the epoch's train-state save and resumed, the
    losses and the saved model equal the uninterrupted run's bit for bit."""
    reg = yaml.safe_load((tregistry.config_dir() / "model_config.yaml").read_text())
    entry = reg["tiny-llava-test"]
    entry["arch"]["decoder"]["num_layers"] = 8
    monkeypatch.setitem(tregistry.PRESETS, "tiny-llava-test", entry)

    def cfg(out, **extra):
        args = ["model_family=tiny-llava-test", "model_path=null",
                "forget_data_path=synthetic:n_persons=10,qa_per_person=4",
                "retain_data_path=synthetic:n_persons=10,qa_per_person=4", "forget_loss=rmu",
                "LoRA.r=0", "optimizer=adamw_q8", "lr=1e-3", "batch_size=2",
                "gradient_accumulation_steps=1", "num_epochs=1.5", "max_length=128",
                "dtype=float32", f"save_dir={tmp_path / out}", "+device=cpu"]
        return tload(FORGET_DIR, "forget", args + [f"+{k}={v}" for k, v in extra.items()])

    full = tforget.run(cfg("full"))
    assert len(full) == 6
    real_save = tckpt.TrainStateCheckpointer.save

    def save_once_then_die(self, step, state):
        real_save(self, step, state)
        self.wait()
        raise KeyboardInterrupt("preempted right after the epoch checkpoint")

    with monkeypatch.context() as m:
        m.setattr(tckpt.TrainStateCheckpointer, "save", save_once_then_die)
        with pytest.raises(KeyboardInterrupt):
            tforget.run(cfg("pre"))
    assert tckpt.latest_train_state_step(tmp_path / "pre" / "train_state") == 4
    from safetensors.torch import load_file
    saved = load_file(str(tmp_path / "pre" / "train_state" / "step_4" / "train_state.safetensors"))
    assert saved["control_vec"].shape == (2, 1, 64)
    assert saved["opt_state/m/language_model/layers/q_proj/q"].dtype == torch.int8
    assert saved["opt_state/v/language_model/layers/q_proj/q"].dtype == torch.uint8
    assert not any(k.startswith("trainable/vision_tower") for k in saved)
    resumed = tforget.run(cfg("pre", resume_from_checkpoint=True))
    res, ful = {h["step"]: h["loss"] for h in resumed}, {h["step"]: h["loss"] for h in full}
    assert min(res) == 5 and max(res) == 6
    for s in res:
        assert res[s] == ful[s], s
    a = load_file(str(tmp_path / "full" / "model.safetensors"))
    b = load_file(str(tmp_path / "pre" / "model.safetensors"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("inplace", [False, True], ids=["lora_functional", "dense_inplace"])
def test_q8_moment_dtypes_survive_the_nonfinite_guard(inplace):
    """The moments keep int8 / uint8 through a finite step and a skipped
    one, on both step paths.  (The JAX package's guard promotes its int8-
    initialised second moment and the first update's uint8 to int16, after
    which ``_dequantize`` reads quartic-root codes as linear ones.)"""
    w = torch.randn(2, 16, 32).requires_grad_()
    trainable = {"w": w}

    def apply_fn(params, part, capture_layer=None):
        leaf = params["w"] if isinstance(params, dict) else params[1]["w"]
        y = torch.einsum("bi,lij->bj", part["x"], leaf)
        return {"logits": torch.stack([y, y], 1), "captured": None}

    tx = to.make_optimizer("adamw_q8", 1e-2)
    step = tt.make_train_step(apply_fn, tx, loss_type="retain_ft",
                              combine=None if inplace else (lambda tr, fr: (fr, tr)))
    state = tt.create_train_state(trainable, tx)
    good = {"retain": {"x": torch.randn(3, 16), "labels": torch.randint(0, 32, (3, 2))}}
    bad = {"retain": {"x": torch.full((3, 16), float("nan")),
                      "labels": good["retain"]["labels"]}}
    for batch, skipped in ((good, 0), (bad, 1), (good, 0)):
        state, m = step(state, None, None, batch)
        assert int(m["skipped_nonfinite"]) == skipped
        assert state.opt_state["m"]["w"]["q"].dtype == torch.int8
        assert state.opt_state["v"]["w"]["q"].dtype == torch.uint8
    assert int(state.opt_state["count"]) == 2 and int(state.step) == 3
    assert (state.trainable["w"] is w) == inplace
