"""Forget steps on Qwen2-VL (CPU, f32): the port's ``make_apply_fn`` +
``make_train_step`` against the JAX package's on ``tiny-qwen2vl-test``,
the same weights, adapters and batches (numpy, through
``models/convert.py``), ``grad_diff_forget_ce_retain_ce``:

- LoRA r 4 with the projector adapters on the merger, which sits inside
  the vision tower: the tower's blocks run without autograd and the merger
  with it, so the merger's adapters get their gradients (AdamW);
- ``LoRA.r=0``: the model's own parameters, the tower (merger included)
  frozen, as the forget CLI partitions them (SGD: over the decoder's 10^5
  entries, Adam's first step lr * g / (|g| + eps) turns an entry whose
  gradient is within f32 roundoff of eps into any value up to lr, so the
  update is held where it is a function of the gradient alone).

Tolerances: losses and the gradient norm to 1e-5 relative, updated leaves
to 1e-5 absolute (entries of ~0.1, f32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import mm_forget as jforget
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu.models import qwen2_vl as jqwen
from multimodal_unlearning_tpu.train import optim as joptim
from multimodal_unlearning_tpu.train import trainer as jtrainer
from multimodal_unlearning_tpu.utils import pytree as jpytree
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import qwen2_vl as tqwen
from multimodal_unlearning_tpu_torch.train import optim as toptim
from multimodal_unlearning_tpu_torch.train import trainer as ttrainer
from multimodal_unlearning_tpu_torch.utils.pytree import (
    tree_leaves, tree_leaves_with_path, tree_map)

FAMILY = "tiny-qwen2vl-test"
LOSS = "grad_diff_forget_ce_retain_ce"
SCALE, LR, WD = 4.0, 1e-3, 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    arch = get_model_identifiers(FAMILY).arch
    jcfg, tcfg = jqwen.QwenVLConfig.from_registry(arch), tconfig.QwenVLConfig.from_registry(arch)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(
        tqwen.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if str(p[-1].key).endswith("bias") else x, tree)
    n, g = jcfg.num_image_tokens, jcfg.default_grid

    def split():
        ids = rng.integers(3, 240, (2, n + 14)).astype(np.int32)
        ids[:, 2] = jcfg.vision_start_token_id
        ids[:, 3:3 + n] = jcfg.image_token_id
        ids[:, 3 + n] = jcfg.vision_end_token_id
        labels = ids.copy()
        labels[:, :n + 6] = -100
        mask = np.ones_like(ids)
        mask[1, :2] = 0
        return {"input_ids": ids, "attention_mask": mask, "labels": labels,
                "pixel_values": rng.standard_normal(
                    (2, g[1] * g[2], jcfg.vision.patch_dim)).astype(np.float32)}

    batch = {"forget": split(), "retain": split()}
    return jcfg, tcfg, tree, batch


def _step_fns(jcfg, tcfg, lora, opt="adamw", lr=LR):
    scale = SCALE if lora else 0.0
    japply = jforget.make_apply_fn("qwen2_vl", jcfg, lora_cfg=scale, compute_dtype=jnp.float32)
    tapply = tforget.make_apply_fn("qwen2_vl", tcfg, lora_cfg=scale, compute_dtype=torch.float32,
                                   model=None)
    jtx = joptim.make_optimizer(opt, lr, weight_decay=WD)
    ttx = toptim.make_optimizer(opt, lr, weight_decay=WD)
    combine = (lambda tr, fr: (fr, tr)) if lora else None
    jstep = jtrainer.make_train_step(japply, jtx, loss_type=LOSS, donate=False, combine=combine)
    return jstep, jtx, tapply, ttx, combine


def _flat(jtree):
    return {tuple(k.key for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _compare(tm, jm, tstate, jstate):
    for key in ("loss", "forget_loss", "retain_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    want = _flat(jstate.trainable)
    got = dict(tree_leaves_with_path(tstate.trainable))
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], atol=1e-5, rtol=0,
                                   err_msg="/".join(path))


def test_lora_step_with_merger_adapters_matches_jax(setup):
    jcfg, tcfg, tree, batch = setup
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(1)
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, jlora.init_model_lora(params, 4, jax.random.PRNGKey(1)))
    assert set(adapters["projector"]) == {"fc1", "fc2"}  # the merger's linears
    model = convert.from_jax(tree, tcfg, device="cpu")
    tadapters = convert.adapters_from_jax(jax.tree.map(np.asarray, adapters), device="cpu")
    jstep, jtx, tapply, ttx, combine = _step_fns(jcfg, tcfg, lora=True)
    tstep = ttrainer.make_train_step(tapply, ttx, loss_type=LOSS, combine=combine)
    jstate, jm = jstep(jtrainer.create_train_state(adapters, jtx), params, None,
                       jax.tree.map(jnp.asarray, batch))
    tstate, tm = tstep(ttrainer.create_train_state(tadapters, ttx), model, None,
                       tree_map(torch.from_numpy, batch))
    _compare(tm, jm, tstate, jstate)
    moved = tstate.trainable["projector"]["fc1"]["a"].detach().numpy()
    assert not np.allclose(moved, np.asarray(adapters["projector"]["fc1"]["a"]))


def test_full_parameter_step_matches_jax(setup):
    """LoRA.r=0: the decoder trains, the tower (merger included) stays."""
    jcfg, tcfg, tree, batch = setup
    params = jax.tree.map(jnp.asarray, tree)
    model = convert.from_jax(tree, tcfg, device="cpu")
    cli_cfg = {"freeze_vision_module": "true"}
    model_cfg = get_model_identifiers(FAMILY)
    trainable, frozen = tforget.dense_trainable(model, "qwen2_vl", model_cfg, cli_cfg)
    assert not tree_leaves(trainable["vision_tower"]) and not tree_leaves(frozen["language_model"])
    jfrozen, jtrain = jpytree.partition_tree(params, jpytree.path_predicate("vision_tower"))
    jstep, jtx, tapply, ttx, _ = _step_fns(jcfg, tcfg, lora=False, opt="sgd", lr=0.5)
    tapply = tforget.make_apply_fn("qwen2_vl", tcfg, compute_dtype=torch.float32, model=model)
    tstep = ttrainer.make_train_step(tapply, ttx, loss_type=LOSS)
    jstate, jm = jstep(jtrainer.create_train_state(jtrain, jtx), jfrozen, None,
                       jax.tree.map(jnp.asarray, batch))
    tstate, tm = tstep(ttrainer.create_train_state(trainable, ttx), frozen, None,
                       tree_map(torch.from_numpy, batch))
    _compare(tm, jm, tstate, jstate)
    # the tower never moved
    np.testing.assert_array_equal(model.vision_tower.merger.fc1.detach().numpy(),
                                  tree["vision_tower"]["merger"]["fc1"])
