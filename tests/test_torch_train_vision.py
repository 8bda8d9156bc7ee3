"""Full-parameter steps with a trainable vision tower (CPU, f32): the port's
``make_apply_fn`` + ``make_train_step`` against the JAX package's at
``LoRA.r=0`` with ``freeze_vision_module=false``, the same weights and
batches (numpy, through ``models/convert.py``), one SGD step of
``grad_diff_forget_ce_retain_ce`` with weight decay on ``tiny-llava-test``
(CLIP ViT, the layers above ``vision_feature_layer`` out of reach),
``tiny-qwen2vl-test`` (full attention) and ``tiny-qwen25vl-test`` (windowed
attention, the window permutation, the merger) -- every leaf trains, the
tower's included, and the tower's leaves move.  Then LLaVA under AdamW with
its ``reachable_mask``: the tower block above ``vision_feature_layer`` and
``post_ln`` keep their values bit for bit (no gradient, no decay), the
blocks below move.  The forget CLI at ``LoRA.r=0
freeze_vision_module=false`` is held against the JAX CLI's saved model in
``tests/test_torch_cli_forget.py`` (case ``r0_vision``).

SGD at lr 0.5 (Adam's first step, lr * g / (|g| + eps), turns an entry whose
gradient is within f32 roundoff of eps into any value up to lr).
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
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu.models import qwen2_vl as jqwen
from multimodal_unlearning_tpu.train import optim as joptim
from multimodal_unlearning_tpu.train import trainer as jtrainer
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llava as tllava
from multimodal_unlearning_tpu_torch.models import qwen2_vl as tqwen
from multimodal_unlearning_tpu_torch.train import optim as toptim
from multimodal_unlearning_tpu_torch.train import trainer as ttrainer
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path, tree_map

LOSS = "grad_diff_forget_ce_retain_ce"
FAMILIES = {"tiny-llava-test": "llava", "tiny-qwen2vl-test": "qwen2_vl",
            "tiny-qwen25vl-test": "qwen2_vl"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(family):
    kind = FAMILIES[family]
    arch = get_model_identifiers(family).arch
    jmod, tmod = (jllava, tllava) if kind == "llava" else (jqwen, tqwen)
    cfg_cls = "LlavaConfig" if kind == "llava" else "QwenVLConfig"
    jcfg = getattr(jmod, cfg_cls).from_registry(arch)
    tcfg = getattr(tconfig, cfg_cls).from_registry(arch)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(
        tmod.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")))
    # biases start at zero: give them values, so that their gradients show
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if str(p[-1].key).endswith("bias") else x, tree)
    n = jcfg.num_image_tokens

    def split():
        ids = rng.integers(3, 240, (2, n + 14)).astype(np.int32)
        ids[:, 3:3 + n] = jcfg.image_token_id
        if kind == "qwen2_vl":
            ids[:, 2] = jcfg.vision_start_token_id
            ids[:, 3 + n] = jcfg.vision_end_token_id
            g = jcfg.default_grid
            pix = rng.standard_normal((2, g[1] * g[2], jcfg.vision.patch_dim))
        else:
            size = jcfg.vision.image_size
            pix = rng.standard_normal((2, size, size, 3))
        labels = ids.copy()
        labels[:, :n + 6] = -100
        mask = np.ones_like(ids)
        mask[1, :2] = 0
        return {"input_ids": ids, "attention_mask": mask, "labels": labels,
                "pixel_values": pix.astype(np.float32)}

    return kind, jcfg, tcfg, tree, {"forget": split(), "retain": split()}


def _flat(jtree):
    return {tuple(k.key for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trainable_tower_step_matches_jax(family):
    kind, jcfg, tcfg, tree, batch = _setup(family)
    model = convert.from_jax(tree, tcfg, device="cpu")
    trainable, frozen = tcommon.dense_trainable(model, kind, get_model_identifiers(family),
                                                {"freeze_vision_module": "false"})
    assert frozen is None and trainable["vision_tower"]
    jreach = treach = None
    if kind == "llava":
        jreach = lambda p: jllava.reachable_mask(p, jcfg)  # noqa: E731
        treach = lambda p: tllava.reachable_mask(p, tcfg)  # noqa: E731
    jtx = joptim.make_optimizer("sgd", 0.5, weight_decay=0.01, reachable_mask=jreach)
    ttx = toptim.make_optimizer("sgd", 0.5, weight_decay=0.01, reachable_mask=treach)
    japply = jforget.make_apply_fn(kind, jcfg, compute_dtype=jnp.float32)
    tapply = tforget.make_apply_fn(kind, tcfg, compute_dtype=torch.float32, model=model)
    jstep = jtrainer.make_train_step(japply, jtx, loss_type=LOSS, donate=False)
    tstep = ttrainer.make_train_step(tapply, ttx, loss_type=LOSS)
    params = jax.tree.map(jnp.asarray, tree)
    jstate, jm = jstep(jtrainer.create_train_state(params, jtx), None, None,
                       jax.tree.map(jnp.asarray, batch))
    tstate, tm = tstep(ttrainer.create_train_state(trainable, ttx), None, None,
                       tree_map(torch.from_numpy, batch))
    for key in ("loss", "forget_loss", "retain_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    want, before = _flat(jstate.trainable), _flat(tree)
    got = dict(tree_leaves_with_path(tstate.trainable))
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], atol=1e-5, rtol=0,
                                   err_msg="/".join(path))
    # the tower trained: its patch embedding and its first block moved
    # well past the tolerance
    tower = {p: x for p, x in want.items() if p[0] == "vision_tower"}
    first = [p for p in tower if p[-1] in ("q_proj", "patch_embed")]
    assert first and all(np.abs(tower[p] - before[p]).max() > 1e-4 for p in first)


def test_llava_unreachable_tower_blocks_untouched():
    """AdamW with decay and LLaVA's ``reachable_mask``: the block above
    ``vision_feature_layer`` (-2 of 2: block 1) and ``post_ln`` get no
    gradient and no decay; block 0 moves."""
    kind, _, tcfg, tree, batch = _setup("tiny-llava-test")
    model = convert.from_jax(tree, tcfg, device="cpu")
    trainable, _ = tcommon.dense_trainable(model, kind, get_model_identifiers("tiny-llava-test"),
                                           {"freeze_vision_module": "false"})
    ttx = toptim.make_optimizer("adamw", 1e-3, weight_decay=0.1,
                                reachable_mask=lambda p: tllava.reachable_mask(p, tcfg))
    tapply = tforget.make_apply_fn(kind, tcfg, compute_dtype=torch.float32, model=model)
    tstep = ttrainer.make_train_step(tapply, ttx, loss_type=LOSS)
    tstate, tm = tstep(ttrainer.create_train_state(trainable, ttx), None, None,
                       tree_map(torch.from_numpy, batch))
    assert np.isfinite(float(tm["loss"]))
    before = _flat(tree)
    after = dict(tree_leaves_with_path(tstate.trainable["vision_tower"]))
    for path, leaf in after.items():
        old, new = before[("vision_tower",) + path], leaf.detach().numpy()
        if path[0] == "post_ln":
            np.testing.assert_array_equal(new, old, err_msg="/".join(path))
        elif path[0] == "layers":
            np.testing.assert_array_equal(new[1], old[1], err_msg="/".join(path))
            assert np.abs(new[0] - old[0]).max() > 1e-4, "/".join(path)
