"""Gradient-projection unlearning (``train/grad_proj.py``) against the JAX
package's (CPU, f32): the per-sequence mean CE, the per-layer projection
coefficients (a layer whose coefficient clamps to 0 passes through), and one
step each of ``grad_proj``, ``grad_proj_l2`` (the intended second-order
objective, its Hessian-vector products a layer at a time) and
``grad_proj_l2`` with ``ref_behavior`` on a 2-layer llama with
the same weights and batch, SGD at an lr that moves the weights by ~1 (0.5;
1e-3 for the second-order objective, whose gradient is ~500x larger), well
above f32 roundoff.  Also: a double backward through the attention kernels'
``FlashAttention`` raises instead of losing terms.

Tolerances: the CE 1e-6, the projection 1e-6, the updated leaves 1e-5
absolute, the losses after the step 1e-5.  ``grad_proj``'s global inner
product of the two gradients (a diagnostic) 1e-3 relative: the JAX step sums
it in f32 through XLA's reductions, 2e-4 away from an f64 sum of its own
gradients here, where the port's is within 1e-6 of that sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.cli import mm_forget as jforget
from multimodal_unlearning_tpu.config import registry as jregistry
from multimodal_unlearning_tpu.data import nlp as jnlp
from multimodal_unlearning_tpu.data.tokenizer import ByteTokenizer
from multimodal_unlearning_tpu.train import grad_proj as jgp
from multimodal_unlearning_tpu.train import optim as joptim
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import mm_forget as tforget
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.ops.attention import flash_attention
from multimodal_unlearning_tpu_torch.train import grad_proj as tgp
from multimodal_unlearning_tpu_torch.train import optim as toptim
from multimodal_unlearning_tpu_torch.utils.pytree import param_tree, tree_leaves_with_path

DK = jax.tree_util.DictKey


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_per_seq_mean_ce_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int64)
    labels[0, :4] = -100
    labels[2, 1:] = -100  # a row with no valid shifted label
    got = tgp.per_seq_mean_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jgp.per_seq_mean_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("stacked", [True, False], ids=["per_layer", "flat"])
def test_projection_coefficients_match_jax(stacked):
    rng = np.random.default_rng(1)
    n = rng.standard_normal((4, 5, 6)).astype(np.float32)
    p = rng.standard_normal((4, 5, 6)).astype(np.float32)
    n[1] = 0.3 * p[1] + 0.1 * n[1]  # agrees with retain: its coefficient clamps to 0
    n[2] = -0.7 * p[2] + 0.1 * n[2]  # conflicts: projected
    jpath = (DK("layers"), DK("wq")) if stacked else (DK("embed"),)
    tpath = ("layers", "wq") if stacked else ("embed",)
    got = torch.from_numpy(n.copy())
    tgp._project_(tpath, got, torch.from_numpy(p))
    got = got.numpy()
    want = np.asarray(jgp._project_leaf(jpath, jnp.asarray(n), jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if stacked:
        np.testing.assert_array_equal(got[1], n[1])
        assert np.abs(got[2] - n[2]).max() > 0.1


def _batch(max_length=96, rows=2):
    tags = {"question_start_tag": "[INST] ", "question_end_tag": " [/INST]", "answer_tag": ""}
    ds = jnlp.TextForgetDatasetQA("synthetic:n_persons=10", ByteTokenizer(), tags,
                                  max_length=max_length, loss_type="grad_proj", seed=0)
    return jnlp.text_collator([ds[i] for i in range(rows)])


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("method,ref", [("grad_proj", False), ("grad_proj_l2", False),
                                        ("grad_proj_l2", True)],
                         ids=["grad_proj", "l2_intended", "l2_ref_behavior"])
def test_one_step_matches_jax(method, ref):
    model_cfg = tregistry.get_model_identifiers("tiny-llama-test")
    kind, mcfg, model = tcommon.init_or_load_params(model_cfg, None, seed=0, device="cpu")
    jparams = jax.tree.map(lambda t: t.numpy().copy(), tcommon.model_tree(model))
    batch = _batch()
    lr = 1e-3 if method == "grad_proj_l2" and not ref else 0.5

    # the JAX package's step
    jmcfg = jcommon.build_model_config(jregistry.get_model_identifiers("tiny-llama-test"))
    japply = jforget.make_apply_fn("llama", jmcfg, attn_impl="xla", compute_dtype=jnp.float32)
    jtx = joptim.make_optimizer("sgd", lr)
    jstep = jgp.make_grad_proj_step(japply, jtx, method=method, gamma=0.7, ref_behavior=ref)
    jtr = jax.tree.map(jnp.asarray, jparams)
    jtr, _, jm = jstep(jtr, jtx.init(jtr), None, batch)

    # the port's, in place on the model's own parameters
    trainable = param_tree(model)
    for _, p in tree_leaves_with_path(trainable):
        p.requires_grad_(True)
    tapply = tforget.make_apply_fn(kind, mcfg, attn_impl="plain", compute_dtype=torch.float32,
                                   model=model)
    ttx = toptim.make_optimizer("sgd", lr)
    tstep = tgp.make_grad_proj_step(tapply, ttx, method=method, gamma=0.7, ref_behavior=ref,
                                    model=model, compute_dtype=torch.float32)
    tbatch = {s: {k: torch.from_numpy(np.asarray(v)).long() for k, v in part.items()}
              for s, part in batch.items()}
    trainable, _, tm = tstep(trainable, ttx.init(trainable), None, tbatch)

    for k in ("neg_loss", "pos_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    if method == "grad_proj":
        np.testing.assert_allclose(float(tm["inner_product"]), float(jm["inner_product"]),
                                   rtol=1e-3)
    got = _paths(tcommon.model_tree(model))
    want = _paths(jax.tree.map(np.asarray, jtr))
    assert got.keys() == want.keys()
    before = _paths(jparams)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=str(k))
    moved = max(float(np.abs(want[k] - before[k]).max()) for k in want)
    assert moved > 0.1  # the step moved the weights far past the tolerance


def test_double_backward_through_the_kernel_route_raises():
    """``create_graph=True`` through ``FlashAttention`` (impl "auto"): its
    backward is differentiable once, so the second derivative raises
    (before the fix the plain backward's terms through q, k and v were
    dropped without a word); the plain route gives it."""
    torch.manual_seed(0)
    x = torch.randn(1, 2, 6, 8, dtype=torch.float64, requires_grad=True)
    o = flash_attention(x, x, x, causal=True, impl="auto")
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad((o * x).sum(), x, create_graph=True)
    o = flash_attention(x, x, x, causal=True, impl="plain")
    (g,) = torch.autograd.grad((o * x).sum(), x, create_graph=True)
    (h,) = torch.autograd.grad(g.square().sum(), x)
    assert torch.isfinite(h).all() and h.abs().max() > 0
