"""The ``dots`` and ``dots_no_batch`` rematerialisation policies (CPU, f32):
XLA's ``checkpoint_dots`` and ``dots_with_no_batch_dims_saveable`` in the
JAX package, a selective checkpoint of each decoder layer in the port
(``models/llama._block_remat``).

- Values: logits and every LoRA gradient of a 256-wide decoder with LoRA
  (``lm_head`` included) under each policy equal the port's without remat
  bit for bit, and the JAX package's under the same policy to 2e-4 (the same
  f32 math in another summation order: logits to 2e-4, gradients to 2e-4 of
  each leaf's largest entry); on the plain attention, whose products have
  batch dimensions, so that the two policies differ.
- What each policy saves, counted by a dispatch mode over the backward
  pass: the matrix products that run there.  With no policy the layer's
  forward runs again, every product included; ``dots`` runs none of the
  forward's products again; ``dots_no_batch`` runs the attention's batched
  products (``bmm``) again and none of the weight products (``mm``).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import lora as jlora
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path

DECODER = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
               num_heads=4, num_kv_heads=2)
SCALE, TOL = 2.0, 2e-4
POLICIES = ("dots", "dots_no_batch")


class _Products(TorchDispatchMode):
    """Counts the aten matrix products that run while active."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm", "bmm", "baddbmm", "_int_mm"):
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def decoder():
    jcfg = jllama.LlamaConfig(**DECODER)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    adapters = jlora.init_lora(params["layers"], 4, jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    adapters["lm_head"] = {"a": jnp.asarray(rng.standard_normal((256, 4)).astype(np.float32) / 16),
                           "b": jnp.zeros((4, 512), jnp.float32)}
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, adapters)
    ids = rng.integers(3, 512, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, :4] = 0
    weight = rng.standard_normal((2, 12, 512)).astype(np.float32)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tconfig.LlamaConfig(**DECODER),
                             device="cpu")
    tad = convert.adapters_from_jax(jax.tree.map(np.asarray, adapters), device="cpu")
    return jcfg, params, adapters, model, tad, ids, mask, weight


def _port(model, adapters, ids, mask, weight, counter=None, **kw):
    out = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                lora=adapters, lora_scale=SCALE, compute_dtype=torch.float32, attn_impl="plain",
                **kw)
    loss = torch.sum(out["logits"] * torch.from_numpy(weight)) / weight.size
    leaves = tree_leaves_with_path(adapters)
    if counter is None:
        grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves])
    else:
        with counter:
            grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves])
    return out["logits"], {path: g for (path, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("policy", POLICIES)
def test_dots_policies_change_no_value_and_match_jax(decoder, policy):
    jcfg, params, adapters, model, tad, ids, mask, weight = decoder
    base, base_g = _port(model, tad, ids, mask, weight)
    got, got_g = _port(model, tad, ids, mask, weight, remat=True, remat_policy=policy)
    assert torch.equal(got, base)
    for path in base_g:
        assert torch.equal(got_g[path], base_g[path]), path

    def loss(lora):
        out = jllama.forward(params, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                             lora=lora, lora_scale=SCALE, compute_dtype=jnp.float32,
                             attn_impl="xla", remat=True, remat_policy=policy)
        return jnp.sum(out["logits"] * weight) / weight.size, out["logits"]

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(adapters)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    want_g = {tuple(k.key for k in p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(want_g)[0]}
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        w = want_g[path]
        np.testing.assert_allclose(g.numpy(), w, atol=TOL * np.abs(w).max(), rtol=0,
                                   err_msg="/".join(path))


def test_what_each_policy_saves(decoder):
    _, _, _, model, tad, ids, mask, weight = decoder
    fwd = _Products()
    with fwd:  # the forward's products, without remat (the same under each)
        model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), lora=tad,
              lora_scale=SCALE, compute_dtype=torch.float32, attn_impl="plain")
    bwd = {}
    # recompute whole layers (by default a recomputation stops at the last
    # tensor the backward needs, short of the layer's last products)
    with set_checkpoint_early_stop(False):
        for policy in ("off", None) + POLICIES:
            bwd[policy] = _Products()
            kw = {} if policy == "off" else dict(remat=True, remat_policy=policy)
            _port(model, tad, ids, mask, weight, counter=bwd[policy], **kw)
    plain = bwd["off"].counts
    # the layers' own products: every forward product but lm_head's and its
    # adapter's two (3 mm), which stand outside the checkpointed layers
    layer_mm, layer_bmm = fwd.counts["mm"] - 3, fwd.counts["bmm"]
    assert layer_mm > 0 and layer_bmm == 2 * DECODER["num_layers"]  # q.k and p.v per layer
    assert bwd[None].counts == plain + collections.Counter(mm=layer_mm, bmm=layer_bmm)
    assert bwd["dots"].counts == plain
    assert bwd["dots_no_batch"].counts == plain + collections.Counter(bmm=layer_bmm)
