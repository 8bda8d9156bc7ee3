"""Gradients of the port's ``flash_attention`` (CPU, f32) against the JAX
package's: the ``FlashAttention`` Function's backward (the plain versions of
kernels B2/B3, from the saved o and lse) and ordinary autograd through
``impl="plain"``, both against ``jax.vjp`` of the JAX ``flash_attention`` with
``impl="interpret"`` (the Pallas backward kernels in interpret mode) and with
``impl="xla"`` (autodiff of ``mha_reference``; odd lengths too).

Inputs from numpy, f32; tolerance 2e-5 absolute on gradients of size ~1 (the
same f32 math summed in another order; the saved lse is f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.ops import attention as jattn
from multimodal_unlearning_tpu_torch.ops import attention as tattn

TOL = 2e-5

CASES = {
    # B, Hq, Hkv, Sq, Sk, D, causal, q_offset, mask kind, JAX impls
    "noncausal_pad": (2, 4, 4, 16, 16, 16, False, 0, "right", ("interpret",)),
    "causal_leftpad": (2, 4, 4, 16, 16, 16, True, 0, "left", ("interpret",)),
    "gqa": (2, 4, 2, 16, 16, 16, True, 0, "left", ("interpret", "xla")),
    "q_offset": (2, 4, 2, 8, 24, 16, True, 16, "left", ("interpret", "xla")),
    "dead_rows": (2, 4, 4, 16, 16, 16, False, 0, "dead", ("interpret", "xla")),
    "aligned_128": (1, 2, 1, 128, 256, 64, True, 128, "left", ("interpret",)),
    "odd_lengths": (2, 6, 3, 13, 19, 8, True, 6, "left", ("xla",)),
}


def _inputs(B, Hq, Hkv, Sq, Sk, D, kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    g = rng.standard_normal((B, Hq, Sq, D), dtype=np.float32)
    mask = np.ones((B, Sk), np.int32)
    if kind == "right":
        mask[1, Sk - 5:] = 0
    elif kind == "left":
        mask[0, :5] = 0
    elif kind == "dead":
        mask[1] = 0
    return q, k, v, g, mask


def _torch_grads(q, k, v, g, mask, causal, q_offset, impl):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv, torch.from_numpy(mask), causal=causal,
                              q_offset=q_offset, impl=impl)
    return [t.numpy() for t in torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_grads_match_jax(case):
    B, Hq, Hkv, Sq, Sk, D, causal, q_offset, kind, jimpls = CASES[case]
    q, k, v, g, mask = _inputs(B, Hq, Hkv, Sq, Sk, D, kind)
    via_function = _torch_grads(q, k, v, g, mask, causal, q_offset, "auto")
    via_autograd = _torch_grads(q, k, v, g, mask, causal, q_offset, "plain")
    for jimpl in jimpls:
        _, vjp = jax.vjp(
            lambda a, b, c: jattn.flash_attention(a, b, c, jnp.asarray(mask), causal=causal,
                                                  q_offset=q_offset, impl=jimpl),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
        for name, a, b, w in zip(("dq", "dk", "dv"), via_function, via_autograd, want):
            np.testing.assert_allclose(a, w, atol=TOL, rtol=0, err_msg=f"{name} {jimpl} Function")
            np.testing.assert_allclose(b, w, atol=TOL, rtol=0, err_msg=f"{name} {jimpl} plain")
    if kind == "dead":
        assert np.all(via_function[0][1] == 0)  # dq of rows that saw no key


def test_lse_output_carries_no_gradient():
    q, k, v, g, mask = _inputs(1, 2, 2, 8, 8, 8, "left")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = tattn.flash_attention_lse(tq, tk, tv, torch.from_numpy(mask), causal=True)
    assert o.requires_grad and not lse.requires_grad


def test_backward_wrappers_split_as_the_kernels_do():
    """``flash_bwd_dq`` / ``flash_bwd_dkv`` (the wrappers of B2 and B3) give,
    from a saved o, lse and delta, what the whole backward gives."""
    q, k, v, g, mask = _inputs(2, 4, 2, 8, 24, 16, "left", seed=3)
    tq, tk, tv, tg, tm = (torch.from_numpy(a) for a in (q, k, v, g, mask))
    kw = dict(causal=True, q_offset=16)
    o, lse = tattn.flash_attention_lse(tq, tk, tv, tm, **kw)
    delta = (tg * o).sum(-1)
    dq = tattn.flash_bwd_dq(tq, tk, tv, tm, tg, lse, delta, **kw)
    dk, dv = tattn.flash_bwd_dkv(tq, tk, tv, tm, tg, lse, delta, **kw)
    want = tattn.flash_attention_bwd(tq, tk, tv, tm, tg, o, lse, **kw)
    for a, w in zip((dq, dk, dv), want):
        assert torch.equal(a, w)
    assert dk.shape == tk.shape and dq.shape == tq.shape


def test_backward_has_no_fallback_off_the_cpu():
    q = torch.empty((1, 2, 4, 8), device="meta")
    lse = torch.empty((1, 2, 4, 1), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tattn.flash_bwd_dq(q, q, q, None, q, lse, lse)
    with pytest.raises(RuntimeError, match="no kernel"):
        tattn.flash_bwd_dkv(q, q, q, None, q, lse, lse)
