"""The port's attention operators (plain versions, CPU) against the JAX
package's: ``flash_attention`` against the Pallas kernel in interpret mode
and against ``mha_reference``, its lse against ``_fwd``'s, and
``decode_attention`` against the Pallas decode kernel (live rows) and the
XLA path (an all-invalid row, where the two JAX routes differ).

All in f32 at tiny shapes, inputs from numpy; tolerance 1e-5 (the same f32
math summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.ops import attention as jattn
from multimodal_unlearning_tpu.ops import decode_attention as jdec
from multimodal_unlearning_tpu_torch.ops import attention as tattn
from multimodal_unlearning_tpu_torch.ops import decode_attention as tdec

TOL = 1e-5

CASES = {
    # B, Hq, Hkv, Sq, Sk, D, causal, q_offset, mask kind
    "noncausal_pad": (2, 4, 4, 16, 16, 16, False, 0, "right"),
    "causal_leftpad": (2, 4, 4, 16, 16, 16, True, 0, "left"),
    "gqa": (2, 4, 2, 16, 16, 16, True, 0, "left"),
    "q_offset": (2, 4, 2, 8, 24, 16, True, 16, "left"),
    "dead_rows": (2, 4, 4, 16, 16, 16, False, 0, "dead"),
}


def _inputs(B, Hq, Hkv, Sq, Sk, D, kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    mask = np.ones((B, Sk), np.int32)
    if kind == "right":
        mask[1, Sk - 5:] = 0
    elif kind == "left":
        mask[0, :5] = 0
    elif kind == "dead":
        mask[1] = 0
    return q, k, v, mask


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_jax(case):
    B, Hq, Hkv, Sq, Sk, D, causal, q_offset, kind = CASES[case]
    q, k, v, mask = _inputs(B, Hq, Hkv, Sq, Sk, D, kind)
    o, lse = tattn.flash_attention_lse(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), causal=causal, q_offset=q_offset)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    want_interp = jattn.flash_attention(*jargs, causal=causal, q_offset=q_offset,
                                        impl="interpret")
    want_ref = jattn.mha_reference(*jargs, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_interp), atol=TOL, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_ref), atol=TOL, rtol=0)
    # natural-log lse, as the JAX forward kernel emits it for the backward
    _, want_lse = jattn._fwd(
        jargs[0], jargs[1], jargs[2], jargs[3].reshape(B, 1, Sk), causal=causal,
        q_offset=q_offset, sm_scale=D ** -0.5, block_q=Sq, block_k=Sk, interpret=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL, rtol=0)
    if kind == "dead":
        assert np.all(o.numpy()[1] == 0) and np.all(lse.numpy()[1] == -1e30)


def test_flash_attention_rejects_unknown_impl():
    q, k, v, mask = _inputs(1, 2, 2, 4, 4, 8, "left")
    with pytest.raises(ValueError):
        tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), impl="xla")


@pytest.mark.parametrize("G", [1, 2], ids=["mha", "gqa"])
def test_decode_attention_matches_jax(G):
    rng = np.random.default_rng(1)
    L, B, Hkv, Smax, D, layer = 3, 3, 2, 64, 16, 2
    cache = {n: rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32)
             for n in ("k", "v")}
    q = rng.standard_normal((B, Hkv * G, 1, D), dtype=np.float32)
    valid = np.zeros((B, Smax), np.int32)
    valid[0, :10] = 1
    valid[1, 3:41] = 1
    valid[1, 50] = 1
    # row 2 stays all-invalid: an idle engine slot
    got = tdec.decode_attention(
        torch.from_numpy(q), {n: torch.from_numpy(a) for n, a in cache.items()}, layer,
        torch.from_numpy(valid)).numpy()
    jc = {n: jnp.asarray(a) for n, a in cache.items()}
    pallas = np.asarray(jdec.decode_attention(
        jnp.asarray(q), jc, layer, jnp.asarray(valid), impl="pallas", interpret=True))
    xla = np.asarray(jdec.decode_attention(
        jnp.asarray(q), jc, layer, jnp.asarray(valid), impl="xla"))
    np.testing.assert_allclose(got[:2], pallas[:2], atol=TOL, rtol=0)
    np.testing.assert_allclose(got, xla, atol=TOL, rtol=0)
    assert np.all(got[2] == 0)
