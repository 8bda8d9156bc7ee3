"""The port's int8 quantization (CPU) against the JAX package's on the same
numpy inputs: ``quantize_leaf``, ``dequantize_leaf``, ``embed_lookup``,
``quantize_tree`` / ``quantize_tree_inplace`` on a dict tree and on a module,
``int8_matmul`` and ``int8_matmul_group`` forward and both backward routes
(straight-through dequant, int8 dx).

Quantized values must be equal (``round`` is half-to-even on both sides, and
the divisions are the same f32 operations); scales and float results agree to
f32 roundoff: 1e-6 relative.  The int8 products are exact integers on both
sides, so W8A8 outputs differ only by the order of the two f32 scale
multiplications: 1e-6 relative too.  The straight-through backward is an f32
matmul over 320 terms, summed in another order: 2e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch.models.params import ParamTree
from multimodal_unlearning_tpu_torch.utils import quantize as tq

RTOL = 1e-6


def _close(got, want, atol=0.0, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture
def weights():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 256, 320), dtype=np.float32)
    w[0, :, 7] = 0.0  # an all-zero output channel: scale 1, not 0
    return w


def test_quantize_leaf_and_dequantize(weights):
    want = jq.quantize_leaf(jnp.asarray(weights))
    got = tq.quantize_leaf(torch.from_numpy(weights))
    assert got["q"].dtype == torch.int8 and got["s"].shape == (2, 1, 320)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    _close(got["s"], want["s"])
    assert got["s"][0, 0, 7] == 1.0
    _close(tq.dequantize_leaf(got, torch.float32), jq.dequantize_leaf(want, jnp.float32))
    assert tq.dequantize_leaf(got).dtype == torch.bfloat16
    assert tq.is_qtensor(got) and not tq.is_qtensor({"q": 1})


def test_embed_lookup(weights):
    table = weights[0]
    ids = np.random.default_rng(1).integers(0, 256, (2, 9))
    want = jq.embed_lookup(jq.quantize_leaf(jnp.asarray(table)), jnp.asarray(ids))
    got = tq.embed_lookup(tq.quantize_leaf(torch.from_numpy(table)), torch.from_numpy(ids))
    _close(got, want)


def test_quantize_tree_matches_jax_and_inplace(weights):
    tree = {"layers": {"q_proj": weights, "norm": np.ones((2, 256), np.float32)},
            "small": weights[0, :, :64].copy(), "embed": weights[1]}
    want = jq.quantize_tree(jax.tree.map(jnp.asarray, tree))
    ttree = lambda: {"layers": {k: torch.from_numpy(v.copy()) for k, v in tree["layers"].items()},
                     "small": torch.from_numpy(tree["small"]), "embed": torch.from_numpy(tree["embed"])}
    src = ttree()
    got = tq.quantize_tree(src)
    assert isinstance(src["layers"]["q_proj"], torch.Tensor)  # the input is left alone
    inplace_src = ttree()
    inplace = tq.quantize_tree_inplace(inplace_src)
    assert inplace is inplace_src
    for t in (got, inplace):
        assert tq.is_qtensor(t["layers"]["q_proj"]) and tq.is_qtensor(t["embed"])
        # narrower than 256 or 1-D: left as it is (_want_quant)
        assert isinstance(t["small"], torch.Tensor) and isinstance(t["layers"]["norm"], torch.Tensor)
        np.testing.assert_array_equal(t["layers"]["q_proj"]["q"].numpy(),
                                      np.asarray(want["layers"]["q_proj"]["q"]))
        _close(t["embed"]["s"], want["embed"]["s"])
    assert tq.tree_nbytes(got) == jq.tree_nbytes(want)
    # bits=4 quantizes now (grouped int4, tests/test_torch_int4.py); other widths raise
    assert tq.is_int4(tq.quantize_tree(ttree(), bits=4)["embed"])
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_tree(ttree(), bits=3)
    with pytest.raises(TypeError):
        tq.quantize_tree_inplace({"a": [torch.zeros(2)]})


def test_quantize_tree_inplace_on_a_module(weights):
    mod = ParamTree({"layers": {"w": (2, 256, 320), "norm": (2, 256)}, "head": (256, 320)},
                    device="cpu", dtype=torch.float32)
    with torch.no_grad():
        mod.layers.w.copy_(torch.from_numpy(weights))
        mod.head.copy_(torch.from_numpy(weights[1]))
        mod.layers.norm.fill_(1.0)
    before = tq.tree_nbytes(mod)
    out = tq.quantize_tree_inplace(mod)
    assert out is mod and isinstance(mod.layers.w, tq.QTensor) and isinstance(mod.head, tq.QTensor)
    assert isinstance(mod.layers.norm, torch.nn.Parameter)
    want = jq.quantize_leaf(jnp.asarray(weights))
    np.testing.assert_array_equal(mod.layers.w.q.numpy(), np.asarray(want["q"]))
    layer1 = mod.layers.w[1]  # indexing the stacked dimension gives the plain dict
    assert set(layer1) == {"q", "s"} and layer1["q"].shape == (256, 320)
    assert {n for n, _ in mod.named_parameters()} == {
        "layers.w.q", "layers.w.s", "layers.norm", "head.q", "head.s"}
    assert not any(p.requires_grad for p in mod.parameters())
    assert tq.tree_nbytes(mod) < before / 3


@pytest.fixture
def matmul_inputs(weights):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 256), dtype=np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 1
    dy = rng.standard_normal((2, 5, 320), dtype=np.float32)
    jqt = jq.quantize_leaf(jnp.asarray(weights))
    tqt = tq.quantize_leaf(torch.from_numpy(weights))
    return x, dy, jqt, tqt


@pytest.fixture
def int8_bwd_off():
    yield
    jq.enable_int8_bwd(False)
    tq.enable_int8_bwd(False)


@pytest.mark.parametrize("int8_bwd", [False, True], ids=["ste_dequant", "int8_dx"])
def test_int8_matmul_forward_and_backward(matmul_inputs, int8_bwd_off, int8_bwd):
    x, dy, jqt, tqt = matmul_inputs
    jq.enable_int8_bwd(int8_bwd)
    tq.enable_int8_bwd(int8_bwd)
    want, vjp = jax.vjp(lambda a: jq.int8_matmul(a, jqt["q"][0], jqt["s"][0]), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    got = tq.int8_matmul(tx, tqt["q"][0], tqt["s"][0])
    (got_dx,) = torch.autograd.grad(got, tx, torch.from_numpy(dy))
    _close(got, want, atol=1e-5)
    _close(got_dx, want_dx, atol=1e-5, rtol=RTOL if int8_bwd else 2e-5)


@pytest.mark.parametrize("int8_bwd", [False, True], ids=["ste_dequant", "int8_dx"])
def test_int8_matmul_group_forward_and_backward(matmul_inputs, int8_bwd_off, int8_bwd):
    x, dy, jqt, tqt = matmul_inputs
    jq.enable_int8_bwd(int8_bwd)
    tq.enable_int8_bwd(int8_bwd)
    dys = (dy, 0.5 * dy[..., ::-1].copy())
    want, vjp = jax.vjp(
        lambda a: jq.int8_matmul_group(a, (jqt["q"][0], jqt["q"][1]), (jqt["s"][0], jqt["s"][1])),
        jnp.asarray(x))
    (want_dx,) = vjp(tuple(jnp.asarray(d) for d in dys))
    tx = torch.from_numpy(x).requires_grad_()
    got = tq.int8_matmul_group(tx, (tqt["q"][0], tqt["q"][1]), (tqt["s"][0], tqt["s"][1]))
    (got_dx,) = torch.autograd.grad(got, tx, [torch.from_numpy(d) for d in dys])
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)
    _close(got_dx, want_dx, atol=2e-5, rtol=RTOL if int8_bwd else 2e-5)
    # the group shares one activation quantization with the single matmul
    single = tq.int8_matmul(tx, tqt["q"][1], tqt["s"][1])
    assert torch.equal(single, got[1])


def test_w8a8_is_exact_integer_arithmetic(weights):
    """The int8 product is computed in integers, not in a float type that
    would round: compare with an int64 numpy product on inputs whose
    accumulators pass 2**24 (where f32 sums would lose bits)."""
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (5, 2048)).astype(np.int8)
    b = rng.integers(100, 128, (2048, 16)).astype(np.int8)
    a[0] = 127
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(want).max() > 2**24
    got = tq.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a transposed view as the second operand, as the dx backward passes it
    got_t = tq.int_matmul(torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T)).t())
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_w8a8_outputs_are_integer_multiples_of_the_scales(matmul_inputs):
    """y / (sx * s) must be whole numbers (the check of the JAX package's own
    quantization tests): the float work is only the two scale products."""
    x, _, _, tqt = matmul_inputs
    tx = torch.from_numpy(x)
    y = tq.int8_matmul(tx, tqt["q"][0], tqt["s"][0])
    xa = tx.abs().amax(-1, keepdim=True)
    sx = torch.where(xa > 0, xa / 127.0, torch.ones_like(xa))
    ratio = (y.double() / (sx.double() * tqt["s"][0].double().reshape(-1)))
    assert torch.all((ratio - ratio.round()).abs() < 1e-2)
    xq = torch.clamp(torch.round(tx / sx), -127, 127).to(torch.int64)
    exact = xq.reshape(-1, 256) @ tqt["q"][0].to(torch.int64)
    assert torch.equal(ratio.round().to(torch.int64).reshape(-1, 320), exact)
