"""The port's grouped-int4 (W4A16) serving slice against the JAX package,
f32 on the CPU, inputs from a numpy seed:

- the quantizer: ``quantize_leaf_int4`` at group sizes 128, 64 and 32 and on
  a stacked [L, K, N] leaf (packed bytes equal, scales within 1e-6
  relative: both sides divide the same f32 absmax by 7), ``unpack_int4``,
  ``dequantize_leaf`` and the int4 ``embed_lookup`` (ids in both halves of
  V), and ``quantize_tree`` / ``quantize_tree_inplace`` with ``bits=4`` on a
  dict tree and on a module (leaf count and ``tree_nbytes`` equal);
- kernel B8's plain version ``int4_matmul_reference`` against the Pallas
  kernel in interpret mode (rtol/atol 2e-5 in f32, 3e-2 in bf16: the
  same per-group partials, summed in another order) and the dispatching
  ``int4_matmul`` against the JAX XLA path, above 1024 rows too;
- ``convert.from_jax`` on a JAX int4 tree: logits within 1e-4 of the JAX
  forward's;
- ``cli/serve.build_engine`` with ``quantize_base=int4`` on a 256-wide llama
  (the tiny presets are narrower than 256 and quantize nothing) against the
  JAX engine on the JAX-quantized tree: identical streams, plain, with
  ``int4:g64``, and with speculation on the int8 KV cache; a second build
  passes the quantized model through; ``INT8_COMPUTE`` does not change an
  int4 model's streams.

Identity of streams holds because both sides compute in f32 from equal
packed weights and scales; a difference in the last bits of a logit could
flip only an exact tie.  The card's B8 is held against the plain version in
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.ops.int4_matmul import int4_matmul_pallas
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu.utils import quantize as jq
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models.params import ParamTree
from multimodal_unlearning_tpu_torch.ops import int4_matmul as ti
from multimodal_unlearning_tpu_torch.utils import quantize as tq

RTOL = 1e-6


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * 0.05


def _match_jitted(got, want, w, gs):
    """A port leaf against the JAX package's jitted tree quantizer: XLA
    computes ``absmax / 7`` there as ``absmax * (1/7)``, so a scale may be
    one ulp above the eager function's, and a weight at exactly .5 of a
    step then rounds the other way.  The port equals the eager function
    bit for bit; here scales agree within 1e-6 relative and an int4 value
    may differ by one step, at a .5 tie only, in at most 1e-4 of them."""
    np.testing.assert_array_equal(got["q4"].numpy(),
                                  np.asarray(jq.quantize_leaf_int4(jnp.asarray(w), gs)["q4"]))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=RTOL, atol=0)
    a = tq.unpack_int4(got["q4"]).numpy().astype(np.int32)
    b = np.asarray(jq.unpack_int4(want["q4"])).astype(np.int32)
    diff = np.argwhere(a != b)
    assert np.abs(a - b).max() <= 1 and len(diff) <= 1e-4 * a.size
    s = got["s"].numpy()
    g = w.shape[-2] // s.shape[-2]
    for idx in diff:
        *lead, row, col = idx
        step = w[tuple(idx)] / s[tuple(lead) + (row // g, col)]
        assert abs(abs(step - np.trunc(step)) - 0.5) < 1e-5, step


@pytest.mark.parametrize("shape,gs", [((256, 384), 128), ((512, 256), 64), ((256, 320), 32),
                                      ((2, 512, 256), 128)],
                         ids=["g128", "g64", "g32", "stacked"])
def test_quantize_leaf_int4_matches_jax(shape, gs):
    w = _w(shape)
    w[..., 3] = 0.0  # an all-zero column: scale 1, not 0
    want = jq.quantize_leaf_int4(jnp.asarray(w), gs)
    got = tq.quantize_leaf_int4(torch.from_numpy(w), gs)
    assert got["q4"].dtype == torch.int8 and got["q4"].shape == want["q4"].shape
    assert got["q4"].stride()[-2:] == (1, shape[-2] // 2)  # K/2-contiguous
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=RTOL, atol=0)
    assert torch.all(got["s"][..., 3] == 1.0)
    np.testing.assert_array_equal(tq.unpack_int4(got["q4"]).numpy(),
                                  np.asarray(jq.unpack_int4(want["q4"])))
    np.testing.assert_allclose(tq.dequantize_leaf(got, torch.float32).numpy(),
                               np.asarray(jq.dequantize_leaf(want, jnp.float32)),
                               rtol=RTOL, atol=0)
    assert tq.is_qtensor(got) and tq.is_int4(got) and not tq.is_int4(tq.quantize_leaf(
        torch.from_numpy(w)))


def test_embed_lookup_int4():
    table = _w((512, 256), seed=1)
    ids = np.array([[0, 5, 255, 256, 300, 511], [7, 260, 128, 383, 1, 510]])
    want = jq.embed_lookup(jq.quantize_leaf_int4(jnp.asarray(table)), jnp.asarray(ids))
    got = tq.embed_lookup(tq.quantize_leaf_int4(torch.from_numpy(table)), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)


def test_quantize_tree_bits4_matches_jax():
    w = _w((2, 256, 384))
    tree = {"layers": {"q_proj": w, "norm": np.ones((2, 256), np.float32)},
            "small": w[0, :, :64].copy(), "embed": w[1]}
    want = jq.quantize_tree(jax.tree.map(jnp.asarray, tree), bits=4, group_size=64)
    ttree = lambda: {"layers": {k: torch.from_numpy(v.copy()) for k, v in tree["layers"].items()},
                     "small": torch.from_numpy(tree["small"]),
                     "embed": torch.from_numpy(tree["embed"])}
    got = tq.quantize_tree(ttree(), bits=4, group_size=64)
    src = ttree()
    inplace = tq.quantize_tree_inplace(src, bits=4, group_size=64)
    assert inplace is src
    n_int4 = sum(isinstance(x, dict) and "q4" in x
                 for x in jax.tree.leaves(want, is_leaf=jq.is_qtensor))
    for t in (got, inplace):
        assert tq.is_int4(t["layers"]["q_proj"]) and tq.is_int4(t["embed"])
        assert sum(tq.is_int4(x) for x in (t["layers"]["q_proj"], t["layers"]["norm"],
                                           t["small"], t["embed"])) == n_int4 == 2
        _match_jitted(t["layers"]["q_proj"], want["layers"]["q_proj"], w, 64)
        _match_jitted(t["embed"], want["embed"], w[1], 64)
        assert tq.tree_nbytes(t) == jq.tree_nbytes(want)

    mod = ParamTree({"layers": {"w": (2, 256, 384), "norm": (2, 256)}, "head": (256, 384)},
                    device="cpu", dtype=torch.float32)
    with torch.no_grad():
        mod.layers.w.copy_(torch.from_numpy(w))
        mod.head.copy_(torch.from_numpy(w[1]))
        mod.layers.norm.fill_(1.0)
    mtree = {"layers": {"w": w, "norm": np.ones((2, 256), np.float32)}, "head": w[1]}
    mwant = jq.quantize_tree(jax.tree.map(jnp.asarray, mtree), bits=4)
    assert tq.quantize_tree_inplace(mod, bits=4) is mod
    assert isinstance(mod.layers.w, tq.QTensor4) and isinstance(mod.head, tq.QTensor4)
    assert {n for n, _ in mod.named_parameters()} == {
        "layers.w.q4", "layers.w.s", "layers.norm", "head.q4", "head.s"}
    assert set(mod.layers.w[1]) == {"q4", "s"} and tq.is_int4(mod.layers.w[1])
    _match_jitted(mod.layers.w[:], mwant["layers"]["w"], w, 128)
    _match_jitted(mod.head[:], mwant["head"], w[1], 128)
    assert tq.tree_nbytes(mod) == jq.tree_nbytes(mwant)
    assert not any(p.requires_grad for p in mod.parameters())


@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("k,n", [(512, 384), (768, 512), (2048, 256)])
def test_reference_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = _w((k, n), seed=k + n)
    jqt = jq.quantize_leaf_int4(jnp.asarray(w))
    tqt = tq.quantize_leaf_int4(torch.from_numpy(w))
    want = int4_matmul_pallas(jnp.asarray(x), jqt["q4"], jqt["s"], interpret=True)
    got = ti.int4_matmul_reference(torch.from_numpy(x), tqt["q4"], tqt["s"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # the wrapper on a CPU tensor is the plain version
    torch.testing.assert_close(ti.grouped_int4_matmul(torch.from_numpy(x), tqt["q4"], tqt["s"]),
                               got, rtol=0, atol=0)


def test_reference_bf16_matches_pallas_interpret():
    x = np.random.default_rng(5).standard_normal((8, 512), dtype=np.float32)
    w = _w((512, 256), seed=5)
    jqt = jq.quantize_leaf_int4(jnp.asarray(w))
    tqt = tq.quantize_leaf_int4(torch.from_numpy(w))
    want = int4_matmul_pallas(jnp.asarray(x, jnp.bfloat16), jqt["q4"], jqt["s"], interpret=True)
    got = ti.int4_matmul_reference(torch.from_numpy(x).to(torch.bfloat16), tqt["q4"], tqt["s"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("m", [1, 40, 1100])
def test_int4_matmul_dispatch_matches_jax_xla(m):
    """The dispatcher against the JAX function, which on the CPU always
    takes its XLA dequant path: B8's plain version up to 1024 rows, the
    dequant path (counted) above."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((1, m, 512), dtype=np.float32)
    w = _w((512, 384), seed=m)
    jqt = jq.quantize_leaf_int4(jnp.asarray(w))
    tqt = tq.quantize_leaf_int4(torch.from_numpy(w))
    want = jq.int4_matmul(jnp.asarray(x), jqt["q4"], jqt["s"])
    tq.INT4_DEQUANT_CALLS.clear()
    got = tq.int4_matmul(torch.from_numpy(x), tqt["q4"], tqt["s"])
    assert got.shape == (1, m, 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert dict(tq.INT4_DEQUANT_CALLS) == ({(m, 512, 384): 1} if m > 1024 else {})


def test_supported_shapes_and_splits():
    # LLaVA-1.5-7B's products (K/2 = 5504 is 43 groups of 128) at every
    # group size the quantizer gives, and an odd group that takes the
    # dequant path
    for k, n in [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]:
        for gs in (128, 64, 32):
            g = tq._int4_groups(k // 2, gs)
            q4, s = torch.empty((k // 2, n), dtype=torch.int8), torch.empty((k // g, n))
            assert ti.supported(q4, s), (k, n, gs)
            for m in (1, 8, 40, 512, 1024):
                per, splits = ti.splits_for(m, n, k // 2 // g)
                assert per * splits >= k // 2 // g > per * (splits - 1)
    assert ti.splits_for(8, 4096, 16) == (2, 8)      # 32 column tiles: split the groups
    assert ti.splits_for(1024, 4096, 16) == (16, 1)  # 512 tiles fill the card alone
    x = np.random.default_rng(7).standard_normal((4, 360), dtype=np.float32)
    qt = tq.quantize_leaf_int4(torch.from_numpy(_w((360, 256))))  # groups of 90 rows
    assert not ti.supported(qt["q4"], qt["s"])
    tq.INT4_DEQUANT_CALLS.clear()
    jqt = jq.quantize_leaf_int4(jnp.asarray(_w((360, 256))))
    np.testing.assert_allclose(tq.int4_matmul(torch.from_numpy(x), qt["q4"], qt["s"]).numpy(),
                               np.asarray(jq.int4_matmul(jnp.asarray(x), jqt["q4"], jqt["s"])),
                               rtol=2e-5, atol=2e-5)
    assert dict(tq.INT4_DEQUANT_CALLS) == {(4, 360, 256): 1}


@pytest.mark.parametrize("M", [1, 8, 16, 17, 32, 33, 40, 64, 65, 512, 1024])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)],
                         ids=["qkvo", "gate_up", "down", "lm_head"])
def test_splits_follow_the_tile_table(K, N, M):
    """B8's split plan at LLaVA-1.5-7B's products (groups of 128; ``down``
    has 43 per half): every group in exactly one split, none empty, and
    splits only while the (N, M) tiles are fewer than the kernel's target."""
    gh = K // 2 // 128
    per, splits = ti.splits_for(M, N, gh)
    runs = [range(sp * per, min(gh, (sp + 1) * per)) for sp in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [g for r in runs for g in r] == list(range(gh))
    bm, target = ti.tile_of(M)
    tiles = -(-N // 128) * -(-M // bm)
    assert bm >= min(M, 32) and (bm == 128 or -(-M // bm) <= 2)  # rows: at most two tiles
    assert splits == 1 or (tiles < target and tiles * splits <= 1.5 * target)


def test_tile_table_mirrors_the_kernel():
    """``TILES`` (ops/int4_matmul.py) states the block rows that
    ``csrc/int4_matmul.cu``'s ``tile_rows`` picks."""
    import re
    from pathlib import Path

    src = (Path(ti.__file__).parent / "csrc" / "int4_matmul.cu").read_text()
    body = re.search(r"int tile_rows\(int M\) \{ return ([^;]*);", src).group(1)
    picks = [(int(a), int(b)) for a, b in re.findall(r"M <= (\d+) \? (\d+)", body)]
    last = int(body.rsplit(":", 1)[1])
    assert picks + [(None, last)] == [(most, bm) for most, bm, _ in ti.TILES]


def test_no_gradient_and_no_other_device():
    """x gets its gradient through either function (QLoRA: dy @ dequant^T,
    ``tests/test_torch_int4_train.py`` holds it against JAX); the base gets
    none; no device but the CPU and the card."""
    qt = tq.quantize_leaf_int4(torch.from_numpy(_w((512, 256))))
    s = qt["s"].clone().requires_grad_()
    for fn in (tq.int4_matmul, ti.grouped_int4_matmul):
        x = torch.ones((2, 512), requires_grad=True)
        (gx, gs) = torch.autograd.grad(fn(x, qt["q4"], s).sum(), (x, s), allow_unused=True)
        want = tq.dequantize_leaf(qt, torch.float32).sum(1)
        torch.testing.assert_close(gx, want.expand(2, -1), rtol=1e-6, atol=1e-6)
        assert gs is None
    with pytest.raises(RuntimeError, match="no kernel"):
        ti.grouped_int4_matmul(torch.empty((2, 512), device="meta"), qt["q4"].to("meta"),
                               qt["s"].to("meta"))
    with pytest.raises(ValueError, match="even"):
        tq.quantize_leaf_int4(torch.zeros((3, 256)))  # odd contracting dim
    prev = ti.use_plain(True)
    try:
        assert ti.PLAIN is True
    finally:
        ti.use_plain(prev)
    assert ti.PLAIN is prev


WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2)


@pytest.fixture(scope="module")
def wide_llama():
    """A 256-wide llama: the JAX float params, their numpy copy (the port's
    models are built from it), and the prompts (repetitive on every other
    request, so that speculation's 2-gram lookup fires)."""
    arch = get_model_identifiers("tiny-llama-test").arch.to_dict()
    arch.update(WIDE)
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    tree = jax.tree.map(lambda a: np.array(a), params)
    rng = np.random.default_rng(4)
    reqs = []
    for i, (plen, n) in enumerate(((15, 8), (5, 6), (16, 9))):  # one prefill bucket
        p = rng.integers(3, 500, plen)
        if i % 2 == 0:
            p = np.tile(p[:3], -(-plen // 3))[:plen]
        reqs.append((p.tolist(), n))
    return arch, jcfg, tree, reqs


def _jax_quantized(tree, spec):
    # quantize_base_params deletes the float buffers it quantizes: give it its own copy
    return jcommon.quantize_base_params(jax.tree.map(jnp.asarray, tree), "llama", spec)


def test_from_jax_int4_logits(wide_llama):
    arch, jcfg, tree, _ = wide_llama
    qparams = _jax_quantized(tree, "int4")
    model = convert.from_jax(jax.tree.map(np.asarray, qparams), tconfig.LlamaConfig.from_registry(
        arch), device="cpu")
    assert sum(isinstance(m, tq.QTensor4) for m in model.modules()) == 7
    assert tq.tree_nbytes(model) == jq.tree_nbytes(qparams)
    ids = np.random.default_rng(6).integers(3, 500, (2, 11)).astype(np.int32)
    want = jllama.forward(qparams, jcfg, jnp.asarray(ids), compute_dtype=jnp.float32)["logits"]
    got = model(torch.from_numpy(ids).long(), compute_dtype=torch.float32)["logits"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _port_engine(monkeypatch, wide_llama, *overrides):
    arch, _, tree, _ = wide_llama
    monkeypatch.setitem(tconfig.PRESETS, "wide-llama-test",
                        dict(tconfig.PRESETS["tiny-llama-test"], arch=arch))
    model = convert.from_jax(tree, tconfig.LlamaConfig.from_registry(arch), device="cpu")
    cfg = tserve.load_config(["model_family=wide-llama-test", "dtype=float32", "device=cpu",
                              "num_slots=2", "max_length=128", "chunk=3", *overrides])
    engine, processor, _, _ = tserve.build_engine(cfg, model=model, bucket_multiple=16)
    return engine, processor, model, cfg


def _drain(eng, reqs):
    out = [eng.submit(p, n) for p, n in reqs]
    eng.drain(out)
    return [r.tokens for r in out]


@pytest.mark.parametrize("spec,opts", [
    ("int4", ()),
    ("int4:g64", ()),
    ("int4", ("speculative_k=3", "spec_ref_len=16", "kv_cache_dtype=int8")),
], ids=["int4", "int4_g64", "int4_spec_int8_cache"])
def test_build_engine_int4_matches_jax(monkeypatch, wide_llama, spec, opts):
    _, jcfg, tree, reqs = wide_llama
    engine, processor, model, cfg = _port_engine(monkeypatch, wide_llama,
                                                 f"quantize_base={spec}", *opts)
    # q, o, gate, up, down, embed_tokens, lm_head (k/v are 128 wide: too narrow)
    assert sum(isinstance(m, tq.QTensor4) for m in model.modules()) == 7
    assert model.layers.gate_proj.s.shape == (2, 256 // (64 if "g64" in spec else 128), 512)
    tok = processor.tokenizer
    jopts = dict(speculate_k=3, spec_ref_len=16) if opts else {}
    jeng = JaxEngine(_jax_quantized(tree, spec), jcfg, "llama", num_slots=2, max_len=128,
                     chunk=3, bucket_multiple=16, pad_token_id=tok.pad_token_id,
                     eos_token_id=tok.eos_token_id,
                     cache_dtype=jnp.int8 if opts else jnp.float32,
                     compute_dtype=jnp.float32, **jopts)
    got = _drain(engine, reqs)
    assert got == _drain(jeng, reqs)
    if opts:
        assert engine.stats()["tokens_per_round"] == pytest.approx(
            jeng.stats()["tokens_per_round"])
        return
    # a quantized model passes through a second build untouched
    before = {n: p.data_ptr() for n, p in model.named_parameters()}
    tserve.build_engine(cfg, model=model)
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == before


def test_int4_ignores_int8_compute(monkeypatch, wide_llama):
    """An int4 leaf takes the W4A16 product whatever INT8_COMPUTE says: the
    same streams with the flag on."""
    engine, *_ = _port_engine(monkeypatch, wide_llama, "quantize_base=int4")
    reqs = wide_llama[3]
    base = _drain(engine, reqs)
    prev = tllama.enable_int8_compute(True)
    try:
        under_flag = _drain(engine, reqs)
    finally:
        tllama.enable_int8_compute(prev)
    assert under_flag == base
