"""The one-token decode kernel's column splits, on the CPU:
``decode_split_plan`` and the split-and-merge arithmetic that
``csrc/flash_decode.cu`` (B4, B4q, B6, B6q) runs when it cuts a row's
columns into runs, one block each (``multimodal_unlearning_tpu_torch/ops/
decode_attention.py``).

- The plan: runs of whole columns covering [0, Smax) once, none empty, a
  pure function of shapes, so a dense and a paged call of one shape get
  one plan (it sees logical columns only); it splits only until B x Hkv x
  splits blocks fill the card, and never into runs shorter than
  ``DECODE_MIN_RUN``.
- A mask narrowed to its first S columns (as the serving engine passes
  it): the same output as the full mask with nothing valid past S, and the
  engine's narrowing never cuts off a valid column.
- ``chunk_attention_split_reference`` at C = 1 under that plan against
  ``mha_reference`` in f64: 1e-5 (the same sums in another order), with
  runs that see nothing, a row that sees nothing (0), GQA, and int8 scales
  kept outside both products (against the dequantized cache).
- One tiny case against the JAX Pallas ``_kernel`` / ``_kernel_q8`` in
  interpret mode on rows that each have a valid column: 1e-5.  (The JAX
  kernels return mean(V) on a row with none; the port returns 0.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.ops import decode_attention as jdec
from multimodal_unlearning_tpu_torch.ops import decode_attention as tdec
from multimodal_unlearning_tpu_torch.ops.attention import mha_reference

TOL = 1e-5


@pytest.mark.parametrize("Smax", [64, 1000, 2048, 8192])
@pytest.mark.parametrize("Hkv", [8, 32])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_plan_covers_the_columns_once(B, Hkv, Smax):
    for G in (1, 2, 4, 8):
        for sms in (132, 8):
            splits, per = tdec.decode_split_plan(B, Hkv, G, Smax, sms)
            assert splits >= 1 and 0 < per <= Smax
            runs = [range(sp * per, min(Smax, (sp + 1) * per)) for sp in range(splits)]
            assert all(len(r) > 0 for r in runs)                     # none empty
            assert [c for r in runs for c in r] == list(range(Smax))  # each column once
            if splits > 1:  # only as far as the card wants blocks, runs not too short
                assert per % tdec.DECODE_RUN_ALIGN == 0
                assert per >= tdec.DECODE_MIN_RUN
                assert B * Hkv * (splits - 1) < tdec.DECODE_BLOCKS_PER_SM * sms
            # a paged pool of the same logical columns: one plan
            for P in (16, 128):
                if Smax % P == 0:
                    assert tdec.decode_split_plan(B, Hkv, G, (Smax // P) * P, sms) == (splits,
                                                                                       per)


def test_plan_splits_the_engine_shapes():
    # LLaVA-1.5-7B's serving decode: 8 rows, 32 kv-heads, 2,048 columns
    assert tdec.decode_split_plan(8, 32, 1, 2048, 132) == (2, 1024)
    # one live row, GQA 4: runs of the shortest length
    assert tdec.decode_split_plan(1, 8, 4, 2048, 132) == (4, 512)
    # enough blocks already: one run, the whole row
    assert tdec.decode_split_plan(32, 32, 1, 2048, 132) == (1, 2048)
    # the engine's mask narrowed to short rows: one run, no merge
    assert tdec.decode_split_plan(8, 32, 1, 256, 132) == (1, 256)
    assert tdec.decode_split_plan(8, 32, 1, 1024, 132) == (2, 512)


def _case(rng, B, Hkv, G, S, D):
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, 1, D)))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, S, D)))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, S, D)))
    return q, k, v


def _valid(B, S):
    valid = torch.zeros((B, S), dtype=torch.int32)
    valid[0, 10:40] = 1              # a row ending in the first run: later runs see nothing
    valid[1, 150:290] = 1            # left padding, then columns into the last run
    valid[1, 5] = 1
    if B > 3:
        valid[3, S - 7:] = 1         # only the last run sees anything
    return valid                     # row 2 sees nothing: 0


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_split_merge_matches_plain_decode(G):
    rng = np.random.default_rng(G)
    B, Hkv, S, D = 4, 2, 300, 16
    q, k, v = _case(rng, B, Hkv, G, S, D)
    valid = _valid(B, S)
    want = mha_reference(q, k, v, valid, causal=False, sm_scale=0.25)
    # the plan's own (one run at this width), then two, three and five runs
    for plan in (tdec.decode_split_plan(B, Hkv, G, S, 132), (2, 256), (3, 128), (5, 64)):
        got = tdec.chunk_attention_split_reference(q, k, v, valid.bool()[:, None, :], 0.25, plan)
        torch.testing.assert_close(got, want, atol=TOL, rtol=0)
        assert torch.all(got[2] == 0)  # a row that sees nothing gives 0


def test_split_merge_int8_scales_outside_both_products():
    rng = np.random.default_rng(9)
    B, Hkv, G, S, D = 4, 2, 2, 256, 16
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, 1, D)))
    kq = torch.from_numpy(rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.float64))
    vq = torch.from_numpy(rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.float64))
    ks = torch.from_numpy(0.01 + 0.01 * rng.random((B, Hkv, S)))
    vs = torch.from_numpy(0.01 + 0.01 * rng.random((B, Hkv, S)))
    valid = _valid(B, S)
    want = mha_reference(q, kq * ks[..., None], vq * vs[..., None], valid, sm_scale=0.25)
    for plan in ((4, 64), (2, 128), (1, 256)):
        got = tdec.chunk_attention_split_reference(q, kq, vq, valid.bool()[:, None, :], 0.25,
                                                   plan, k_scale=ks, v_scale=vs)
        torch.testing.assert_close(got, want, atol=TOL, rtol=0)
        assert torch.all(got[2] == 0)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_split_merge_matches_jax_kernel(kind):
    rng = np.random.default_rng(3)
    L, B, Hkv, G, Smax, D, layer = 2, 3, 2, 2, 256, 16, 1
    k = rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32)
    v = rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32)
    cache = {"k": k, "v": v}
    if kind == "int8":
        for n, x in (("k", k), ("v", v)):
            s = np.abs(x).max(-1, keepdims=True) / 127.0
            cache[n] = np.round(x / s).astype(np.int8)
            cache[n + "_s"] = np.swapaxes(s, -1, -2).astype(np.float32)
    q = rng.standard_normal((B, Hkv * G, 1, D), dtype=np.float32)
    valid = np.zeros((B, Smax), np.int32)
    valid[0, 2:20] = 1
    valid[1, 30:100] = 1
    valid[1, 200] = 1
    valid[2, 250] = 1  # every row has a valid column (the JAX kernels give mean(V) on none)
    want = np.asarray(jdec.decode_attention(
        jnp.asarray(q), {n: jnp.asarray(a) for n, a in cache.items()}, layer,
        jnp.asarray(valid), impl="pallas", interpret=True))
    tk = torch.from_numpy(cache["k"][layer].astype(np.float32))
    tv = torch.from_numpy(cache["v"][layer].astype(np.float32))
    scales = {}
    if kind == "int8":
        scales = dict(k_scale=torch.from_numpy(cache["k_s"][layer][:, :, 0]),
                      v_scale=torch.from_numpy(cache["v_s"][layer][:, :, 0]))
    plan = (4, 64)  # more runs than the plan makes at this width, one run seeing nothing
    got = tdec.chunk_attention_split_reference(
        torch.from_numpy(q), tk, tv, torch.from_numpy(valid).bool()[:, None, :], D ** -0.5,
        plan, **scales)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_narrowed_mask_matches_the_full_mask(int8, paged):
    """A [B, S] mask over the first S of Smax columns gives the output of
    the full mask with nothing valid past S; what the full mask holds past
    S is not looked at."""
    rng = np.random.default_rng(11)
    L, B, Hkv, G, Smax, D, S, P = 2, 3, 2, 2, 256, 16, 96, 16
    k = torch.from_numpy(rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((L, B, Hkv, Smax, D), dtype=np.float32))
    cache = {"k": k, "v": v}
    if int8:
        for n, x in (("k", k), ("v", v)):
            sc = x.abs().amax(-1, keepdim=True) / 127.0
            cache[n] = torch.round(x / sc).to(torch.int8)
            cache[n + "_s"] = sc.transpose(-1, -2).contiguous()
    if paged:  # page j of row b at pool page 1 + b * MP + j
        MP = Smax // P
        table = (1 + torch.arange(B * MP, dtype=torch.int32)).reshape(B, MP)
        pool = {}
        for n, t in cache.items():
            if n.endswith("_s"):  # [L, B, Hkv, 1, Smax] -> [L, Hkv, NP, 1, P]
                pages = t.reshape(L, B, Hkv, 1, MP, P).permute(0, 2, 1, 4, 3, 5)
                pages = pages.reshape(L, Hkv, B * MP, 1, P)
            else:  # [L, B, Hkv, Smax, D] -> [L, Hkv, NP, P, D]
                pages = t.reshape(L, B, Hkv, MP, P, D).transpose(1, 2).reshape(L, Hkv, B * MP,
                                                                              P, D)
            pool[n] = torch.cat([torch.zeros_like(pages[:, :, :1]), pages], 2).contiguous()
        pool["table"] = table
        cache = pool
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, 1, D), dtype=np.float32))
    full = torch.zeros((B, Smax), dtype=torch.int32)
    full[0, 3:50] = 1
    full[1, 60:96] = 1
    full[2, 0] = 1
    want = tdec.decode_attention(q, cache, 1, full)
    full[:, S:] = 1  # past S: never looked at
    got = tdec.decode_attention(q, cache, 1, full[:, :S])
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_engine_narrows_the_mask_to_every_valid_column():
    """The serving engine's decode chunk hands attention its validity rows
    narrowed to the columns its slots can have reached: never a valid
    column past the cut, and a cut below the cache's width on short rows."""
    from multimodal_unlearning_tpu_torch import config as tconfig
    from multimodal_unlearning_tpu_torch.models import llama as tllama
    from multimodal_unlearning_tpu_torch.serve import ServingEngine

    cfg = tconfig.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                              num_layers=1, num_heads=4, num_kv_heads=2,
                              max_position_embeddings=512)
    model = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(model, cfg, "llama", num_slots=3, max_len=512, chunk=4,
                        bucket_multiple=16, pad_token_id=0, cache_dtype=torch.float32,
                        compute_dtype=torch.float32, device="cpu")
    widths = []
    real = tllama.decode_attention

    def checked(q, cache, layer, kv_valid, **kw):
        full = eng._state["kv_valid"]
        widths.append(kv_valid.shape[1])
        assert not full[:, kv_valid.shape[1]:].any()
        return real(q, cache, layer, kv_valid, **kw)

    tllama.decode_attention = checked
    try:
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(1, 64, n).tolist(), m)
                for n, m in ((5, 9), (40, 30), (3, 6), (150, 12), (9, 20))]
        eng.run()
    finally:
        tllama.decode_attention = real
    assert all(r.done for r in reqs)
    assert widths and min(widths) < eng.smax and max(widths) <= eng.smax
