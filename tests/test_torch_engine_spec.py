"""The port's ServingEngine options of the int8/speculative serving slice
against the JAX package's engine, f32 on the CPU, the same weights carried
across by ``models/convert.py``.  Token streams must be IDENTICAL for:

- the int8 KV cache (tiny-llama-test);
- speculation (``speculate_k``) with a ``draft_ref`` corpus on part of the
  requests, eos included (tiny-llama-test, repetitive prompts so that the
  2-gram lookup fires and drafts are accepted);
- chunked prefill (``prefill_chunk``), on tiny-llava-test with an image in
  the first chunk and text prompts of one and three chunks;
- the prefix cache (``register_prefix``), alone and with speculation;
- ``cli/serve.build_engine`` with ``quantize_base=true`` on a 256-wide
  llama (the tiny presets are narrower than 256 and quantize nothing)
  against JAX ``quantize_base_params`` + engine.

The serve CLI's ``run`` is also driven with every option of the slice
(well-formed completions only).

Identity holds because both sides compute in f32 with the same weights; a
difference in the last bits of a logit could flip only an exact tie, which
random f32 logits do not produce here.  Each JAX engine runs once per
configuration (module fixtures); the port's prefix-cache and llava
chunked-prefill runs are also held equal to the port's own plain
engine, as the JAX tests hold the JAX engine.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.serve import ServingEngine

KW = dict(num_slots=2, max_len=128, chunk=3, bucket_multiple=16, pad_token_id=0)


def _engines(jparams, jcfg, model, tcfg, kind, **opts):
    """(JAX engine, port engine) with the same options; the cache dtype
    option is given as "f32" or "int8"."""
    cd = opts.pop("cache", "f32")
    jeng = JaxEngine(jparams, jcfg, kind, cache_dtype=jnp.int8 if cd == "int8" else jnp.float32,
                     compute_dtype=jnp.float32, **KW, **opts)
    teng = ServingEngine(model, tcfg, kind, cache_dtype=torch.int8 if cd == "int8"
                         else torch.float32, compute_dtype=torch.float32, device="cpu",
                         **KW, **opts)
    return jeng, teng


def _drain(eng, reqs, prefix=None):
    out = [eng.submit(p, n, draft_ref=d, prefix=prefix) for p, n, d in reqs]
    eng.drain(out)
    return [r.tokens for r in out]


@pytest.fixture(scope="module")
def llama_setup():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    reqs = []
    for i, (plen, n) in enumerate(((24, 10), (9, 8), (31, 12), (17, 6))):
        p = rng.integers(3, jcfg.vocab_size, plen)
        if i % 2 == 0:  # repetitive prompts: the 2-gram lookup fires
            period = int(rng.integers(2, 5))
            p = np.tile(p[:period], -(-plen // period))[:plen]
        draft = rng.integers(3, jcfg.vocab_size, 12).tolist() if i == 1 else None
        reqs.append((p.tolist(), n, draft))
    return jcfg, params, tcfg, model, reqs


@pytest.mark.parametrize("opts", [
    dict(cache="int8"),
    dict(speculate_k=3, spec_ref_len=16),
    dict(speculate_k=3, spec_ref_len=16, cache="int8"),
    dict(prefill_chunk=16),
], ids=["int8_cache", "spec", "spec_int8", "prefill_chunk"])
def test_engine_options_match_jax(llama_setup, opts):
    jcfg, params, tcfg, model, reqs = llama_setup
    jeng, teng = _engines(params, jcfg, model, tcfg, "llama", **opts)
    want = _drain(jeng, reqs)
    got = _drain(teng, reqs)
    assert got == want
    assert [len(t) for t in got] == [n for _, n, _ in reqs]
    js, ts = jeng.stats(), teng.stats()
    assert ts["prefill_chunks"] == js["prefill_chunks"]
    assert ts["tokens_per_round"] == pytest.approx(js["tokens_per_round"])
    if opts.get("speculate_k"):
        assert ts["tokens_per_round"] > 1.0  # drafts were accepted
    if opts.get("prefill_chunk"):
        assert ts["prefill_chunks"] == 6  # 24, 31 and 17 tokens: 2 chunks each; 9: none


def test_spec_with_eos_matches_jax(llama_setup):
    jcfg, params, tcfg, model, reqs = llama_setup
    free = _drain(ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                                compute_dtype=torch.float32, device="cpu", **KW), reqs)
    eos = free[0][4]  # request 0 stops early; the slot is reused
    jeng, teng = _engines(params, jcfg, model, tcfg, "llama", speculate_k=3, spec_ref_len=16,
                          eos_token_id=eos)
    got = _drain(teng, reqs)
    assert got == _drain(jeng, reqs)
    assert eos not in got[0] and len(got[0]) < reqs[0][1]


@pytest.mark.parametrize("spec", [False, True], ids=["prefix", "prefix_spec"])
def test_prefix_cache_matches_jax(llama_setup, spec):
    jcfg, params, tcfg, model, reqs = llama_setup
    opts = dict(speculate_k=3, spec_ref_len=16) if spec else {}
    rng = np.random.default_rng(5)
    system = rng.integers(3, jcfg.vocab_size, 19).tolist()
    jeng, teng = _engines(params, jcfg, model, tcfg, "llama", **opts)
    jpid, tpid = jeng.register_prefix(system), teng.register_prefix(system)
    want = _drain(jeng, reqs, prefix=jpid)
    got = _drain(teng, reqs, prefix=tpid)
    assert got == want
    # the same streams as the full prompts through the port's plain engine
    plain = ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu", **KW)
    assert got == _drain(plain, [(system + p, n, None) for p, n, _ in reqs])


@pytest.fixture(scope="module")
def llava_setup():
    arch = get_model_identifiers("tiny-llava-test").arch
    jcfg = jllava.LlavaConfig.from_registry(arch)
    params = jllava.init_params(jcfg, jax.random.PRNGKey(2))
    tcfg = tconfig.LlavaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def test_chunked_prefill_llava_matches_jax(llava_setup):
    """An image inside the first chunk rides with it; text prompts of one,
    and three chunks; streams equal the JAX engine's and the port's own
    monolithic prefill."""
    jcfg, params, tcfg, model = llava_setup
    rng = np.random.default_rng(3)
    n_img, C = jcfg.num_image_tokens, 32
    prompt_img = rng.integers(3, 250, 40).tolist()
    prompt_img = prompt_img[:2] + [jcfg.image_token_id] * n_img + prompt_img[2:]
    pix = rng.standard_normal((32, 32, 3)).astype(np.float32)
    texts = [rng.integers(3, 250, n).tolist() for n in (20, 70)]

    def run(eng):
        out = [eng.submit(prompt_img, 6, pixel_values=pix)]
        out += [eng.submit(p, 5) for p in texts]
        eng.drain(out)
        return [r.tokens for r in out], eng.stats()["prefill_chunks"]

    kw = dict(KW, max_len=192)
    jeng = JaxEngine(params, jcfg, "llava", cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                     prefill_chunk=C, **kw)
    teng = ServingEngine(model, tcfg, "llava", cache_dtype=torch.float32,
                         compute_dtype=torch.float32, prefill_chunk=C, device="cpu", **kw)
    mono = ServingEngine(model, tcfg, "llava", cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu", **kw)
    (want, jchunks), (got, tchunks) = run(jeng), run(teng)
    assert got == want and tchunks == jchunks
    assert tchunks == 2 + 3  # the image prompt (2+n_img+38 tokens) and 70 tokens
    assert got == run(mono)[0]


WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2)


def test_build_engine_quantize_base_matches_jax(monkeypatch):
    """``quantize_base=true`` on a 256-wide llama: the port quantizes the
    model it is given in place (W8A16), the JAX package through
    ``quantize_base_params``; the streams of the two engines agree."""
    arch = get_model_identifiers("tiny-llama-test").arch.to_dict()
    arch.update(WIDE)
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    preset = dict(tconfig.PRESETS["tiny-llama-test"], arch=arch)
    monkeypatch.setitem(tconfig.PRESETS, "wide-llama-test", preset)
    cfg = tserve.load_config(["model_family=wide-llama-test", "dtype=float32", "device=cpu",
                              "num_slots=2", "max_length=128", "chunk=3"])
    assert cfg["quantize_base"] is True  # the serve config's default
    engine, processor, kind, _ = tserve.build_engine(cfg, model=model, bucket_multiple=16)
    # q, o, gate, up, down, embed_tokens, lm_head (k/v are 128 wide: too narrow)
    assert sum(type(m).__name__ == "QTensor" for m in model.modules()) == 7
    qparams = jcommon.quantize_base_params(params, "llama", True)
    tok = processor.tokenizer
    jeng = JaxEngine(qparams, jcfg, "llama", num_slots=2, max_len=128, chunk=3,
                     bucket_multiple=16, pad_token_id=tok.pad_token_id,
                     eos_token_id=tok.eos_token_id, cache_dtype=jnp.float32,
                     compute_dtype=jnp.float32)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(3, 500, n).tolist(), 6, None) for n in (5, 23)]
    assert _drain(engine, reqs) == _drain(jeng, reqs)
    # a quantized model passes through a second build untouched
    before = {n: p.data_ptr() for n, p in model.named_parameters()}
    tserve.build_engine(cfg, model=model)
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == before


def test_serve_cli_run_with_the_serving_options(tmp_path):
    """``cli/serve.run`` with the serve config's defaults (``quantize_base``
    true) plus every option of this slice: the system prompt becomes a
    prefix for the text requests, the image request prefills whole, a
    request's "draft" text seeds the lookup, and every request completes."""
    from PIL import Image

    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 48, 3), np.uint8)).save(img)
    lines = [{"question": "What is shown?", "image": str(img), "max_new_tokens": 4},
             {"question": "Who wrote it? " * 6, "draft": "Who wrote it?", "max_new_tokens": 6},
             {"question": "x" * 150, "stop": "zz"}]
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    out = tmp_path / "out.jsonl"
    cfg = tserve.load_config([
        "model_family=tiny-llava-test", "dtype=float32", "device=cpu", "num_slots=2",
        "max_length=512", "generation.max_new_tokens=5", "kv_cache_dtype=int8",
        "speculative_k=4", "prefill_chunk=128", "system_prompt=You are terse.",
        f"requests={reqs}", f"save_file={out}"])
    rows = tserve.run(cfg)
    assert len(rows) == 3 and [r["question"] for r in rows] == [r["question"] for r in lines]
    for row, line in zip(rows, lines):
        assert isinstance(row["completion"], str)
        assert 0 <= row["tokens"] <= line.get("max_new_tokens", 5)
