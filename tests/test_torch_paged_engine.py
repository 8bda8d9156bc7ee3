"""The port's ServingEngine on a paged KV cache (``page_size``,
``kv_pool_pages``), f32 on the CPU.

Against the JAX package's paged engine, the same weights carried across by
``models/convert.py``: token streams must be IDENTICAL, and so must the
pool's peak pages and the number of preemptions (the host protocol is the
same), for mixed prompt lengths, a pool small enough that slots outgrow
their admission pages and are preempted, speculation, an int8 pool, and
LLaVA with an image.  Identity holds because both sides compute in f32 with
the same weights; a difference in the last bits of a logit could flip only an
exact tie, which random f32 logits do not produce here.  Both engines run
unpipelined there: the JAX paged engine writes its host block table in
place while a dispatched chunk may still read it, and its streams under
retirement and preemption then vary from run to run on the CPU.  The port
uploads a copy, so its pipelined engine (the default) is held against its
own dense engine in the same test.

Against the port's own dense engine (the JAX tests' rule: a paged stream
equals the dense one): a tight pool queues and completes, an eos retires a
slot and its pages return, a registered prefix's pages are shared by every
slot's table and pinned once, chunked prefill through the pool, and growth
under pressure preempts and stays exact.  A bad page size, an oversize
request and an oversize prefix are refused up front.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.serve import ServingEngine

KW = dict(num_slots=2, max_len=256, chunk=4, bucket_multiple=16, pad_token_id=0)


@pytest.fixture(scope="module")
def llama_setup():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def _port(model, tcfg, kind="llama", cache="f32", **opts):
    return ServingEngine(model, tcfg, kind, cache_dtype=torch.int8 if cache == "int8"
                         else torch.float32, compute_dtype=torch.float32, device="cpu",
                         **dict(KW, **opts))


def _drain(eng, reqs, **kw):
    out = [eng.submit(p, n, **kw) for p, n in reqs]
    eng.drain(out)
    return [list(r.tokens) for r in out]


def _requests(rng, vocab, specs, motif=False):
    reqs = []
    for i, (plen, n) in enumerate(specs):
        p = rng.integers(3, vocab, plen)
        if motif and i % 2 == 0:  # repetitive prompts: the 2-gram lookup fires
            p = np.tile(p[:3], -(-plen // 3))[:plen]
        reqs.append((p.tolist(), n))
    return reqs


@pytest.mark.parametrize("opts,specs", [
    (dict(page_size=16), [(5, 6), (11, 3), (33, 9), (14, 5), (8, 7), (21, 4)]),
    # 4 slots x 5 pages at worst > 12 usable pages: growth preempts
    (dict(page_size=16, kv_pool_pages=13, num_slots=4), [(20, 40)] * 6),
    (dict(page_size=16, speculate_k=3, spec_ref_len=16), [(27, 9), (12, 9), (19, 12)]),
    (dict(page_size=16, cache="int8"), [(9, 7), (22, 7), (40, 5)]),
], ids=["mixed", "growth_preempts", "spec", "int8_pool"])
def test_paged_engine_matches_jax(llama_setup, opts, specs):
    jcfg, params, tcfg, model = llama_setup
    rng = np.random.default_rng(0)
    reqs = _requests(rng, jcfg.vocab_size, specs, motif=bool(opts.get("speculate_k")))
    cache = opts.pop("cache", "f32")
    kw = {"draft_ref": reqs[0][0][:10]} if opts.get("speculate_k") else {}
    jeng = JaxEngine(params, jcfg, "llama", cache_dtype=jnp.int8 if cache == "int8"
                     else jnp.float32, compute_dtype=jnp.float32, pipeline=False,
                     **dict(KW, **opts))
    teng = _port(model, tcfg, cache=cache, pipeline=False, **opts)
    want, got = _drain(jeng, reqs, **kw), _drain(teng, reqs, **kw)
    assert got == want
    js, ts = jeng.stats(), teng.stats()
    for key in ("pool_pages", "pool_pages_peak", "preemptions", "pool_pages_used",
                "tokens_per_round"):
        assert ts[key] == js[key], key
    assert ts["pool_pages_used"] == 0
    # pipelined, against the port's dense engine
    piped = _port(model, tcfg, cache=cache, **opts)
    dense = {k: v for k, v in opts.items() if k not in ("page_size", "kv_pool_pages")}
    assert _drain(piped, reqs, **kw) == _drain(_port(model, tcfg, cache=cache, **dense),
                                               reqs, **kw)
    if opts.get("kv_pool_pages"):
        assert ts["preemptions"] >= 1 and piped.stats()["preemptions"] >= 1


def test_paged_llava_pixels_match_jax():
    arch = get_model_identifiers("tiny-llava-test").arch
    jcfg = jllava.LlavaConfig.from_registry(arch)
    params = jllava.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tconfig.LlavaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    img = rng.standard_normal((32, 32, 3)).astype(np.float32)
    prompt = [jcfg.image_token_id] * jcfg.num_image_tokens + rng.integers(3, 250, 11).tolist()
    text = rng.integers(3, 250, 30).tolist()

    def run(eng):
        out = [eng.submit(prompt, 6, pixel_values=img), eng.submit(text, 5)]
        eng.drain(out)
        return [list(r.tokens) for r in out]

    jeng = JaxEngine(params, jcfg, "llava", cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                     page_size=16, pipeline=False, **KW)
    got = run(_port(model, tcfg, "llava", page_size=16))
    assert got == run(jeng)
    assert got == run(_port(model, tcfg, "llava"))


def test_tight_pool_queues_and_completes(llama_setup):
    """Each request needs 3 pages (a 32-column bucket + 8 tokens); 7 usable
    pages hold two at a time: requests wait for retirements and all finish
    with the dense streams."""
    _, _, tcfg, model = llama_setup
    reqs = _requests(np.random.default_rng(2), tcfg.vocab_size, [(20, 8)] * 5)
    eng = _port(model, tcfg, num_slots=4, page_size=16, kv_pool_pages=8)
    assert _drain(eng, reqs) == _drain(_port(model, tcfg, num_slots=4), reqs)
    st = eng.stats()
    assert st["pool_pages_used"] == 0 and st["pool_pages_peak"] <= 7
    assert st["prefills"] == 5


def test_eos_retirement_recycles_pages(llama_setup):
    _, _, tcfg, model = llama_setup
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(3, tcfg.vocab_size, 9).tolist(), 10),
            (rng.integers(3, tcfg.vocab_size, 6).tolist(), 5)]
    eos = _drain(_port(model, tcfg), reqs)[0][4]
    paged = _port(model, tcfg, num_slots=1, page_size=16, kv_pool_pages=4, eos_token_id=eos)
    got = _drain(paged, reqs)
    assert got == _drain(_port(model, tcfg, num_slots=1, eos_token_id=eos), reqs)
    assert eos not in got[0] and len(got[0]) < 10
    assert paged.stats()["pool_pages_used"] == 0


def test_prefix_pages_shared_without_copy(llama_setup):
    """Three requests behind one 30-token prefix: every live slot's table
    starts with the prefix's two pages, the pool holds them once (pinned
    after the drain), and the streams equal the dense prefix engine's."""
    _, _, tcfg, model = llama_setup
    rng = np.random.default_rng(4)
    system = rng.integers(3, tcfg.vocab_size, 30).tolist()
    reqs = [(rng.integers(3, tcfg.vocab_size, n).tolist(), 7) for n in (5, 9, 13)]
    dense = _port(model, tcfg, num_slots=3)
    paged = _port(model, tcfg, num_slots=3, page_size=16)
    want = _drain(dense, reqs, prefix=dense.register_prefix(system))
    pid = paged.register_prefix(system)
    pages = paged._prefixes[pid]["pages"]
    assert len(pages) == 2 and paged._prefixes[pid]["slab"] is None
    out = [paged.submit(p, n, prefix=pid) for p, n in reqs]
    paged.step()
    assert all(paged._table[s, :2].tolist() == pages for s in range(3))
    own = [set(paged._slot_pages[s]) for s in range(3)]
    assert not (own[0] & own[1]) and not (own[0] & set(pages))
    paged.drain(out)
    assert [list(r.tokens) for r in out] == want
    assert paged.stats()["pool_pages_used"] == 2


def test_chunked_prefill_through_the_pool(llama_setup):
    """A 75-token prompt prefilled 16 tokens a step (its first chunk through
    a slab, the others against the pool) beside a decoding slot: the
    streams equal a monolithic prefill's."""
    _, _, tcfg, model = llama_setup
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(3, tcfg.vocab_size, 6).tolist(), 12),
            (rng.integers(3, tcfg.vocab_size, 75).tolist(), 6)]
    eng = _port(model, tcfg, page_size=16, prefill_chunk=16)
    assert _drain(eng, reqs) == _drain(_port(model, tcfg), reqs)
    assert eng.stats()["prefill_chunks"] >= 4 and eng.stats()["pool_pages_used"] == 0


def test_growth_under_speculation_preempts_and_stays_exact(llama_setup):
    """The growth margin covers the verify chunk's K+1-column overhang: a
    tight pool with speculation preempts and every stream still equals the
    dense speculative engine's."""
    _, _, tcfg, model = llama_setup
    # admission reserves 5 pages (a 32-column bucket + the 36-column margin),
    # a request grows to 7 (+ 64 tokens + the 4-column slack): two slots
    # fit 12 usable pages at admission but not grown
    reqs = _requests(np.random.default_rng(6), tcfg.vocab_size,
                     [(20, 64), (18, 64), (22, 64), (18, 64), (24, 64)], motif=True)
    opts = dict(num_slots=3, speculate_k=3, spec_ref_len=16)
    kw = {"draft_ref": reqs[0][0][:10]}
    paged = _port(model, tcfg, page_size=16, kv_pool_pages=13, **opts)
    assert _drain(paged, reqs, **kw) == _drain(_port(model, tcfg, **opts), reqs, **kw)
    st = paged.stats()
    assert st["preemptions"] >= 1 and st["pool_pages_used"] == 0


def test_bad_page_size_and_oversize_requests_are_refused(llama_setup):
    _, _, tcfg, model = llama_setup
    with pytest.raises(ValueError, match="page_size"):
        _port(model, tcfg, page_size=48)
    eng = _port(model, tcfg, page_size=16, kv_pool_pages=3)  # 2 usable pages
    with pytest.raises(ValueError, match="pages"):
        eng.submit(list(range(3, 40)), 60)
    with pytest.raises(ValueError, match="prefix needs"):
        eng.register_prefix(list(range(3, 43)))
    eng.submit(list(range(3, 10)), 8)  # one page of prompt + 8 tokens fits


def test_serve_cli_with_a_paged_cache(tmp_path, capsys):
    """``cli/serve.run`` with ``page_size=128`` and a capped pool, int8
    cache, speculation, chunked prefill and a system prompt: every request
    completes and the summary reports the pool."""
    lines = [{"question": "Who wrote it? " * 6, "draft": "Who wrote it?", "max_new_tokens": 6},
             {"question": "x" * 150, "max_new_tokens": 5}, {"question": "Why?"}]
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    cfg = tserve.load_config([
        "model_family=tiny-llava-test", "dtype=float32", "device=cpu", "num_slots=2",
        "max_length=512", "generation.max_new_tokens=4", "kv_cache_dtype=int8",
        "speculative_k=4", "prefill_chunk=128", "system_prompt=You are terse.",
        "page_size=128", "kv_pool_pages=7", f"requests={reqs}", f"save_file={tmp_path / 'o'}"])
    rows = tserve.run(cfg)
    assert [0 < r["tokens"] <= line.get("max_new_tokens", 4)
            for r, line in zip(rows, lines)] == [True] * 3
    assert "paged pool 6 pages of 128" in capsys.readouterr().out
