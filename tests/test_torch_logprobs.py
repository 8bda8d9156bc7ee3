"""Per-token logprobs of the port's serving engine (``logprobs=True``), its
HTTP front end and ``cli/serve.py``, f32 on the CPU.

- Against the JAX engine on the same weights and requests: greedy (dense),
  sampled, and paged with speculation and a registered prefix, the tokens
  equal and every logprob within 1e-4 of JAX's.
- Against a teacher-forced forward of the port over [prompt | stream]: each
  logprob is the raw ``log_softmax`` at the position before its token,
  whatever the sampling settings.
- Speculative rounds give the plain engine's tokens and logprobs; an eos
  ends a stream with its logprobs aligned; a stop sequence cuts tokens and
  logprobs together.
- Output shape: the HTTP response carries ``"logprobs": {"token_logprobs":
  [...]}`` (6 places, one per token) and ``cli/serve.py`` writes
  ``row["logprobs"]``; the CLI also serves ``adapters`` saved by
  ``save_adapter``, a request's ``adapter`` and ``sample_seed`` picking its
  stream as the engine's do.

The weights are drawn by the port and carried across as numpy.  The JAX
engines run with ``pipeline=False``.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.models import llama as tllama
from multimodal_unlearning_tpu_torch.models import lora as tlora
from multimodal_unlearning_tpu_torch.serve import EngineServer, ServingEngine
from multimodal_unlearning_tpu_torch.train import checkpoints as tckpt
from multimodal_unlearning_tpu_torch.utils.pytree import tree_map

KW = dict(num_slots=2, max_len=192, chunk=4, bucket_multiple=16, pad_token_id=0)
LP_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    arch = get_model_identifiers("tiny-llama-test").arch
    jcfg = jllama.LlamaConfig.from_registry(arch)
    tcfg = tconfig.LlamaConfig.from_registry(arch)
    model = tllama.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcommon.model_tree(model))
    rng = np.random.default_rng(0)
    prompts = []
    for i, n in enumerate((5, 19, 11, 8)):
        p = rng.integers(3, 240, n)
        if i % 2:  # repetitive: the 2-gram lookup fires
            p = np.tile(p[:3], -(-n // 3))[:n]
        prompts.append(p.tolist())
    return jcfg, params, tcfg, model, prompts


def _port(model, tcfg, **kw):
    return ServingEngine(model, tcfg, "llama", cache_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu", logprobs=True,
                         **dict(KW, **kw))


def _drain(eng, prompts, n=7, prefix=None, **kw):
    reqs = [eng.submit(p, n, prefix=prefix, sample_seed=i + 3, **kw)
            for i, p in enumerate(prompts)]
    eng.drain(reqs)
    return reqs


def _teacher_forced(model, prompt, tokens):
    seq = torch.tensor([list(prompt) + list(tokens)])
    with torch.no_grad():
        logits = model(seq, compute_dtype=torch.float32)["logits"][0]
    lps = torch.log_softmax(logits, dim=-1)
    return [float(lps[len(prompt) - 1 + i, t]) for i, t in enumerate(tokens)]


@pytest.mark.parametrize("opts", [{}, {"temperature": 0.8, "top_k": 20},
                                  {"page_size": 16, "speculate_k": 3, "spec_ref_len": 16}],
                         ids=["greedy", "sampled", "paged_spec_prefix"])
def test_logprobs_equal_jax_and_teacher_forced(setup, opts):
    jcfg, params, tcfg, model, prompts = setup
    system = list(range(40, 53))
    jeng = JaxEngine(params, jcfg, "llama", cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                     pipeline=False, logprobs=True, **dict(KW, **opts))
    teng = _port(model, tcfg, **opts)
    pre = opts.get("page_size") and (jeng.register_prefix(system), teng.register_prefix(system))
    want = _drain(jeng, prompts, prefix=pre[0] if pre else None)
    got = _drain(teng, prompts, prefix=pre[1] if pre else None)
    for g, w, p in zip(got, want, prompts):
        assert g.tokens == w.tokens
        assert len(g.logprobs) == len(g.tokens)
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=LP_TOL, atol=LP_TOL)
        full = system + p if pre else p
        np.testing.assert_allclose(g.logprobs, _teacher_forced(model, full, g.tokens),
                                   rtol=LP_TOL, atol=LP_TOL)


def test_speculative_eos_and_stop_alignment(setup):
    _, _, tcfg, model, prompts = setup
    plain = _drain(_port(model, tcfg), prompts, n=12)
    spec = _drain(_port(model, tcfg, speculate_k=3, spec_ref_len=16), prompts, n=12)
    for s, p in zip(spec, plain):
        assert s.tokens == p.tokens
        np.testing.assert_allclose(s.logprobs, p.logprobs, rtol=1e-5, atol=1e-5)
    # an eos: the stream stops before it, its logprobs aligned
    eos = plain[1].tokens[4]
    ended = _drain(_port(model, tcfg, eos_token_id=eos), prompts, n=12)
    for e, p in zip(ended, plain):
        cut = p.tokens.index(eos) if eos in p.tokens else len(p.tokens)
        assert e.tokens == p.tokens[:cut] and len(e.logprobs) == cut
        np.testing.assert_allclose(e.logprobs, p.logprobs[:cut], rtol=1e-5, atol=1e-5)
    # a stop sequence cuts tokens and logprobs together, on both routes
    stop = plain[2].tokens[5:7]
    for eng in (_port(model, tcfg), _port(model, tcfg, speculate_k=3, spec_ref_len=16)):
        r = eng.submit(prompts[2], 12, stop=[stop])
        eng.drain([r])
        assert r.finish_reason == "stop" and r.tokens == plain[2].tokens[:5]
        np.testing.assert_allclose(r.logprobs, plain[2].logprobs[:5], rtol=1e-5, atol=1e-5)


def test_http_and_serve_cli_output(setup, tmp_path):
    _, _, tcfg, model, prompts = setup
    eng = _port(model, tcfg)
    srv = EngineServer(eng, lambda t: list(t.encode()), lambda ids: "".join(map(chr, ids)),
                       default_max_tokens=5)
    host, port = srv.serve(port=0)
    try:
        req = urllib.request.Request(f"http://{host}:{port}/v1/completions",
                                     data=json.dumps({"prompt": "hi there"}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        srv.shutdown()
    lps = out["logprobs"]["token_logprobs"]
    assert len(lps) == out["tokens"] == 5
    assert all(round(x, 6) == x and x <= 0 for x in lps)

    # cli/serve.py: logprobs per row, adapters saved by save_adapter, a
    # request's adapter and sample_seed
    family = "tiny-llava-test"
    mcfg = tconfig.build_model_config(tconfig.get_model_identifiers(family))
    vlm = tcommon.init_or_load_params(tconfig.get_model_identifiers(family), None, seed=7,
                                      dtype=torch.float32, device="cpu")[2]
    tree = tlora.init_model_lora(vlm, 4, torch.Generator().manual_seed(1))
    tree = tree_map(lambda x: (x + 0.05).detach(), tree)  # b off zero
    tckpt.save_adapter(tmp_path / "ad", tree, 2.0)
    lines = [{"question": "who?", "max_new_tokens": 5},
             {"question": "where?", "max_new_tokens": 6, "adapter": "ft", "sample_seed": 9}]
    (tmp_path / "reqs.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))
    args = [f"model_family={family}", "device=cpu", "dtype=float32", "quantize_base=false",
            "seed=7", "num_slots=2", "max_length=256", "logprobs=true", "temperature=0.8",
            f"requests={tmp_path / 'reqs.jsonl'}", f"save_file={tmp_path / 'out.jsonl'}",
            f"adapters={{ft: {tmp_path / 'ad'}}}"]
    rows = tserve.main(args)
    assert [len(r["logprobs"]) for r in rows] == [r["tokens"] for r in rows] == [5, 6]
    assert [json.loads(x) for x in (tmp_path / "out.jsonl").read_text().splitlines()] == rows
    # the same requests through an engine built directly
    proc = tcommon.build_processor(tconfig.get_model_identifiers(family))
    eng = ServingEngine(vlm, mcfg, "llava", num_slots=2, max_len=256,
                        pad_token_id=proc.tokenizer.pad_token_id,
                        eos_token_id=proc.tokenizer.eos_token_id, cache_dtype=torch.float32,
                        compute_dtype=torch.float32, device="cpu", logprobs=True,
                        temperature=0.8, adapters={"ft": tckpt.load_adapter(tmp_path / "ad")})
    reqs = [eng.submit(proc._encode_expand(proc.format(x["question"], None, False)),
                       x["max_new_tokens"], sample_seed=x.get("sample_seed"),
                       adapter=x.get("adapter")) for x in lines]
    eng.drain(reqs)
    for r, row in zip(reqs, rows):
        assert row["tokens"] == len(r.tokens)
        np.testing.assert_allclose(row["logprobs"], r.logprobs, atol=1e-6)
