"""The port's HTTP front end (serve/http.py + cli/serve_http.py) on the CPU.

The server is a thin shell over the engine: handlers enqueue, one engine
thread owns the engine.  Held here: concurrent completions equal direct
drains of a second engine on the same weights (a paged one behind the
server, a dense one as the reference), bad payloads and an unknown adapter
answer 400 and a per-request temperature is ignored (sampling is the
engine's setting, as in the JAX package) without stopping the loop,
a stop string cuts the text, stats and health answer, and
``cli.serve_http.make_server`` builds a server from a serve config.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.cli import serve_http
from multimodal_unlearning_tpu_torch.models import llama
from multimodal_unlearning_tpu_torch.serve import EngineServer, ServingEngine


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _engine(model, cfg, **kw):
    return ServingEngine(model, cfg, "llama", num_slots=2, max_len=128, chunk=3,
                         bucket_multiple=16, pad_token_id=0, eos_token_id=None,
                         cache_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
                         **kw)


def _enc(text):  # byte-level codec over the 256-token vocabulary
    return list(text.encode())


def _dec(ids):
    return bytes(int(t) % 256 for t in ids).decode("latin1")


@pytest.fixture(scope="module")
def server():
    cfg = tconfig.build_model_config(tconfig.get_model_identifiers("tiny-llama-test"))
    model = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = EngineServer(_engine(model, cfg, page_size=16), _enc, _dec, default_max_tokens=6)
    host, port = srv.serve(port=0)
    yield srv, f"http://{host}:{port}", cfg, model
    srv.shutdown()


def test_completions_match_direct_engine(server):
    srv, url, cfg, model = server
    assert _get(f"{url}/health")["ok"]
    prompts, budgets = ["who is A?", "tell me about B", "c?"], [5, 7, 4]
    results = [None] * len(prompts)

    def hit(i):
        results[i] = _post(f"{url}/v1/completions",
                           {"prompt": prompts[i], "max_tokens": budgets[i]})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    engine = _engine(model, cfg)
    want = engine.drain([engine.submit(_enc(p), m) for p, m in zip(prompts, budgets)])
    assert [r["text"] for r in results] == [_dec(w) for w in want]
    for r, m in zip(results, budgets):
        assert r["tokens"] == m and r["latency_s"] >= r["ttft_s"] >= 0
    st = _get(f"{url}/v1/stats")
    assert st["prefills"] >= 3 and st["pool_pages_used"] == 0 and "queued" in st


def test_bad_payloads_and_unported_options_keep_the_loop(server):
    _, url, *_ = server
    for payload, code in (({"max_tokens": 4}, 400), ({"prompt": "x", "max_tokens": 500}, 400),
                          ({"prompt": "x", "adapter": "npo"}, 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/v1/completions", payload)
        assert e.value.code == code, payload
    greedy = _post(f"{url}/v1/completions", {"prompt": "x", "max_tokens": 3})
    assert _post(f"{url}/v1/completions", {"prompt": "x", "max_tokens": 3,
                                           "temperature": 0.7})["text"] == greedy["text"]
    assert _post(f"{url}/v1/completions", {"prompt": "still alive?", "max_tokens": 3})[
        "tokens"] == 3


def test_stop_string_cuts_the_text(server):
    _, url, *_ = server
    text = _post(f"{url}/v1/completions", {"prompt": "stoptest", "max_tokens": 10})["text"]
    stop = text[3:5]
    out = _post(f"{url}/v1/completions", {"prompt": "stoptest", "max_tokens": 10, "stop": stop})
    assert out["text"] == text[:text.find(stop)]


def test_make_server_from_a_serve_config():
    cfg = tserve.load_config(["model_family=tiny-llava-test", "device=cpu", "dtype=float32",
                              "quantize_base=false", "num_slots=2", "max_length=256",
                              "chunk=4", "page_size=128", "generation.max_new_tokens=4"])
    srv = serve_http.make_server(cfg)
    host, port = srv.serve(port=0)
    try:
        out = _post(f"http://{host}:{port}/v1/completions", {"prompt": "What color is the sky?"})
        assert 1 <= out["tokens"] <= 4 and isinstance(out["text"], str)
        assert srv.engine.page == 128
    finally:
        srv.shutdown()


def test_make_server_serves_qwen():
    """The HTTP front end over Qwen2.5-VL (the windowed tower, M-RoPE): a
    text prompt in the qwen chat template is served."""
    cfg = tserve.load_config(["model_family=tiny-qwen25vl-test", "device=cpu", "dtype=float32",
                              "quantize_base=false", "num_slots=2", "max_length=256",
                              "chunk=4", "generation.max_new_tokens=4"])
    srv = serve_http.make_server(cfg)
    host, port = srv.serve(port=0)
    try:
        out = _post(f"http://{host}:{port}/v1/completions", {"prompt": "Who is this?"})
        assert 1 <= out["tokens"] <= 4 and isinstance(out["text"], str)
        assert srv.engine.kind == "qwen2_vl"
    finally:
        srv.shutdown()
