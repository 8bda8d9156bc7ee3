"""The port's ServingEngine against the JAX package's on tiny-llava-test in
f32 on the CPU, the same weights carried across by ``models/convert.py``:
mixed prompt lengths, one image request, two slots for five requests (slot
recycling) and an eos that ends one request early and frees its slot.
Token streams must be identical, in pipelined and in sync mode.  Also the
CLI: ``run()`` writes one well-formed completion per request.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.models import llava as jllava
from multimodal_unlearning_tpu.serve import ServingEngine as JaxEngine
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.serve import ServingEngine

ENGINE_KW = dict(num_slots=2, max_len=128, chunk=4, bucket_multiple=16, pad_token_id=0)
# (prompt length, max_new_tokens, with image)
SPECS = [(5, 6, False), (11, 9, True), (3, 9, False), (20, 5, False), (8, 7, False)]


@pytest.fixture(scope="module")
def setup():
    arch = get_model_identifiers("tiny-llava-test").arch
    jcfg = jllava.LlavaConfig.from_registry(arch)
    params = jllava.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tconfig.LlavaConfig.from_registry(arch)
    model = convert.from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    n_img = jcfg.num_image_tokens
    reqs = []
    for plen, max_new, image in SPECS:
        prompt = rng.integers(3, jcfg.image_token_id, plen).tolist()
        pix = None
        if image:
            prompt = prompt[:2] + [jcfg.image_token_id] * n_img + prompt[2:]
            pix = rng.standard_normal((32, 32, 3)).astype(np.float32)
        reqs.append((prompt, max_new, pix))

    def port(eos, pipeline):
        eng = ServingEngine(model, tcfg, "llava", eos_token_id=eos, cache_dtype=torch.float32,
                            compute_dtype=torch.float32, pipeline=pipeline, device="cpu",
                            **ENGINE_KW)
        out = [eng.submit(p, n, pixel_values=x) for p, n, x in reqs]
        eng.run()
        assert all(r.done for r in out)
        return [r.tokens for r in out]

    # an eos taken from the free-running streams: request 2 stops after 3 tokens
    free = port(None, True)
    eos = free[2][3]
    jeng = JaxEngine(params, jcfg, "llava", eos_token_id=eos, cache_dtype=jnp.float32,
                     compute_dtype=jnp.float32, **ENGINE_KW)
    jreqs = [jeng.submit(p, n, pixel_values=x) for p, n, x in reqs]
    want = jeng.drain(jreqs)
    return port, eos, free, want, model, tcfg


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
def test_engine_streams_match_jax(setup, pipeline):
    port, eos, free, want, _, _ = setup
    got = port(eos, pipeline)
    assert got == want
    # the eos ended request 2 early (and so freed its slot for the queue)
    assert len(got[2]) < SPECS[2][1] and eos not in got[2]
    assert [len(t) for t in free] == [n for _, n, _ in SPECS]


def test_engine_stop_sequence_and_cancel(setup):
    *_, model, tcfg = setup
    eng = ServingEngine(model, tcfg, "llava", cache_dtype=torch.float32,
                        compute_dtype=torch.float32, device="cpu", **ENGINE_KW)
    a = eng.submit([5, 6, 7], 8)
    b = eng.submit([9, 10, 11, 12], 8)
    eng.run()
    stop = a.tokens[2:4]
    first_at = next(i for i in range(len(a.tokens)) if a.tokens[i:i + 2] == stop)
    c = eng.submit([5, 6, 7], 8, stop=[stop])
    d = eng.submit([9, 10, 11, 12], 8)
    e = eng.submit([9, 10], 8)
    assert eng.cancel(e) and e.done and not e.tokens
    eng.run()
    assert c.tokens == a.tokens[:first_at]
    assert d.tokens == b.tokens
    assert eng.stats()["prefills"] == 4
    # a stop matched by the very first token retires the request and frees
    # its slot (the JAX engine leaks the slot there)
    f = eng.submit([5, 6, 7], 8, stop=[a.tokens[:1]])
    eng.run()
    assert f.done and f.tokens == [] and f.finish_reason == "stop"
    assert sorted(eng._free) == [0, 1]


@pytest.mark.parametrize("family", ["tiny-llava-test", "tiny-llama-test"])
def test_serve_cli_run(tmp_path, family):
    """A text-only family serves the image request's text and ignores the
    image, as the JAX CLI does."""
    from PIL import Image

    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 48, 3), np.uint8)).save(img)
    reqs = tmp_path / "reqs.jsonl"
    lines = [{"question": "What is shown?", "image": str(img)},
             {"question": "Who wrote it?", "max_new_tokens": 3},
             {"question": "x" * 150, "stop": "zz"}]
    reqs.write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    out = tmp_path / "out.jsonl"
    cfg = tserve.load_config([
        f"model_family={family}", "quantize_base=false", "dtype=float32", "device=cpu",
        "num_slots=2", "max_length=384", "generation.max_new_tokens=5",
        f"requests={reqs}", f"save_file={out}"])
    results = tserve.run(cfg)
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert rows == results and len(rows) == 3
    for row, line in zip(rows, lines):
        assert set(row) == {"question", "completion", "tokens"}
        assert row["question"] == line["question"]
        assert isinstance(row["completion"], str)
        assert 0 <= row["tokens"] <= line.get("max_new_tokens", 5)


def test_serve_config_overrides():
    cfg = tserve.load_config(["num_slots=3", "generation.max_new_tokens=7", "seed=null",
                              "dtype=float32", "quantize_base=false"])
    assert cfg["num_slots"] == 3 and cfg["generation"]["max_new_tokens"] == 7
    assert cfg["seed"] is None and cfg["quantize_base"] is False
    assert cfg["max_length"] == 2048 and cfg["chunk"] == 16  # serve.yaml defaults
    with pytest.raises(KeyError):
        tserve.load_config(["no_such_key=1"])
