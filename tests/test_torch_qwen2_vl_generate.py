"""Qwen2-VL's generation in the port (CPU, f32, ``tiny-qwen2vl-test``; the
same weights as the JAX package's, drawn by the port, its biases given
random values, and carried across as numpy):

- ``greedy_generate`` with image prompts, plain and speculative, against
  the JAX package's: decode positions continue from the prefill's M-RoPE
  delta;
- ``cli/serve.py`` on image requests: the processor's patches and the
  vision-wrapped image span reach the engine, every request is served.

Token streams must be IDENTICAL: both sides compute in f32 with the same
weights, and only an exact tie of random logits could flip a token.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu.evaluation import generate as jgen
from multimodal_unlearning_tpu.models import qwen2_vl as jqwen
from multimodal_unlearning_tpu_torch import config as tconfig
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import serve as tserve
from multimodal_unlearning_tpu_torch.evaluation import generate as tgen
from multimodal_unlearning_tpu_torch.models import convert
from multimodal_unlearning_tpu_torch.models import qwen2_vl as tqwen
from multimodal_unlearning_tpu_torch.serve import ServingEngine

FAMILY = "tiny-qwen2vl-test"
NEW = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    arch = get_model_identifiers(FAMILY).arch
    jcfg, tcfg = jqwen.QwenVLConfig.from_registry(arch), tconfig.QwenVLConfig.from_registry(arch)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda t: t.numpy(), tcommon.model_tree(
        tqwen.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if str(p[-1].key).endswith("bias") else x, tree)
    g = jcfg.default_grid
    n_img = jcfg.num_image_tokens
    pix = rng.standard_normal((g[1] * g[2], jcfg.vision.patch_dim)).astype(np.float32)
    image = ([jcfg.vision_start_token_id] + [jcfg.image_token_id] * n_img
             + [jcfg.vision_end_token_id])
    prompts = []
    for i, n in enumerate((9, 21, 14)):
        text = rng.integers(3, 240, n)
        if i != 1:  # repetitive text: the 2-gram lookup fires
            text = np.tile(text[:3], -(-n // 3))[:n]
        prompts.append(([1] + image + text.tolist()) if i != 1 else [1] + text.tolist())
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), convert.from_jax(tree, tcfg, device="cpu"),
            pix, prompts, image)


@pytest.mark.parametrize("k", [0, 3], ids=["plain", "speculative"])
def test_greedy_generate_matches_jax(setup, k):
    jcfg, tcfg, jp, model, pix, prompts, _ = setup
    ids, mask = tgen.pad_prompts(prompts, 0, multiple=16)
    pixels = np.stack([pix * (i + 1) for i in range(len(prompts))])
    kw = dict(max_new_tokens=NEW, pad_token_id=0, is_vlm=True, speculate_k=k)
    want = jgen.greedy_generate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                pixel_values=jnp.asarray(pixels), compute_dtype=jnp.float32,
                                cache_dtype=jnp.float32, **kw)
    got = tgen.greedy_generate(model, tcfg, ids, mask, pixel_values=pixels,
                               compute_dtype=torch.float32, cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_with_images(setup, tmp_path):
    """cli/serve.py on Qwen2-VL: an image request reaches the engine as the
    tower's patches behind a vision-wrapped image span; every request is
    served to its budget."""
    rng = np.random.default_rng(4)
    lines = []
    for i in range(3):
        path = None
        if i != 1:
            path = tmp_path / f"image{i}.png"
            Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(path)
        lines.append({"question": f"Who is in picture {i}?",
                      "image": None if path is None else str(path), "max_new_tokens": 6})
    (tmp_path / "reqs.jsonl").write_text("\n".join(json.dumps(x) for x in lines))
    cfg = tserve.load_config([f"model_family={FAMILY}", "device=cpu", "dtype=float32",
                              "quantize_base=false", f"requests={tmp_path / 'reqs.jsonl'}",
                              f"save_file={tmp_path / 'out.jsonl'}", "num_slots=2",
                              "max_length=256"])
    seen = []
    submit = ServingEngine.submit

    def spy(engine, ids, n, pixel_values=None, **kw):
        seen.append((list(ids), pixel_values))
        return submit(engine, ids, n, pixel_values=pixel_values, **kw)

    ServingEngine.submit = spy
    try:
        results = tserve.run(cfg)
    finally:
        ServingEngine.submit = submit
    assert [r["tokens"] for r in results] == [6, 6, 6]
    _, processor, _, mcfg = tserve.build_engine(dict(cfg, quantize_base=False))
    g = mcfg.vision.image_size // mcfg.vision.patch_size
    for (ids, pix), line in zip(seen, lines):
        assert (pix is None) == (line["image"] is None)
        if pix is not None:
            assert pix.shape == (g * g, mcfg.vision.patch_dim)
            assert ids.count(mcfg.image_token_id) == mcfg.num_image_tokens
            assert ids.count(mcfg.vision_start_token_id) == 1
