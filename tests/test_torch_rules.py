"""Rules of the PyTorch port: it imports neither ``jax`` nor the JAX
package (an AST scan, and an import of every module in a subprocess with
both blocked); its entry points refuse to run without a card unless the
caller asks for the CPU; options it has not ported raise (of the engine's,
``mesh`` alone); its presets equal the YAML registry."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import multimodal_unlearning_tpu_torch as port
from multimodal_unlearning_tpu.config import get_model_identifiers
from multimodal_unlearning_tpu_torch import config as tconfig

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "multimodal_unlearning_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_unlearning_tpu"}


def _port_files():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "bench_int_mm.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        # compare the top-level name exactly: the port's own name starts
        # with the JAX package's
        tops = {n.split(".")[0] for n in names}
        assert not tops & FORBIDDEN, f"{path.name}:{node.lineno} imports {tops & FORBIDDEN}"


def test_port_imports_with_jax_blocked():
    mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN)!r}: sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke, bench_int_mm\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    for name in ("serve.engine", "serve.http", "cli.serve_http", "ops.paged_attention",
                 "ops.int4_matmul",
                 "train.trainer", "train.losses", "train.optim", "utils.quantize",
                 "utils.pytree", "models.lora", "cli.mm_forget", "bench",
                 "config.loader", "config.registry", "utils.native",
                 "data.datasets", "data.loader", "data.prefetch",
                 "train.checkpoints", "train.loop", "models.hf_bridge",
                 "evaluation", "evaluation.rouge", "evaluation.metrics", "evaluation.generate",
                 "evaluation.evaluator", "cli.mm_eval", "cli.mm_calculate_metrics",
                 "models.qwen2_vl", "methods.salun", "methods.eco.corrupt",
                 "methods.eco.attacked_model", "methods.eco.classifier",
                 "methods.eco.prepare_prompts", "methods.eco.train_classifiers",
                 "cli.salun_generate", "cli.eco_prepare", "cli.eco_train_classifiers",
                 "orchestrate.run_exps"):
        assert f"multimodal_unlearning_tpu_torch.{name}" in mods


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    from multimodal_unlearning_tpu_torch.cli import serve
    from multimodal_unlearning_tpu_torch.models import llama, llava
    from multimodal_unlearning_tpu_torch.serve import ServingEngine

    cfg = tconfig.build_model_config(tconfig.get_model_identifiers("tiny-llava-test"))
    with pytest.raises(RuntimeError, match="CUDA"):
        llava.Llava(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(cfg.decoder)
    model = llava.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, cfg, "llava")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_engine(serve.load_config(
            ["model_family=tiny-llava-test", "quantize_base=false"]))
    ServingEngine(model, cfg, "llava", device="cpu")
    from multimodal_unlearning_tpu_torch import bench

    with pytest.raises(RuntimeError, match="CUDA"):
        bench.setup("tiny-llava-test")
    from multimodal_unlearning_tpu_torch.models import convert

    with pytest.raises(RuntimeError, match="CUDA"):
        convert.adapters_from_jax({"a": [[0.0]]})
    from multimodal_unlearning_tpu_torch.cli import mm_forget
    from multimodal_unlearning_tpu_torch.config import load_config
    from multimodal_unlearning_tpu_torch.config.registry import config_dir

    with pytest.raises(RuntimeError, match="CUDA"):
        mm_forget.run(load_config(config_dir() / "mm", "forget", [
            "model_family=tiny-llava-test", "LoRA.r=4", "forget_data_path=synthetic",
            "retain_data_path=synthetic", "save_dir=/nonexistent/never-created"]))
    from multimodal_unlearning_tpu_torch.cli import mm_calculate_metrics, mm_eval

    with pytest.raises(RuntimeError, match="CUDA"):
        mm_eval.run(load_config(config_dir() / "mm", "eval", [
            "model_family=tiny-llava-test", "data_path=[synthetic]", "split_list=[full]",
            "eval_task=[eval_log]", "question_key=[question]", "answer_key=[caption]",
            "base_answer_key=[caption]", "perturbed_answer_key=[perturbed_captions]",
            "save_dir=/nonexistent/never-created"]))
    from multimodal_unlearning_tpu_torch.cli import eco_prepare, salun_generate

    with pytest.raises(RuntimeError, match="CUDA"):
        salun_generate.run(load_config(config_dir() / "methods", "salun", [
            "save_dir=/nonexistent/never-created"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        eco_prepare.run(load_config(config_dir() / "methods", "eco_llama2-7b", [
            "out_dir=/nonexistent/never-created"]))
    # the metrics CLI reads two eval aggregates and computes on the host: it
    # has no device to ask for, and runs here
    from multimodal_unlearning_tpu_torch.evaluation.metrics import FILE_TO_TASK

    log = {"avg_gt_loss": {"0": 1.0, "3": 2.0}, "avg_paraphrased_loss": {"0": 1.5, "3": 0.5},
           "average_perturb_loss": {"0": [2.0, 2.5], "3": [1.0, 3.0]},
           "rougeL_recall": {"0": 0.5, "3": 1.0}}
    agg = tmp_path / "agg.json"
    agg.write_text(json.dumps({name: log for name in FILE_TO_TASK}))
    out = mm_calculate_metrics.run(load_config(config_dir() / "mm", "calculate_metrics", [
        f"ckpt_result={agg}", f"retain_result={agg}", f"save_file={tmp_path / 'm.json'}"]))
    assert np.isfinite(out["Model Utility"])


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"cache_dtype": torch.float64},
], ids=lambda o: next(iter(o)))
def test_unported_engine_options_raise(option):
    from multimodal_unlearning_tpu_torch.models import llava
    from multimodal_unlearning_tpu_torch.serve import ServingEngine

    cfg = tconfig.build_model_config(tconfig.get_model_identifiers("tiny-llava-test"))
    model = llava.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        ServingEngine(model, cfg, "llava", device="cpu", **option)


@pytest.mark.parametrize("option", [
    {"speculate_k": 2}, {"prefill_chunk": 64}, {"cache_dtype": torch.int8}, {"page_size": 16},
    {"temperature": 0.7}, {"logprobs": True}, {"adapters": "one"},
], ids=lambda o: next(iter(o)))
def test_ported_engine_options_construct(option):
    from multimodal_unlearning_tpu_torch.models import llava, lora
    from multimodal_unlearning_tpu_torch.serve import ServingEngine

    cfg = tconfig.build_model_config(tconfig.get_model_identifiers("tiny-llava-test"))
    model = llava.init_params(cfg, device="cpu")
    if option.get("adapters"):
        tree = lora.init_model_lora(model, 2, torch.Generator().manual_seed(0))
        option = {"adapters": {"one": (tree, 2.0)}}
    ServingEngine(model, cfg, "llava", device="cpu", **option)
    if option.get("temperature"):  # speculation verifies against the argmax
        with pytest.raises(ValueError, match="speculate_k"):
            ServingEngine(model, cfg, "llava", device="cpu", speculate_k=2, **option)


@pytest.mark.parametrize("key", ["processor_path"])
def test_unported_serve_options_raise(key, tmp_path):
    """A directory with HF tokenizer files, which the JAX package would load
    with ``transformers``: the port raises.  (A path without them is ignored,
    there as here: serve.yaml's ``processor_path`` is ``model_path``.)"""
    from multimodal_unlearning_tpu_torch.cli import serve

    (tmp_path / "tokenizer.json").write_text("{}")
    cfg = serve.load_config(["model_family=tiny-llava-test", "device=cpu",
                             "quantize_base=false", f"{key}={tmp_path}"])
    with pytest.raises(NotImplementedError):
        serve.build_engine(cfg)


@pytest.mark.parametrize("override", ["quantize_base=int4", "quantize_base=int4:g64",
                                      "model_path=/nonexistent"])
def test_ported_serve_options_construct(override, capsys):
    """``model_path`` loads a checkpoint; where there is none the weights
    come from the seed, with the JAX package's message."""
    from multimodal_unlearning_tpu_torch.cli import serve

    cfg = serve.load_config(["model_family=tiny-llava-test", "device=cpu", override])
    serve.build_engine(cfg)
    if override.startswith("model_path"):
        assert ("No checkpoint at /nonexistent; using random init (zero-egress mode)"
                in capsys.readouterr().out)


@pytest.mark.parametrize("name", sorted(tconfig.PRESETS))
def test_presets_equal_the_registry(name):
    """The port's registry entry, fully resolved, is the JAX package's."""
    assert tconfig.get_model_identifiers(name).to_dict() == get_model_identifiers(name).to_dict()


def test_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor the card gets no plain version: the
    wrappers raise rather than fall back."""
    from multimodal_unlearning_tpu_torch.ops.attention import flash_attention
    from multimodal_unlearning_tpu_torch.ops.decode_attention import decode_attention

    q = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attention(q, q, q)
    cache = {"k": torch.empty((1, 1, 2, 4, 8), device="meta")}
    cache["v"] = cache["k"]
    with pytest.raises(RuntimeError, match="no kernel"):
        decode_attention(q[:, :, :1], cache, 0, torch.ones((1, 4), device="meta"))


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the kernels cannot be built, and saying so
    is an error, not a reason to use the plain versions."""
    from multimodal_unlearning_tpu_torch.ops import kernels

    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.launcher("flash_fwd")
