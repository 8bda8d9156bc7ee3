"""The text stack's evaluation and aggregation CLIs (CPU, f32): the port's
``cli/nlp_eval`` on ``configs/nlp/eval_everything.yaml`` (four tasks of
synthetic TOFU-style rows, ``ds_size`` 4, 8 new tokens) against the JAX
package's on one port-drawn ``tiny-llama-test`` checkpoint, by the greedy
route and by the engine route (``engine_generate=true speculative_k=4``),
the files it writes included; then ``cli/nlp_aggregate`` on the same two
aggregates (the JAX eval's as the checkpoint, the port's engine eval's as
retain) against the JAX CLI's.  Excluding a task that is there leaves its
utility keys empty and makes both CLIs raise alike.

Tolerances: eval values 1e-4 relative with every generated text equal; the
CSV 1e-6 relative, the same columns and text cells."""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import nlp_aggregate as jagg
from multimodal_unlearning_tpu.cli import nlp_eval as jeval
from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import nlp_aggregate as tagg
from multimodal_unlearning_tpu_torch.cli import nlp_eval as teval
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config import registry as tregistry

CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "nlp"
DATA = "synthetic:n_persons=20"
TASKS = ["eval_log.json", "eval_real_author_wo_options.json", "eval_real_world_wo_options.json",
         "eval_log_forget.json"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, str):
        assert a == b, where
    else:
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=where)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nlp_eval")
    model_cfg = tregistry.get_model_identifiers("tiny-llama-test")
    _, _, model = tcommon.init_or_load_params(model_cfg, None, seed=3, device="cpu")
    tcommon.save_model(tmp / "model", model_cfg, model)
    args = ["model_family=tiny-llama-test", "dtype=float32", "ds_size=4", "batch_size=4",
            "max_length=128", "generation.max_new_tokens=8", f"model_path={tmp / 'model'}",
            f"data_path=[{','.join([DATA] * 4)}]"]
    out = {"tmp": tmp, "jax": jeval.run(jload(CONFIGS, "eval_everything", args + [
        f"save_dir={tmp / 'jax'}"]))}
    for route, extra in (("greedy", []), ("engine", ["engine_generate=true", "speculative_k=4"])):
        out[route] = teval.run(tload(CONFIGS, "eval_everything", args + extra + [
            "+device=cpu", f"save_dir={tmp / route}"]))
    return out


@pytest.mark.parametrize("route", ["greedy", "engine"])
def test_eval_matches_jax(evals, route):
    got = evals[route]
    assert list(got) == TASKS
    _close(json.loads(json.dumps(got, default=float)),
           json.loads(json.dumps(evals["jax"], default=float)))
    for task in got:
        assert len(got[task]["avg_gt_loss"]) == 4
        assert ("normalized_gt_loss" in got[task]) == ("eval_log" not in task)
    for name in TASKS + ["eval_log_aggregated.json"]:  # the files the CLIs write
        _close(json.loads((evals["tmp"] / route / name).read_text()),
               json.loads((evals["tmp"] / "jax" / name).read_text()), name)


def _agg_args(tmp, excluded):
    return [f"ckpt_result={tmp / 'jax' / 'eval_log_aggregated.json'}",
            f"retain_result={tmp / 'engine' / 'eval_log_aggregated.json'}",
            "method_name=rmu", f"excluded_eval_files=[{excluded}]"]


def test_aggregate_excluding_a_task_raises_as_jax(evals):
    args = _agg_args(evals["tmp"], "eval_real_world_wo_options.json")
    save = [f"save_file={evals['tmp'] / 'x.csv'}"]
    with pytest.raises(ValueError) as jerr:
        jagg.run(jload(CONFIGS, "aggregate_eval_stat", args + save))
    with pytest.raises(ValueError) as terr:
        tagg.run(tload(CONFIGS, "aggregate_eval_stat", args + save))
    assert str(terr.value) == str(jerr.value)


def test_aggregate_matches_jax(evals):
    tmp = evals["tmp"]
    args = _agg_args(tmp, "no_such_task.json")
    jrow = jagg.run(jload(CONFIGS, "aggregate_eval_stat", args + [f"save_file={tmp / 'j.csv'}"]))
    trow = tagg.run(tload(CONFIGS, "aggregate_eval_stat", args + [f"save_file={tmp / 't.csv'}"]))
    assert list(trow) == list(jrow)
    with open(tmp / "j.csv") as f:
        jrows = list(csv.reader(f))
    with open(tmp / "t.csv") as f:
        trows = list(csv.reader(f))
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 2
    assert trows[0][-3:] == ["Forget Quality", "Method", "Submitted By"]
    for name, t, j in zip(trows[0], trows[1], jrows[1]):
        if name in ("Method", "Submitted By"):
            assert t == j
        else:
            assert np.isfinite(float(t)), name
            np.testing.assert_allclose(float(t), float(j), rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("flash", ["false", "true"])
def test_eval_attention_follows_the_registry(flash, tmp_path, monkeypatch):
    """``flash_attention2: "false"`` (tiny-llama-test as it ships, head dim
    16: no kernel takes it on the card) runs the plain attention through
    the teacher-forced forwards and generation; "true" goes through
    ``FlashAttention`` and the decode route's kernel path."""
    from multimodal_unlearning_tpu_torch.ops import attention

    calls = []
    apply = attention.FlashAttention.apply
    monkeypatch.setattr(attention.FlashAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    entry = dict(dict.__getitem__(tregistry.PRESETS, "tiny-llama-test"))
    entry["flash_attention2"] = flash
    monkeypatch.setitem(tregistry.PRESETS, "tiny-llama-test", entry)
    teval.main(["model_family=tiny-llama-test", "dtype=float32", "ds_size=2",
                "batch_size=2", "max_length=128", "generation.max_new_tokens=2",
                f"data_path=[{','.join([DATA] * 4)}]", f"save_dir={tmp_path}", "+device=cpu"])
    assert bool(calls) == (flash == "true")
