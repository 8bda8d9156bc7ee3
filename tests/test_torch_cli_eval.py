"""The eval CLIs end to end (CPU): the port's ``cli/mm_eval.run`` against the
JAX package's on one tiny LLaVA checkpoint in HF layout (written once),
synthetic CLEAR data, two tasks (``eval_log_forget``, and
``eval_retain_facerec``, which adds ``normalized_gt_loss``), ``ds_size`` 6
at ``batch_size`` 4 (a tail of 2 rows padded to 4) and 4 new tokens; then
the same through the serving engine (``engine_generate=true``, held against
the JAX CLI's per-batch run, which the JAX package's own tests hold equal
to its engine run); then ``cli/mm_calculate_metrics.run`` of both packages
on the same two aggregates.

Tolerances.  Generated texts, questions, answers, indices and token counts
are identical (f32 on both sides: a flip needs an exact tie of random
logits).  Losses, ratios and ROUGE scores agree to 1e-4 relative, the
models' tolerance since the first slice.  The metrics, computed by each
package from the same files, agree to 1e-6 relative.
"""

import json

import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import mm_calculate_metrics as jcalc
from multimodal_unlearning_tpu.cli import mm_eval as jeval
from multimodal_unlearning_tpu.config import load_config as jload
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import mm_calculate_metrics as tcalc
from multimodal_unlearning_tpu_torch.cli import mm_eval as teval
from multimodal_unlearning_tpu_torch.config import load_config as tload
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers

DATA = "synthetic:n_persons=80,qa_per_person=8"
EXACT = {"generated_text", "num_token_gt", "num_token_paraphrased", "num_token_perturb"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One tiny LLaVA checkpoint in HF layout that both CLIs load."""
    path = tmp_path_factory.mktemp("eval") / "ckpt"
    mc = get_model_identifiers("tiny-llava-test")
    _, _, model = tcommon.init_or_load_params(mc, None, seed=0, device="cpu")
    tcommon.save_model(path, mc, model)
    return path


def _cfg(load, ckpt, save_dir, *extra):
    cfg = load(config_dir() / "mm", "eval", [
        "model_family=tiny-llava-test", f"model_path={ckpt}", "processor_path=null",
        "dtype=float32", "ds_size=6", "batch_size=4", "max_length=256",
        "generation.max_new_tokens=4", "eval_task_ids=[2,5]", f"save_dir={save_dir}", *extra])
    # a list of synthetic specs holds commas: set it on the loaded config
    dict.__setitem__(cfg, "data_path", [DATA] * 6)
    return cfg


@pytest.fixture(scope="module")
def jax_run(ckpt):
    save_dir = ckpt.parent / "jax"
    return jeval.run(_cfg(jload, ckpt, save_dir)), save_dir


def _port_run(ckpt, route):
    save_dir = ckpt.parent / route
    return teval.run(_cfg(tload, ckpt, save_dir, "+device=cpu",
                          f"engine_generate={route == 'engine_generate'}")), save_dir


@pytest.fixture(scope="module")
def port_run(ckpt):
    return _port_run(ckpt, "greedy_generate")


def _assert_logs_match(got: dict, want: dict):
    assert list(got) == list(want)
    for task in want:
        g, w = got[task], want[task]
        assert sorted(g) == sorted(w), task
        for key in w:
            assert list(g[key]) == list(w[key]), (task, key)  # the same indices, in order
            if key in EXACT:
                assert g[key] == w[key], (task, key)
                continue
            for idx in w[key]:
                np.testing.assert_allclose(g[key][idx], w[key][idx], rtol=1e-4, atol=0,
                                           err_msg=f"{task} {key} {idx}")


@pytest.mark.parametrize("route", ["greedy_generate", "engine_generate"])
def test_eval_cli_matches_jax(ckpt, jax_run, port_run, route):
    want, jdir = jax_run
    got, save_dir = port_run if route == "greedy_generate" else _port_run(ckpt, route)
    assert list(got) == ["eval_log_forget.json", "eval_retain_facerec.json"]
    assert len(got["eval_log_forget.json"]["avg_gt_loss"]) == 6  # the tail rows once
    assert "normalized_gt_loss" in got["eval_retain_facerec.json"]
    assert "normalized_gt_loss" not in got["eval_log_forget.json"]
    _assert_logs_match(got, want)
    # the files: string keys, (question, generated, answer) lists
    for name in ("eval_log_forget.json", "eval_retain_facerec.json",
                 "eval_log_aggregated.json"):
        g, w = (json.loads((d / name).read_text()) for d in (save_dir, jdir))
        _assert_logs_match(g if name.startswith("eval_log_agg") else {name: g},
                           w if name.startswith("eval_log_agg") else {name: w})


def test_calculate_metrics_matches_jax(jax_run, port_run, tmp_path):
    _, jdir = jax_run
    _, pdir = port_run
    args = [f"ckpt_result={pdir / 'eval_log_aggregated.json'}",
            f"retain_result={jdir / 'eval_log_aggregated.json'}"]
    want = jcalc.run(jload(config_dir() / "mm", "calculate_metrics",
                           args + [f"save_file={tmp_path / 'jax.json'}"]))
    got = tcalc.run(tload(config_dir() / "mm", "calculate_metrics",
                          args + [f"save_file={tmp_path / 'port.json'}"]))
    assert list(got) == list(want)
    assert got["method"] == want["method"] == "finetune"
    on_disk = json.loads((tmp_path / "port.json").read_text())
    assert list(on_disk) == list(json.loads((tmp_path / "jax.json").read_text()))
    for k in want:
        if k in ("method", "submitted_by"):
            assert got[k] == want[k]
            continue
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(on_disk[k], float(want[k]), rtol=1e-6, atol=0, err_msg=k)


def test_unported_options_raise(tmp_path):
    cfg = _cfg(tload, "null", tmp_path / "out", "+device=cpu", "mesh.tensor=2")
    with pytest.raises(NotImplementedError, match="mesh"):
        teval.run(cfg)
    assert not (tmp_path / "out").exists()
