"""The eval CLI on Qwen2-VL end to end (CPU, f32, ``tiny-qwen2vl-test``): the
port's ``cli/mm_eval.run`` against the JAX package's on one checkpoint in
HF layout, synthetic CLEAR data, two tasks (``eval_log_forget`` and
``eval_retain_facerec``), ``ds_size`` 6 at ``batch_size`` 4 and 4 new
tokens; the port's plain ``greedy_generate`` route and its serving-engine
route (``engine_generate=true``) both against the JAX CLI's run; then
``cli/mm_calculate_metrics.run`` of both packages on the two aggregates.

Tolerances, as the LLaVA eval CLI test holds them: generated texts and
token counts identical (f32 on both sides), losses, ratios and ROUGE to
1e-4 relative, the metrics to 1e-6 relative.
"""

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

FAMILY = "tiny-qwen2vl-test"
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
    path = tmp_path_factory.mktemp("qwen_eval") / "ckpt"
    mc = get_model_identifiers(FAMILY)
    _, _, model = tcommon.init_or_load_params(mc, None, seed=0, device="cpu")
    tcommon.save_model(path, mc, model)
    return path


def _cfg(load, ckpt, save_dir, *extra):
    cfg = load(config_dir() / "mm", "eval", [
        f"model_family={FAMILY}", f"model_path={ckpt}", "processor_path=null",
        "dtype=float32", "ds_size=6", "batch_size=4", "max_length=256",
        "generation.max_new_tokens=4", "eval_task_ids=[2,5]", f"save_dir={save_dir}", *extra])
    dict.__setitem__(cfg, "data_path", [DATA] * 6)
    return cfg


@pytest.fixture(scope="module")
def jax_run(ckpt):
    save_dir = ckpt.parent / "jax"
    return jeval.run(_cfg(jload, ckpt, save_dir)), save_dir


def _assert_logs_match(got: dict, want: dict):
    assert list(got) == list(want)
    for task in want:
        g, w = got[task], want[task]
        assert sorted(g) == sorted(w), task
        for key in w:
            assert list(g[key]) == list(w[key]), (task, key)
            if key in EXACT:
                assert g[key] == w[key], (task, key)
                continue
            for idx in w[key]:
                np.testing.assert_allclose(g[key][idx], w[key][idx], rtol=1e-4, atol=0,
                                           err_msg=f"{task} {key} {idx}")


@pytest.mark.parametrize("route", ["greedy_generate", "engine_generate"])
def test_eval_cli_matches_jax(ckpt, jax_run, route, tmp_path):
    want, jdir = jax_run
    got = teval.run(_cfg(tload, ckpt, tmp_path / route, "+device=cpu",
                         f"engine_generate={route == 'engine_generate'}"))
    assert list(got) == ["eval_log_forget.json", "eval_retain_facerec.json"]
    _assert_logs_match(got, want)
    if route == "greedy_generate":
        args = [f"ckpt_result={tmp_path / route / 'eval_log_aggregated.json'}",
                f"retain_result={jdir / 'eval_log_aggregated.json'}"]
        jm = jcalc.run(jload(config_dir() / "mm", "calculate_metrics",
                             args + [f"save_file={tmp_path / 'jax.json'}"]))
        tm = tcalc.run(tload(config_dir() / "mm", "calculate_metrics",
                             args + [f"save_file={tmp_path / 'port.json'}"]))
        assert list(tm) == list(jm)
        for k in jm:
            if k in ("method", "submitted_by"):
                assert tm[k] == jm[k]
            else:
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, atol=0, err_msg=k)
