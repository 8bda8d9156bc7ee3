"""The results CLIs of the port against the JAX package's (CPU, host only):
``cli/build_tables`` (``mode=vllm`` and ``mode=mod``: the JSON file, the
cached per-run files and the printed LaTeX table, byte for byte, the
papergray marker included; the port writes pandas' layouts by hand),
``cli/inspect_runs`` (``diff`` of two checkpoints read tensor by tensor,
``gens`` and ``sweep``: the same printed output) and ``cli/push_model``
(the same exit codes and report; the hub client is replaced by one that
refuses, so that no test reaches for the network)."""

import json
import sys
import types

import numpy as np
import pytest

from multimodal_unlearning_tpu.cli import build_tables as jtables
from multimodal_unlearning_tpu.cli import inspect_runs as jinspect
from multimodal_unlearning_tpu.cli import push_model as jpush
from multimodal_unlearning_tpu_torch.cli import build_tables as ttables
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.cli import inspect_runs as tinspect
from multimodal_unlearning_tpu_torch.cli import push_model as tpush
from multimodal_unlearning_tpu_torch.config import registry as tregistry

MM_TASKS = ["eval_real_faces_wo_options.json", "eval_real_world_wo_options.json",
            "eval_log.json", "eval_retain_facerec.json", "eval_log_forget.json",
            "eval_forget_facerec.json"]


def _task_log(rng, n, loss_scale):
    idx = [str(i) for i in range(n)]
    return {
        "avg_gt_loss": dict(zip(idx, (loss_scale * rng.uniform(0.2, 2.0, n)).tolist())),
        "average_perturb_loss": dict(zip(idx, rng.uniform(0.5, 3.0, (n, 3)).tolist())),
        "avg_paraphrased_loss": dict(zip(idx, rng.uniform(0.3, 2.5, n).tolist())),
        "rougeL_recall": dict(zip(idx, rng.uniform(0, 1, n).tolist())),
        "avg_gt_loss_raw": [],
        "generated_text": {i: [f"Question {i}/{loss_scale}?", f"gen {i} ÿ {rng.integers(99)}",
                               f"answer {i}"] for i in idx},
    }


def _write_run(d, seed, loss_scale=1.0, tasks=MM_TASKS):
    rng = np.random.default_rng(seed)
    logs = {t: _task_log(rng, 6, loss_scale) for t in tasks}
    (d / "eval_results").mkdir(parents=True)
    (d / "eval_results" / "eval_log_aggregated.json").write_text(json.dumps(logs, indent=4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("results")
    _write_run(root / "gold", 0)
    base = root / "base"
    _write_run(base, 1)
    _write_run(base / "npo_beta0.1_lr1e-05_5_L10.0_L00.0", 2)
    _write_run(base / "grad_ascent_lr2e-05_L1_0.001", 3, loss_scale=9.0)  # a collapsed retain
    for suffix, seed in (("_text", 4), ("_visual", 5)):
        _write_run(base / f"npo{suffix}", seed)
        _write_run(base / f"grad_ascent{suffix}", seed + 2, loss_scale=7.0)
    _write_run(base / "grad_ascent_sweep", 8)
    return root


@pytest.mark.parametrize("mode", ["vllm", "mod"])
def test_build_tables_matches_jax(runs, tmp_path, capsys, mode):
    args = [f"mode={mode}", f"base_model={runs / 'base'}", f"gold_model={runs / 'gold'}",
            "methods=[npo, grad_ascent, missing]"]
    jtables.main(args + [f"out={tmp_path / 'jax'}"])
    jout = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    ttables.main(args + [f"out={tmp_path / 'port'}"])
    tout = capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT")
    assert tout == jout
    assert "\\rowcolor{papergray} grad_ascent" in tout and "\\begin{tabular}" in tout
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == jfiles
    assert ("modalities_results.json" if mode == "mod" else "mm_results.json") in jfiles
    for name in jfiles:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), \
            name


@pytest.mark.parametrize("value", [0.0, 1.0, 0.3, 5e-11, 1.5e-10, 0.12345678905, -2.5e-7,
                                   88497.45981615045, 44541.59835238875, 1e15, float("nan")])
def test_json_floats_as_pandas_writes_them(value):
    pd = pytest.importorskip("pandas")
    want = pd.DataFrame({"a": [value]}).to_json()
    assert ttables.to_json_text({"a": [value]}).replace("\n", "").replace(" ", "") == want


def _checkpoint(d, seed):
    model_cfg = tregistry.get_model_identifiers("tiny-llama-test")
    _, _, model = tcommon.init_or_load_params(model_cfg, None, seed=seed, device="cpu")
    if seed == 1:  # one tensor shared with seed 0's model: "unchanged"
        _, _, other = tcommon.init_or_load_params(model_cfg, None, seed=0, device="cpu")
        model.norm.data.copy_(other.norm.data)
    tcommon.save_model(d, model_cfg, model)


@pytest.mark.parametrize("cmd", ["diff", "gens", "sweep"])
def test_inspect_runs_matches_jax(runs, tmp_path, capsys, cmd):
    if cmd == "diff":
        _checkpoint(tmp_path / "a", 0)
        _checkpoint(tmp_path / "b", 1)
        argv = ["diff", f"a={tmp_path / 'a'}", f"b={tmp_path / 'b'}", "top=7"]
    elif cmd == "gens":
        argv = ["gens", f"a={runs / 'base'}", f"b={runs / 'gold'}", "n=3"]
    else:
        argv = ["sweep", f"root={runs}"]
    jinspect.main(argv)
    jout = capsys.readouterr().out
    tinspect.main(argv)
    tout = capsys.readouterr().out
    assert tout == jout and len(tout.splitlines()) > 3


def test_push_model_matches_jax(tmp_path, capsys, monkeypatch):
    def refuse(*a, **kw):
        raise RuntimeError("no hub in tests")

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(HfApi=refuse))
    (tmp_path / "empty").mkdir()
    _checkpoint(tmp_path / "ckpt", 0)
    for argv, code in (([], 2), ([str(tmp_path / "empty"), "me/x"], 1),
                       ([str(tmp_path / "ckpt"), "me/x"], None)):
        outs = []
        for cli in (jpush, tpush):
            if code is None:
                cli.main(argv)
            else:
                with pytest.raises(SystemExit) as e:
                    cli.main(argv)
                assert e.value.code == code
            outs.append(capsys.readouterr().out)
        if code is None:
            want = "Would push ['config.json', 'model.safetensors'] from "
            assert outs[0].startswith(want) and outs[1].startswith(want)
            assert "not ported" in outs[1]
        else:
            assert outs[0] == outs[1]
