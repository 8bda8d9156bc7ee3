"""The sweep orchestrator on the port (``orchestrate/run_exps.py``) against
the JAX package's, with the subprocess launcher stubbed on both sides: the
commands each experiment launches (the port's CLIs in place of the JAX
package's, the same overrides and filters), the skip-if-done artifacts, the
per-loss logs, the worker pool's results dict and ``main``'s exit code.
The port's ``forget.`` prefix and its ``cpu`` device have no JAX
counterpart and are tested on their own.  Then one real run:
``stack=nlp`` with one loss on ``tiny-llama-test`` on the CPU, forget and
evaluation as subprocesses, and a second run that skips both and launches
nothing."""

import json
import subprocess
from pathlib import Path

import pytest

from multimodal_unlearning_tpu.orchestrate import run_exps as jrun
from multimodal_unlearning_tpu_torch.orchestrate import run_exps as trun

OVERRIDES = ["model_family=tiny-llava-test", "data_path=[synthetic,synthetic]", "ds_size=4",
             "generation.max_new_tokens=8", "eval_task=[eval_log]", "processor_path=x",
             "dtype=float32", "batch_size=2", "max_length=128", "LoRA.r=4", "lr=1e-4"]


class _Recorder:
    """A stand-in for ``subprocess.run``: records each command and fails the
    modules and losses it is told to."""

    def __init__(self, fail=()):
        self.calls, self.fail = [], fail

    def __call__(self, cmd, **kw):
        self.calls.append(cmd[1:])
        code = int(any(f in " ".join(cmd) for f in self.fail))
        return subprocess.CompletedProcess(cmd, code)


def _run_both(monkeypatch, fn, fail=()):
    """``fn(module, name)`` for the JAX package's module, then the port's,
    each under its own recorder (both modules call the one ``subprocess``)."""
    recs, out = {}, {}
    for name, mod in (("jax", jrun), ("port", trun)):
        recs[name] = _Recorder(fail)
        monkeypatch.setattr(subprocess, "run", recs[name])
        out[name] = fn(mod, name)
    return recs, out


def _as_jax(calls):
    return [[a.replace("multimodal_unlearning_tpu_torch.", "multimodal_unlearning_tpu.")
             for a in c] for c in calls]


@pytest.mark.parametrize("stack", ["mm", "nlp"])
def test_commands_and_filters_match_jax(stack, tmp_path, monkeypatch):
    save = f"save_dir={tmp_path / 'run'}"
    recs, ok = _run_both(monkeypatch, lambda mod, name: mod.run_single_exp(
        "npo", OVERRIDES + [save], "0", tmp_path / name, stack=stack))
    assert ok == {"jax": True, "port": True}
    assert recs["port"].calls and _as_jax(recs["port"].calls) == recs["jax"].calls
    forget, ev = recs["port"].calls
    assert forget[1] == f"multimodal_unlearning_tpu_torch.cli.{stack}_forget"
    assert ev[1] == f"multimodal_unlearning_tpu_torch.cli.{stack}_eval"
    assert not any(a.startswith(trun.EVAL_ONLY) for a in forget[2:])
    assert (tmp_path / "port" / "forget_npo.log").exists()
    assert (tmp_path / "port" / "eval_npo.log").exists()


def test_skip_if_done_matches_jax(tmp_path, monkeypatch, capsys):
    """A run whose model.safetensors exists skips forget; one whose eval
    aggregate exists too skips both and launches nothing."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "model.safetensors").write_bytes(b"")
    for done in ("forget", "both"):
        if done == "both":
            (run / "eval_results").mkdir()
            (run / "eval_results" / "eval_log_aggregated.json").write_text("{}")
        def one(mod, name):
            assert mod.run_single_exp("KL", OVERRIDES + [f"save_dir={run}"], "0",
                                      tmp_path / name)
            return capsys.readouterr().out

        recs, out = _run_both(monkeypatch, one)
        assert out["port"] == out["jax"]
        assert _as_jax(recs["port"].calls) == recs["jax"].calls
        assert len(recs["port"].calls) == (1 if done == "forget" else 0)
        assert "skip forget KL: artifact exists" in out["port"]


def test_sweep_results_and_exit_code_match_jax(tmp_path, monkeypatch):
    """Two workers over four losses, one forget and one eval failing: the
    same results dict and exit code; a run with no save_dir override saves
    under ``{model_path}/{loss}_sweep``."""
    fail = ("forget_loss=dpo", "KL_sweep/eval_results")
    args = ["losses=[npo, dpo, KL, idk]", "devices=[0, 1]", "stack=nlp",
            f"model_path={tmp_path}", "ds_size=4"]

    def one(mod, name):
        with pytest.raises(SystemExit) as e:
            mod.main(args + [f"log_root={tmp_path / name}"])
        return e.value.code

    recs, codes = _run_both(monkeypatch, one, fail)
    assert codes == {"jax": 1, "port": 1}
    assert sorted(map(tuple, _as_jax(recs["port"].calls))) == sorted(
        map(tuple, recs["jax"].calls))
    losses, devices, stack, _, passthrough = trun.parse_args(args)
    assert (losses, devices, stack) == (["npo", "dpo", "KL", "idk"], ["0", "1"], "nlp")
    assert trun.overrides_for(passthrough)("npo")[-1] == f"save_dir={tmp_path}/npo_sweep"
    got = trun.run_sweep(losses, trun.overrides_for(passthrough), devices,
                         log_root=tmp_path / "again", stack=stack)
    assert got == {"npo": True, "dpo": False, "KL": False, "idk": True}


def test_stage_prefixes_and_cpu_device(tmp_path, monkeypatch):
    """A ``forget.`` override reaches the forget CLI alone, its prefix
    dropped; the ``cpu`` device adds ``+device=cpu`` to both and pins no
    card."""
    rec = _Recorder()
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    seen = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, env, **kw: (
        seen.append(env.get("CUDA_VISIBLE_DEVICES")), rec(cmd))[1])
    assert trun.run_single_exp("npo", ["forget.data_path=synthetic", "ds_size=2",
                                       "batch_size=2", f"save_dir={tmp_path}"], "cpu",
                               tmp_path / "logs", stack="nlp")
    forget, ev = rec.calls
    assert forget[2:] == ["forget_loss=npo", "batch_size=2", f"save_dir={tmp_path}",
                          "data_path=synthetic", "+device=cpu"]
    assert ev[2:] == [f"model_path={tmp_path}", f"save_dir={tmp_path}/eval_results",
                      "ds_size=2", "batch_size=2", "+device=cpu"]
    assert seen == [None, None]


def test_real_sweep_on_the_cpu_then_skips(tmp_path, monkeypatch):
    """``stack=nlp``, one loss, forget then evaluation as subprocesses on the
    CPU; the second run finds both artifacts and launches nothing."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = "synthetic:n_persons=8"
    save = tmp_path / "grad_ascent_sweep"
    args = ["stack=nlp", "losses=[grad_ascent]", "devices=[cpu]",
            f"log_root={tmp_path / 'logs'}", "model_family=tiny-llama-test", "dtype=float32",
            "batch_size=2", "max_length=128", f"forget.data_path={data}",
            "gradient_accumulation_steps=1", "num_epochs=1",
            f"data_path=[{data},{data},{data},{data}]", "ds_size=2",
            "generation.max_new_tokens=4", f"save_dir={save}"]
    with pytest.raises(SystemExit) as e:
        trun.main(args)
    logs = tmp_path / "logs" / "grad_ascent"
    assert e.value.code == 0, [p.read_text()[-2000:] for p in logs.glob("*.log")]
    assert (save / "model.safetensors").exists()
    agg = json.loads((save / "eval_results" / "eval_log_aggregated.json").read_text())
    assert agg
    assert sorted(p.name for p in logs.iterdir()) == ["eval_grad_ascent.log",
                                                      "forget_grad_ascent.log"]
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: calls.append(a))
    with pytest.raises(SystemExit) as e:
        trun.main(args)
    assert e.value.code == 0 and not calls
    assert Path(save / "model.safetensors").exists()
