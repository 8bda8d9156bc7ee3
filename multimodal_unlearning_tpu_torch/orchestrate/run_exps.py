"""Experiment orchestrator, the port's counterpart of
``multimodal_unlearning_tpu/orchestrate/run_exps.py`` (reference:
run_exps.py:1-137).

Fans a forget-loss sweep out over a worker pool, one worker per device,
running the port's forget -> eval CLIs (``cli.{stack}_forget``,
``cli.{stack}_eval``) as subprocesses with skip-if-artifact-exists
idempotency (``model.safetensors``, ``eval_results/eval_log_aggregated.json``;
run_exps.py:30,42) and per-experiment log capture + try/except-and-continue
failure isolation (run_exps.py:49-55,124-130).

Device pinning: each worker gets a device spec string exported as
``MMU_DEVICE`` and mirrored into ``CUDA_VISIBLE_DEVICES`` (one card per
worker).  The device ``cpu`` runs both CLIs on the host (``+device=cpu``).

Overrides pass to the forget CLI, less the eval-only ones (``data_path=``,
``ds_size=``, ``generation.``, ``eval_task``, ``processor_path=``), and a
filtered set to the eval CLI, as in the JAX package.  An override prefixed
``forget.`` goes to the forget CLI alone, its prefix dropped: the text
stack's forget CLI reads ``data_path`` too, which the filter keeps from it
(``forget.data_path=synthetic``).

Usage:
  python -m multimodal_unlearning_tpu_torch.orchestrate.run_exps \\
      devices=0 losses='[npo, grad_ascent]' model_family=... ...
"""

from __future__ import annotations

import os
import queue
import subprocess
import sys
import threading
import traceback
from pathlib import Path

PACKAGE = "multimodal_unlearning_tpu_torch"

# default sweep (run_exps.py:92-103)
DEFAULT_LOSSES = [
    "LLMU", "scrub", "dpo", "RMU", "grad_diff_forget_ce_retain_ce",
    "retain_ft", "grad_ascent", "KL", "idk", "npo",
]
# eval-only knobs must not reach the forget CLI (strict override checking)
EVAL_ONLY = ("data_path=", "ds_size=", "generation.", "eval_task", "processor_path=")
# the shared knobs the eval CLI takes
EVAL_SHARED = ("model_family=", "data_path=", "dtype=", "ds_size=", "batch_size=",
               "max_length=", "generation.")
FORGET_ONLY = "forget."


def forget_done(save_dir: str) -> bool:
    return (Path(save_dir) / "model.safetensors").exists()


def eval_done(save_dir: str) -> bool:
    return (Path(save_dir) / "eval_results" / "eval_log_aggregated.json").exists()


def stage_overrides(overrides: list[str], save_dir: str | None):
    """(forget CLI overrides, eval CLI overrides) of one experiment."""
    shared = [o for o in overrides if not o.startswith(FORGET_ONLY)]
    forget = [o for o in shared if not o.startswith(EVAL_ONLY)]
    forget += [o[len(FORGET_ONLY):] for o in overrides if o.startswith(FORGET_ONLY)]
    ev = [f"model_path={save_dir}", f"save_dir={save_dir}/eval_results"]
    ev += [o for o in shared if o.startswith(EVAL_SHARED)]
    return forget, ev


def launch(module: str, args: list[str], log_path: Path, env: dict) -> bool:
    """One CLI as a subprocess, its output into ``log_path``."""
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, "-m", module, *args],
                              stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc.returncode == 0


def run_single_exp(loss: str, overrides: list[str], device: str, log_dir: Path,
                   stack: str = "mm") -> bool:
    """forget -> eval for one loss (run_single_exp, run_exps.py:21-55)."""
    log_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["MMU_DEVICE"] = device
    on_cpu = device == "cpu"
    if not on_cpu:
        env.setdefault("CUDA_VISIBLE_DEVICES", device)
    cpu = ["+device=cpu"] if on_cpu else []

    save_dir_ov = [o for o in overrides if o.startswith("save_dir=")]
    save_dir = save_dir_ov[0].split("=", 1)[1] if save_dir_ov else None
    forget_args, eval_args = stage_overrides(overrides, save_dir)
    forget_mod = f"{PACKAGE}.cli.{stack}_forget"
    eval_mod = f"{PACKAGE}.cli.{stack}_eval"

    if save_dir and forget_done(save_dir):
        print(f"[{device}] skip forget {loss}: artifact exists")
    else:
        ok = launch(forget_mod, [f"forget_loss={loss}", *forget_args, *cpu],
                    log_dir / f"forget_{loss}.log", env)
        if not ok:
            print(f"[{device}] forget {loss} FAILED (see {log_dir}/forget_{loss}.log)")
            return False

    if save_dir:
        if eval_done(save_dir):
            print(f"[{device}] skip eval {loss}: artifact exists")
            return True
        ok = launch(eval_mod, eval_args + cpu, log_dir / f"eval_{loss}.log", env)
        if not ok:
            print(f"[{device}] eval {loss} FAILED")
            return False
    return True


def run_sweep(losses, overrides_per_loss, devices, log_root="exp_logs", stack="mm"):
    """Thread pool: one worker per device consuming the loss queue
    (run_exps.py:118-137)."""
    q: queue.Queue = queue.Queue()
    for loss in losses:
        q.put(loss)
    results = {}
    lock = threading.Lock()

    def worker(device: str):
        while True:
            try:
                loss = q.get_nowait()
            except queue.Empty:
                return
            try:
                ok = run_single_exp(loss, overrides_per_loss(loss), device,
                                    Path(log_root) / loss, stack=stack)
            except Exception:
                traceback.print_exc()
                ok = False
            with lock:
                results[loss] = ok
            q.task_done()

    threads = [threading.Thread(target=worker, args=(d,)) for d in devices]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def parse_args(args: list[str]):
    """(losses, devices, stack, log_root, passthrough overrides)."""
    losses, devices, stack, log_root = DEFAULT_LOSSES, ["0"], "mm", "exp_logs"
    passthrough = []
    for a in args:
        if a.startswith("losses="):
            losses = [x.strip() for x in a.split("=", 1)[1].strip("[]").split(",")]
        elif a.startswith("devices="):
            devices = [x.strip() for x in a.split("=", 1)[1].strip("[]").split(",")]
        elif a.startswith("stack="):
            stack = a.split("=", 1)[1]
        elif a.startswith("log_root="):
            log_root = a.split("=", 1)[1]
        else:
            passthrough.append(a)
    return losses, devices, stack, log_root, passthrough


def overrides_for(passthrough: list[str]):
    """Each loss's overrides: the passthrough ones plus, unless one is
    given, ``save_dir={model_path}/{loss}_sweep``."""
    def per_loss(loss):
        ov = list(passthrough)
        if not any(o.startswith("save_dir=") for o in ov):
            mp = next((o.split("=", 1)[1] for o in ov if o.startswith("model_path=")),
                      "models/run")
            ov.append(f"save_dir={mp}/{loss}_sweep")
        return ov

    return per_loss


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    losses, devices, stack, log_root, passthrough = parse_args(args)
    results = run_sweep(losses, overrides_for(passthrough), devices, log_root=log_root,
                        stack=stack)
    print(results)
    failed = [k for k, v in results.items() if not v]
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
