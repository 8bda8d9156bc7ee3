"""Run inspection: the port's copy of
``multimodal_unlearning_tpu/cli/inspect_runs.py``, with the same output.

  python -m multimodal_unlearning_tpu_torch.cli.inspect_runs diff a=<dir> b=<dir> [top=20]
  python -m multimodal_unlearning_tpu_torch.cli.inspect_runs gens a=<dir> b=<dir> [n=5]
  python -m multimodal_unlearning_tpu_torch.cli.inspect_runs sweep root=<models-dir>

``diff`` compares two HF-layout checkpoints tensor by tensor (largest
absolute difference, mean absolute difference relative to the first's mean
magnitude), reading one pair of tensors at a time, so that two 7B files
never sit whole in host memory; ``gens`` prints the generated texts of two
runs' ``eval_results/eval_log_aggregated.json`` side by side; ``sweep``
prints one JSON row per run under ``root`` with the hyperparameters parsed
from its directory name and its forget / retain means (the text stack's
``eval_log_forget.json`` and ``eval_log.json``).  Host only.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.train.checkpoints import load_hf_checkpoint


def diff_checkpoints(a: str, b: str, top: int = 20):
    sa, sb = load_hf_checkpoint(a), load_hf_checkpoint(b)
    rows = []
    for k in sorted(set(sa) & set(sb)):
        x = sa[k].to(torch.float32).numpy()
        y = sb[k].to(torch.float32).numpy()
        if x.shape != y.shape:
            rows.append((k, float("inf"), float("inf")))
            continue
        d = np.abs(x - y)
        denom = np.abs(x).mean() + 1e-12
        rows.append((k, float(d.max()), float(d.mean() / denom)))
        del x, y, d
    rows.sort(key=lambda r: -r[2])
    only_a, only_b = set(sa) - set(sb), set(sb) - set(sa)
    print(f"{len(rows)} shared tensors; only-in-a: {len(only_a)}, only-in-b: {len(only_b)}")
    print(f"{'tensor':70s} {'max|Δ|':>12s} {'rel mean|Δ|':>12s}")
    for k, mx, rel in rows[:top]:
        print(f"{k:70s} {mx:12.5f} {rel:12.5f}")
    unchanged = sum(1 for _, mx, _ in rows if mx == 0.0)
    print(f"unchanged tensors: {unchanged}/{len(rows)}")
    sa.close()
    sb.close()
    return rows


def compare_generations(a: str, b: str, n: int = 5):
    def load(d):
        return json.loads((Path(d) / "eval_results" / "eval_log_aggregated.json").read_text())

    la, lb = load(a), load(b)
    for task in la:
        if task not in lb or "generated_text" not in la[task]:
            continue
        print(f"\n=== {task} ===")
        shown = 0
        for idx, (q, gen_a, ans) in la[task]["generated_text"].items():
            if idx not in lb[task]["generated_text"]:
                continue
            gen_b = lb[task]["generated_text"][idx][1]
            print(f"[{idx}] Q: {q[:90]}")
            print(f"    a: {gen_a[:90]}")
            print(f"    b: {gen_b[:90]}")
            print(f"   gt: {ans[:90]}")
            shown += 1
            if shown >= n:
                break


_HP_RE = re.compile(r"L1[_]?(?P<l1>[0-9.e-]+)|L0[_]?(?P<l0>[0-9.e-]+)|beta(?P<beta>[0-9.e-]+)"
                    r"|lr(?P<lr>[0-9.e-]+)")


def sweep_summary(root: str):
    """One row per run under ``root``: the hyperparameters of its directory
    name and the means of its forget and retain logs."""
    rows = []
    for run in sorted(Path(root).glob("**/eval_results/eval_log_aggregated.json")):
        run_dir = run.parent.parent
        hp = {}
        for m in _HP_RE.finditer(run_dir.name):
            hp.update({k: v for k, v in m.groupdict().items() if v is not None})
        logs = json.loads(run.read_text())
        fl = logs.get("eval_log_forget.json", {})
        rl = logs.get("eval_log.json", {})

        def mean_of(d, key):
            vals = list(d.get(key, {}).values())
            return float(np.mean(vals)) if vals else float("nan")

        rows.append({
            "run": run_dir.name, **hp,
            "forget_avg_gt_loss": mean_of(fl, "avg_gt_loss"),
            "retain_avg_gt_loss": mean_of(rl, "avg_gt_loss"),
            "forget_rougeL": mean_of(fl, "rougeL_recall"),
            "retain_rougeL": mean_of(rl, "rougeL_recall"),
        })
    for r in rows:
        print(json.dumps(r))
    return rows


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(__doc__)
        return
    cmd, kv = args[0], dict(a.split("=", 1) for a in args[1:] if "=" in a)
    if cmd == "diff":
        diff_checkpoints(kv["a"], kv["b"], top=int(kv.get("top", 20)))
    elif cmd == "gens":
        compare_generations(kv["a"], kv["b"], n=int(kv.get("n", 5)))
    elif cmd == "sweep":
        sweep_summary(kv["root"])
    else:
        print(__doc__)


if __name__ == "__main__":
    main()
