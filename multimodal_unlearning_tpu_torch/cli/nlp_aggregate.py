"""Text-stack (TOFU) aggregation entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.nlp_aggregate \\
        ckpt_result=<dir>/eval_log_aggregated.json retain_result=<...> save_file=<out.csv>

Counterpart of ``multimodal_unlearning_tpu/cli/nlp_aggregate.py``: reads
``configs/nlp/aggregate_eval_stat.yaml`` with overrides, drops
``excluded_eval_files`` from both aggregates (two ``cli/nlp_eval.py``
outputs), and writes one CSV row: ``nlp_get_model_utility``'s keys on
``ckpt_result``, then ``Forget Quality`` (KS test of the forget truth ratios
against ``retain_result``'s), ``Method`` and ``Submitted By``.  Runs on the
host (numpy and scipy).
"""

from __future__ import annotations

import csv
import json

from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir
from multimodal_unlearning_tpu_torch.evaluation import metrics


def run(cfg):
    with open(cfg.retain_result) as f:
        retain = json.load(f)
    with open(cfg.ckpt_result) as f:
        ckpt = json.load(f)
    for excluded in cfg.get("excluded_eval_files", []) or []:
        retain.pop(excluded, None)
        ckpt.pop(excluded, None)

    row = {**metrics.nlp_get_model_utility(ckpt),
           "Forget Quality": metrics.get_forget_quality(ckpt, retain)["Forget Quality"],
           "Method": cfg.method_name, "Submitted By": cfg.submitted_by}
    with open(cfg.save_file, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        w.writeheader()
        w.writerow({k: float(v) if hasattr(v, "item") else v for k, v in row.items()})
    print(row)
    return row


main = config_main(config_dir() / "nlp", "aggregate_eval_stat")(run)

if __name__ == "__main__":
    main()
