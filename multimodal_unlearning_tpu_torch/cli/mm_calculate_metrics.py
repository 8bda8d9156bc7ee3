"""Metrics aggregation entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.mm_calculate_metrics \\
        ckpt_result=<dir>/eval_log_aggregated.json retain_result=<...> save_file=<out>

Counterpart of ``multimodal_unlearning_tpu/cli/mm_calculate_metrics.py``:
reads ``configs/mm/calculate_metrics.yaml`` with overrides, computes Model
Utility on ``ckpt_result`` and Forget Quality (KS test, JS distance) of
``ckpt_result`` against ``retain_result`` (two ``cli/mm_eval.py``
aggregates), and writes them with ``method_name`` and ``submitted_by`` to
``save_file`` as JSON.  Runs on the host (numpy and scipy).
"""

from __future__ import annotations

import json

from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir
from multimodal_unlearning_tpu_torch.evaluation import metrics


def run(cfg):
    with open(cfg.retain_result) as f:
        retain_data = json.load(f)
    with open(cfg.ckpt_result) as f:
        checkpoint_data = json.load(f)

    results = dict(
        method=cfg.method_name,
        submitted_by=cfg.submitted_by,
        **metrics.compute_model_utility(checkpoint_data),
        **metrics.evaluate_forget_quality(checkpoint_data, retain_data),
    )
    with open(cfg.save_file, "w") as f:
        json.dump(results, f, indent=4, default=float)
    print(results)
    return results


main = config_main(config_dir() / "mm", "calculate_metrics")(run)

if __name__ == "__main__":
    main()
