"""Train ECO's learned prompt/token classifiers from an experiment corpus,
the port's counterpart of ``multimodal_unlearning_tpu/cli/eco_train_classifiers.py``
(reference analog: the hub-hosted detector models consumed by
methods/eco/classifier.py:29-104; here they are trained locally so the
attack runs on zero-egress pods).

Usage:
  python -m multimodal_unlearning_tpu_torch.cli.eco_train_classifiers \
      data_path=synthetic forget_split=forget10 retain_split=retain90 \
      out_dir=models/eco_classifiers

Host only (tiny BERTs through ``transformers`` on the CPU): it takes no
device.  Pass the two directories it prints to ``cli.eco_prepare`` as
``prompt_classifier_path`` and ``token_classifier_path``.
"""

from __future__ import annotations

from pathlib import Path

from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir
from multimodal_unlearning_tpu_torch.data.nlp import resolve_text_rows
from multimodal_unlearning_tpu_torch.methods.eco.train_classifiers import (
    evaluate_prompt_classifier,
    evaluate_token_classifier,
    train_prompt_classifier,
    train_token_classifier,
)


def _holdout(items: list, frac: float, seed: int):
    """Deterministic train/held-out split (every ceil(1/frac)-th item held
    out after a seeded shuffle)."""
    import random

    order = list(items)
    random.Random(seed).shuffle(order)
    k = max(1, int(len(order) * frac))
    return order[k:], order[:k]


def run(cfg):
    import json

    forget_rows = resolve_text_rows(cfg.data_path, cfg.get("forget_split", "forget10"))
    retain_rows = resolve_text_rows(cfg.data_path, cfg.get("retain_split", "retain90"))
    forget = [r["question"] for r in forget_rows]
    retain = [r["question"] for r in retain_rows]
    entities = sorted({r.get("name") for r in forget_rows if r.get("name")})
    seed = int(cfg.get("seed", 0))

    # hold out 20% of each class: the detectors must generalize, not memorize
    # (trained detectors need measured quality, unlike the reference's
    # implicit hub models)
    frac = float(cfg.get("holdout_frac", 0.2))
    forget_tr, forget_ho = _holdout(forget, frac, seed)
    retain_tr, retain_ho = _holdout(retain, frac, seed + 1)

    out = Path(cfg.out_dir)
    p_dir = train_prompt_classifier(
        forget_tr, retain_tr, out / "prompt_classifier",
        epochs=int(cfg.get("epochs", 400)), seed=seed,
    )
    t_dir = train_token_classifier(
        forget_tr + retain_tr, entities, out / "token_classifier",
        epochs=int(cfg.get("epochs", 400)), seed=seed,
    )
    metrics = {
        "prompt_classifier": evaluate_prompt_classifier(p_dir, forget_ho, retain_ho),
        "token_classifier": evaluate_token_classifier(t_dir, forget_ho + retain_ho, entities),
        "holdout_frac": frac,
    }
    (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
    print(f"prompt classifier: {p_dir}")
    print(f"token classifier:  {t_dir}")
    print(json.dumps(metrics, indent=2))
    return p_dir, t_dir, metrics


main = config_main(config_dir() / "methods", "eco_classifiers")(run)

if __name__ == "__main__":
    main()
