"""ECO prompt preparation, the port's entry point (reference:
methods/eco/prepare_eco_prompts.py + methods/eco/main.py):

    python -m multimodal_unlearning_tpu_torch.cli.eco_prepare model_path=<dir> \\
        data_path=synthetic out_dir=<dir>

Counterpart of ``multimodal_unlearning_tpu/cli/eco_prepare.py``: reads
``configs/methods/eco_llama2-7b.yaml`` with ``key=value`` overrides, loads
the model in f32 (as the JAX CLI does), builds the corrupted model from the
forget split's questions and entities (corpus detectors, or the learned ones
under ``prompt_classifier_path`` / ``token_classifier_path``), generates
answers over the forget split and writes ``eco_prompts.jsonl`` into
``out_dir``, which ``cli.nlp_forget`` reads for ``forget_loss=eco_ft``
(``eco_prompts_path``).  On the card the f32 prefill and decode steps run
the f32 instances of B1 and of the one-token decode kernel.  A llama family
only; the card is the device unless ``+device=cpu`` is given.
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.cli.nlp_finetune import text_tags
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data.nlp import resolve_text_rows
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.methods.eco import get_eco_model
from multimodal_unlearning_tpu_torch.methods.eco.prepare_prompts import prepare_eco_prompts


def run(cfg):
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    kind = common.model_kind(model_cfg)
    if kind != "llama":
        raise ValueError(f"eco_prepare: model family {cfg.model_family!r} is a {kind!r} model; "
                         "ECO's attacked model runs a llama decoder")
    _, _, model = common.init_or_load_params(model_cfg, cfg.get("model_path"),
                                             dtype=torch.float32, device=device)
    tok = common.build_processor(model_cfg, cfg).tokenizer
    forget_rows = resolve_text_rows(cfg.data_path, cfg.split)
    entities = sorted({r.get("name") for r in forget_rows if r.get("name")})
    eco = get_eco_model(
        model, tok,
        forget_prompts=[r["question"] for r in forget_rows],
        entities=entities,
        corrupt_method=cfg.get("corrupt_method", "zero_out_top_k"),
        dims=int(cfg.get("corrupt_args", {}).get("dims", 1000)),
        threshold=float(cfg.get("prompt_threshold", 0.999)),
        prompt_classifier_path=cfg.get("prompt_classifier_path"),
        token_classifier_path=cfg.get("token_classifier_path"),
    )
    rows = prepare_eco_prompts(
        eco, tok, text_tags(model_cfg), cfg.data_path, cfg.split, cfg.out_dir,
        max_new_tokens=int(cfg.get("max_new_tokens", 32)),
        batch_size=int(cfg.get("batch_size", 8)),
    )
    print(f"Wrote {len(rows)} eco prompts to {cfg.out_dir}")
    return rows


main = config_main(config_dir() / "methods", "eco_llama2-7b")(run)

if __name__ == "__main__":
    main()
