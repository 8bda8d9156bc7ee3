"""Text-stack (TOFU) finetune entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.nlp_finetune data_path=synthetic ...

Counterpart of ``multimodal_unlearning_tpu/cli/nlp_finetune.py``: reads
``configs/nlp/finetune.yaml`` with ``key=value`` overrides, trains the plain
CE loss (``retain_ft``) on ``TextDatasetQA`` rows (``data_path`` /
``split``, right-padded to ``max_length``) with LoRA (``LoRA.r``, the
config's 8) over the base, or on the model's own parameters at
``LoRA.r=0``, and saves an HF-layout ``model.safetensors`` (the adapters
merged in ``merge_dtype``; the raw adapters too under
``+save_adapters=true``) that ``cli/nlp_forget.py`` and ``cli/nlp_eval.py``
load as ``model_path``.  ``optimizer``, ``remat`` and
``resume_from_checkpoint`` work as in the mm CLIs; mesh axes above 1 raise.
The card is the device unless ``+device=cpu`` is given.
"""

from __future__ import annotations

import numpy as np

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.cli.mm_forget import make_apply_fn
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader
from multimodal_unlearning_tpu_torch.data.nlp import TextDatasetQA
from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.train import trainer
from multimodal_unlearning_tpu_torch.train.loop import compute_steps


def text_tags(model_cfg) -> dict:
    """The family's prompt tags (question start / end, answer)."""
    return {k: model_cfg.get(k, "") for k in
            ("question_start_tag", "question_end_tag", "answer_tag")}


def run(cfg):
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    merge_dtype = common.parse_dtype(cfg.get("merge_dtype"))
    use_lora = cfg.LoRA.r != 0
    save_dir = common.start_run(cfg, device)
    if save_dir is None:
        return None

    processor = common.build_processor(model_cfg, cfg)
    dataset = TextDatasetQA(cfg.data_path, processor.tokenizer, text_tags(model_cfg),
                            max_length=cfg.get("max_length", 500), split=cfg.split)

    def collate(samples):
        return {"retain": {k: np.stack([s[k] for s in samples])
                           for k in ("input_ids", "labels", "attention_mask")}}

    loader = PrefetchLoader(DataLoader(dataset, cfg.batch_size * cfg.gradient_accumulation_steps,
                                       collate, shuffle=True, seed=cfg.seed), depth=2)
    steps_per_epoch, max_steps = compute_steps(
        len(dataset), cfg.batch_size, cfg.gradient_accumulation_steps, 1, cfg.num_epochs)
    max_steps = max(max_steps, 1)
    print(f"max_steps: {max_steps}")

    kind, mcfg, model = common.init_or_load_params(model_cfg, cfg.get("model_path"),
                                                   seed=cfg.seed, dtype=dtype, device=device)
    tx = common.make_tx(cfg, kind, mcfg, steps_per_epoch, max_steps)
    tr = common.make_trainable(model, kind, model_cfg, cfg, use_lora, device)
    apply_fn = make_apply_fn(kind, mcfg, lora_cfg=tr.scale, compute_dtype=dtype, model=tr.model,
                             **common.train_flags(cfg, model_cfg))
    step_fn = trainer.make_train_step(apply_fn, tx, loss_type="retain_ft",
                                      grad_accum=cfg.gradient_accumulation_steps,
                                      combine=tr.combine)
    state, history = common.run_train_loop(
        cfg, step_fn, trainer.create_train_state(tr.trainable, tx), tr.frozen, None, loader,
        device, max_steps=max_steps, save_steps=max(1, steps_per_epoch),
        logging_steps=max(1, max_steps // 20), save_dir=save_dir)
    common.save_final(cfg, save_dir, model_cfg, tr, state.trainable, merge_dtype)
    return history


main = config_main(config_dir() / "nlp", "finetune")(run)

if __name__ == "__main__":
    main()
