"""MM finetune entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.mm_finetune model_family=llava \\
        data_path=synthetic split=full+tofu LoRA.r=8 ...

Counterpart of ``multimodal_unlearning_tpu/cli/mm_finetune.py``, CLEAR's
first step (finetune, then forget): reads ``configs/mm/finetune.yaml`` with
``key=value`` overrides, trains the plain CE loss (``retain_ft``) on the
mixed caption / QA dataset (``MMMixedDataset`` on ``data_path`` /
``split``, collated as the ``retain`` split), with LoRA over a bf16 or int8
(``quantize_base=true``) base, or on the model's own parameters at
``LoRA.r=0`` with the vision tower frozen, and saves an HF-layout
``model.safetensors`` (the adapters merged in ``merge_dtype``; the raw
adapters too under ``+save_adapters=true``) that ``cli/mm_forget.py
model_path=`` and ``cli/serve.py model_path=`` load.  ``optimizer``,
``remat``, ``remat_policy`` and ``resume_from_checkpoint`` work as in the
forget CLI.  The card is the device unless ``+device=cpu`` is given.
"""

from __future__ import annotations

from pathlib import Path

import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.cli.mm_forget import make_apply_fn
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader, MMMixedDataset
from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.train import trainer
from multimodal_unlearning_tpu_torch.train.loop import compute_steps


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
    dataset = MMMixedDataset(cfg.data_path, cfg.split, seed=cfg.seed)

    def collate(samples):
        return {"retain": processor.collate(samples, cfg.max_length)}

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
        device, max_steps=max_steps, save_steps=steps_per_epoch,
        logging_steps=max(1, max_steps // 20), save_dir=save_dir)
    common.save_final(cfg, save_dir, model_cfg, tr, state.trainable, merge_dtype)
    return history


main = config_main(config_dir() / "mm", "finetune")(run)

if __name__ == "__main__":
    main()
