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
from multimodal_unlearning_tpu_torch.cli.mm_forget import (
    _check_ported, dense_model_tree, dense_trainable, make_apply_fn)
from multimodal_unlearning_tpu_torch.config import main as config_main, save_config
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader, MMMixedDataset
from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import vlm_module
from multimodal_unlearning_tpu_torch.models import lora as lora_mod
from multimodal_unlearning_tpu_torch.train import optim, trainer
from multimodal_unlearning_tpu_torch.train.checkpoints import save_adapter
from multimodal_unlearning_tpu_torch.train.loop import compute_steps, train_loop
from multimodal_unlearning_tpu_torch.utils.pytree import print_trainable_parameters


def run(cfg):
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    merge_dtype = common.parse_dtype(cfg.get("merge_dtype"))
    use_lora = cfg.LoRA.r != 0
    _check_ported(cfg, use_lora, common.model_kind(model_cfg))
    print(f"device: {device}")
    save_dir = Path(cfg.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, save_dir / "config.yaml")

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
    remat = str(model_cfg.get("gradient_checkpointing", "false")) == "true"
    if cfg.get("remat") is not None:  # the config overrides the registry's flag
        remat = bool(cfg.remat)
    remat_policy = cfg.get("remat_policy") or None
    attn_impl = "auto" if str(model_cfg.get("flash_attention2", "true")) == "true" else "plain"

    # vision layers above vision_feature_layer get no gradients and no decay
    reach = (lambda p: vlm_module(kind).reachable_mask(p, mcfg)) if kind == "llava" else None
    tx = optim.make_optimizer(
        cfg.get("optimizer", "adamw"), float(cfg.lr),
        weight_decay=float(cfg.get("weight_decay", 0.0)),
        warmup_steps=max(1, steps_per_epoch), total_steps=max_steps,
        max_grad_norm=common.max_grad_norm_of(cfg), reachable_mask=reach)

    scale = lora_mod.lora_scale(cfg.LoRA.r, cfg.LoRA.alpha) if use_lora else 0.0
    combine = None
    if use_lora:
        # projector adapters are on by default; LoRA.projector=false opts out
        trainable = lora_mod.init_model_lora(
            model, cfg.LoRA.r, torch.Generator(device=device).manual_seed(int(cfg.seed)),
            projector=bool(cfg.LoRA.get("projector", True)))
        print_trainable_parameters(trainable, model)
        if cfg.get("quantize_base"):
            model = common.quantize_base_params(model, kind, cfg.quantize_base)
        frozen = model
        combine = lambda tr, fr: (fr, tr)  # noqa: E731
    else:
        trainable, frozen = dense_trainable(model, kind, model_cfg, cfg)
        print_trainable_parameters(trainable, frozen or {})
    apply_fn = make_apply_fn(kind, mcfg, lora_cfg=scale, remat=remat,
                             remat_policy=remat_policy, attn_impl=attn_impl,
                             compute_dtype=dtype, model=model)
    step_fn = trainer.make_train_step(apply_fn, tx, loss_type="retain_ft",
                                      grad_accum=cfg.gradient_accumulation_steps,
                                      combine=combine)
    state = trainer.create_train_state(trainable, tx)

    state, history = train_loop(
        train_step=step_fn, state=state, frozen=frozen, teacher_params=None,
        dataloader=loader, device=device, grad_accum=cfg.gradient_accumulation_steps,
        max_steps=max_steps, logging_steps=max(1, max_steps // 20),
        state_ckpt_dir=str(save_dir / "train_state"),
        ckpt_async=bool(cfg.get("ckpt_async", True)),
        ckpt_keep=int(cfg.get("ckpt_keep", 0) or 0) or None,
        save_steps=steps_per_epoch,
        resume=bool(cfg.get("resume_from_checkpoint")),
        profile_dir=str(save_dir / "profile") if cfg.get("profile") else None)

    if use_lora:
        # consume=True: merge one leaf at a time to the host, freeing the base
        final = lora_mod.merge_model(model, state.trainable, scale, consume=True,
                                     out_dtype=merge_dtype)
    else:
        final = dense_model_tree(state.trainable, frozen, merge_dtype)
    common.save_model(save_dir, model_cfg, final)
    del final
    if use_lora and cfg.get("save_adapters"):
        save_adapter(save_dir / "adapter", state.trainable, scale)
        print(f"Saved raw LoRA adapter to {save_dir / 'adapter'}")
    print(f"Saved model to {save_dir}")
    return history


main = config_main(config_dir() / "mm", "finetune")(run)

if __name__ == "__main__":
    main()
