"""Text-stack (TOFU) unlearning entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.nlp_forget model_path=<dir> \\
        data_path=synthetic forget_loss=RMU ...

Counterpart of ``multimodal_unlearning_tpu/cli/nlp_forget.py``: reads
``configs/nlp/forget.yaml`` with ``key=value`` overrides and, by loss:

- builds ``TextForgetDatasetDPOQA`` triplets for ``dpo`` / ``llmu`` and
  ``TextForgetDatasetQA`` pairs otherwise (``eco_ft`` reads its prompts from
  ``eco_prompts_path``'s ``.jsonl``);
- ``idk`` runs as ONE concatenated forward of the idk and retain rows under
  ``retain_ft`` (one token mean over both);
- ``grad_proj`` / ``grad_proj_l2`` (``train/grad_proj.py``): LoRA off, SGD,
  two backward passes a step; ``grad_proj_l2`` differentiates twice, which
  the attention kernels cannot (their backward has no derivative): its
  first-order passes run on the kernels and its two Hessian-vector products
  a layer at a time on the plain attention (``forget.yaml``'s 500 tokens on
  one card);
- every other loss through ``train/trainer.py`` with the text trainer's RMU
  (one ``(1, 1, H)`` control vector) and NPO (``rmu_nlp``, ``npo_nlp``),
  L1/L0 from zero under LoRA and from the initial model without
  (``l_norm_from: auto``), train-state saves and resume;

and saves an HF-layout ``model.safetensors`` (merged in ``merge_dtype``
under LoRA; the raw adapters too under ``+save_adapters=true``).  Mesh axes
above 1 raise.  The card is the device unless ``+device=cpu`` is given.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.cli.mm_forget import SKU_LOSS_ARGS, make_apply_fn
from multimodal_unlearning_tpu_torch.cli.nlp_finetune import text_tags
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader
from multimodal_unlearning_tpu_torch.data.nlp import (
    TextForgetDatasetDPOQA, TextForgetDatasetQA, text_collator)
from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.train import grad_proj, losses as L, trainer
from multimodal_unlearning_tpu_torch.train.loop import compute_steps, to_device


def step_kwargs(cfg, use_lora: bool) -> dict:
    """``trainer.make_train_step``'s keywords for a loss that is not a
    projection: ``idk`` as ``retain_ft`` over its concatenated rows, the text
    trainer's RMU and NPO (``rmu_nlp``, ``npo_nlp``), and L1/L0 on the raw
    adapters under LoRA and on the delta from the initial model without
    (``l_norm_from: auto``)."""
    loss_name = str(cfg.forget_loss)
    l_norm_from = str(cfg.get("l_norm_from", "auto"))
    if l_norm_from == "auto":
        l_norm_from = "zero" if use_lora else "init"
    return dict(loss_type="retain_ft" if loss_name.lower() == "idk" else loss_name,
                beta=float(cfg.get("loss_beta", 1.0)),
                l1_lambda=float(cfg.get("l1_lambda", 0.0)),
                l0_lambda=float(cfg.get("l0_lambda", 0.0)), l_norm_from=l_norm_from,
                loss_args={**SKU_LOSS_ARGS, "rmu_nlp": True, "npo_nlp": True},
                dpo_fix=bool(cfg.get("dpo_fix", False)),
                grad_accum=cfg.gradient_accumulation_steps)


def run(cfg):
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    merge_dtype = common.parse_dtype(cfg.get("merge_dtype"))
    loss_name = cfg.forget_loss
    is_projection = loss_name in grad_proj.PROJECTION_METHODS
    use_lora = cfg.LoRA.r != 0 and not is_projection
    save_dir = common.start_run(cfg, device)
    if save_dir is None:
        return None

    tok = common.build_processor(model_cfg, cfg).tokenizer
    kw = dict(tokenizer=tok, tags=text_tags(model_cfg), max_length=cfg.max_length,
              split=cfg.split, seed=cfg.seed)
    if loss_name.lower() in ("dpo", "llmu"):
        dataset = TextForgetDatasetDPOQA(cfg.data_path, **kw)
    else:
        dataset = TextForgetDatasetQA(cfg.data_path, loss_type=loss_name,
                                      eco_prompts_path=cfg.get("eco_prompts_path"), **kw)
    idk_concat = loss_name.lower() == "idk"

    def collate(samples):
        batch = text_collator(samples)
        if is_projection:
            return {"forget": batch["forget"], "retain": batch["retain"]}
        if idk_concat:  # one forward of the idk and retain rows together
            return {"retain": {k: np.concatenate([batch["idk"][k], batch["retain"][k]])
                               for k in batch["idk"]}}
        return batch

    loader = PrefetchLoader(DataLoader(dataset, cfg.batch_size * cfg.gradient_accumulation_steps,
                                       collate, shuffle=True, seed=cfg.seed), depth=2)
    steps_per_epoch, max_steps = compute_steps(
        len(dataset), cfg.batch_size, cfg.gradient_accumulation_steps, 1, cfg.num_epochs)
    max_steps = max(max_steps, 1)
    print(f"max_steps: {max_steps}")

    kind, mcfg, model = common.init_or_load_params(model_cfg, cfg.get("model_path"),
                                                   seed=cfg.seed, dtype=dtype, device=device)
    needs_teacher = L.loss_needs_teacher(loss_name) and not is_projection
    flags = common.train_flags(cfg, model_cfg)
    tx = common.make_tx(cfg, kind, mcfg, steps_per_epoch, max_steps,
                        optimizer="sgd" if is_projection else None, forget_loss=loss_name)
    # the teacher is the initial model: under LoRA the frozen base itself,
    # else a copy taken before any leaf trains
    teacher = copy.deepcopy(model) if needs_teacher and not use_lora else None
    tr = common.make_trainable(model, kind, model_cfg, cfg, use_lora, device)
    if needs_teacher and use_lora:
        teacher = tr.model
    apply_fn = make_apply_fn(kind, mcfg, lora_cfg=tr.scale, compute_dtype=dtype, model=tr.model,
                             **flags)

    if is_projection:
        step_fn = grad_proj.make_grad_proj_step(
            apply_fn, tx, method=loss_name, gamma=float(cfg.get("l2_grad_gamma", 1.0)),
            # grad_proj_l2_ref=true: the reference's actual (retain-only) numerics
            ref_behavior=bool(cfg.get("grad_proj_l2_ref", False)),
            # grad_proj_l2's two Hessian-vector products run the decoder's layers
            model=tr.model, compute_dtype=dtype)
        history = projection_loop(step_fn, tr.trainable, tx, loader, device, max_steps)
        trainable = tr.trainable
    else:
        control_vec = None
        if loss_name.lower() == "rmu":
            # the text trainer's RMU: one (1, 1, H) vector for the whole batch
            control_vec = L.make_control_vec(
                torch.Generator(device=device).manual_seed(int(cfg.seed)), 1, mcfg.hidden_size)
        skw = step_kwargs(cfg, use_lora)
        step_fn = trainer.make_train_step(apply_fn, tx, combine=tr.combine, **skw)
        l_reg = skw["l1_lambda"] != 0 or skw["l0_lambda"] != 0
        state = trainer.create_train_state(tr.trainable, tx, control_vec=control_vec,
                                           keep_init=l_reg and skw["l_norm_from"] == "init")
        state, history = common.run_train_loop(
            cfg, step_fn, state, tr.frozen, teacher, loader, device, max_steps=max_steps,
            save_steps=max(1, steps_per_epoch), logging_steps=max(1, max_steps // 20),
            save_dir=save_dir)
        trainable = state.trainable
    del teacher
    common.save_final(cfg, save_dir, model_cfg, tr, trainable, merge_dtype,
                      adapter_meta={"forget_loss": str(cfg.forget_loss)})
    return history


def projection_loop(step_fn, trainable, tx, loader, device, max_steps: int) -> list:
    """The projection methods' loop: one ``grad_proj`` step a batch (the
    whole ``batch_size x gradient_accumulation_steps`` rows at once), the
    losses read and printed at logging steps."""
    opt_state = tx.init(trainable)
    history = []
    step_i = 0
    while step_i < max_steps:
        for batch in loader:
            if step_i >= max_steps:
                break
            trainable, opt_state, metrics = step_fn(trainable, opt_state, None,
                                                    to_device(batch, device))
            step_i += 1
            if step_i % max(1, max_steps // 20) == 0 or step_i == 1:
                neg, pos = float(metrics["neg_loss"]), float(metrics["pos_loss"])
                print(f"step {step_i}/{max_steps}  neg {neg:.4f}  pos {pos:.4f}", flush=True)
                history.append({"step": step_i, "neg_loss": neg, "pos_loss": pos})
    return history


main = config_main(config_dir() / "nlp", "forget")(run)

if __name__ == "__main__":
    main()
