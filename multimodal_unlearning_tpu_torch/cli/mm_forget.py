"""MM unlearning entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.mm_forget model_family=llava \\
        forget_data_path=synthetic retain_data_path=synthetic forget_loss=npo ...

The config's own family, ``qwen-vl2-2b`` (Qwen2-VL), runs as it ships.

Counterpart of ``multimodal_unlearning_tpu/cli/mm_forget.py``: reads
``configs/mm/forget.yaml`` with ``key=value`` overrides (``--config-name``
picks another file), builds the CLEAR forget/retain dataset and its
collated loader, loads or initialises the model, takes forget steps through
``train/trainer.py`` (on the card, kernels B1-B3 in the attention), writes
train-state checkpoints (``resume_from_checkpoint=true`` resumes), and
saves the model as an HF-layout ``model.safetensors`` that ``cli/serve.py
model_path=`` serves and the JAX package loads.  The card is the device
unless ``+device=cpu`` is given.

Ported: every loss type of ``train/losses.py`` (``SKU_LOSS_ARGS``,
``dpo_fix``, RMU's control vector), L1/L0 regularization from zero or from
the initial model, full-parameter forgetting (``LoRA.r=0``, the config's
default: the model's own parameters are trained in place, the vision tower
frozen under ``freeze_vision_module``, Qwen2-VL's merger with it; a teacher
is a bf16 copy, or int8 under ``quantize_teacher``), LoRA (``LoRA.r > 0``) over a dense or int8
(``quantize_base=true``) base with ``int8_compute``, ``int8_bwd``,
``quantize_teacher`` and the shared teacher, ``adamw`` and ``adamw_q8``,
``merge_dtype``, ``save_model``, ``save_adapters``, ``save_ckpts`` and
resume.  An int4 base under LoRA, a trainable vision tower and mesh axes
above 1 raise.
"""

from __future__ import annotations

import copy
from functools import partial
from pathlib import Path

import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.config import main as config_main, save_config
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader, MMMixedForgetDataset
from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import VLM_KINDS, llama, vlm_module
from multimodal_unlearning_tpu_torch.models import lora as lora_mod
from multimodal_unlearning_tpu_torch.models.params import check_tree_of
from multimodal_unlearning_tpu_torch.train import losses as L, optim, trainer
from multimodal_unlearning_tpu_torch.train.checkpoints import save_adapter
from multimodal_unlearning_tpu_torch.train.loop import compute_steps, train_loop
from multimodal_unlearning_tpu_torch.utils.pytree import (
    merge_trees, param_tree, partition_tree, path_predicate, print_trainable_parameters,
    tree_leaves, tree_map)
from multimodal_unlearning_tpu_torch.utils.quantize import enable_int8_bwd

# SKU's loss weights (the reference's mm/forget.py)
SKU_LOSS_ARGS = {"bad_weight": 2.5, "random_weight": 1.0, "normal_weight": 0.5}


def make_apply_fn(kind, mcfg, *, lora_cfg=None, remat=False, remat_policy=None,
                  attn_impl="auto", compute_dtype=torch.bfloat16, logits_dtype=None,
                  model=None):
    """apply_fn(params, batch_part, capture_layer) -> outputs.

    ``params`` is a model (``models/llava.Llava``, ``models/qwen2_vl.QwenVL``
    or ``models/llama.Llama``),
    the tuple (model, adapters) in LoRA mode, where ``lora_cfg`` is the
    adapters' scale (alpha / r), or a dense dict tree of ``model``'s own
    parameters (full-parameter forgetting: ``merge_trees`` of the trainable
    and the frozen parts), which applies ``model``.  ``logits_dtype``
    defaults to ``compute_dtype``: every loss does its softmax and logsumexp
    math in f32 anyway (``train/losses.py:_token_nll``), so an f32 [B, S, V]
    logits buffer would only cost memory and traffic."""
    if logits_dtype is None:
        logits_dtype = compute_dtype
    vlm = kind in VLM_KINDS
    if not vlm and kind != "llama":
        raise NotImplementedError(f"model kind {kind!r} is not ported yet (llava, qwen2_vl, "
                                  "llama)")
    del mcfg  # the port's models carry their configuration

    def apply_fn(params, part, capture_layer=None):
        kw = dict(
            attention_mask=torch.as_tensor(part["attention_mask"]),
            capture_layer=capture_layer,
            remat=remat,
            remat_policy=remat_policy,
            attn_impl=attn_impl,
            compute_dtype=compute_dtype,
            logits_dtype=logits_dtype,
        )
        if isinstance(params, tuple):  # (base, adapters) LoRA mode
            base, adapters = params
            kw.update(lora=adapters, lora_scale=lora_cfg)
        elif isinstance(params, dict):  # the dense tree of ``model``
            base = check_tree_of(model, params)
        else:
            base = params
        if vlm:  # LLaVA's images [B, H, W, 3], or Qwen2-VL's patches [B, N, patch_dim]
            kw["pixel_values"] = torch.as_tensor(part["pixel_values"])
        out = base(torch.as_tensor(part["input_ids"]), **kw)
        return {"logits": out["logits"], "captured": out["captured"]}

    return apply_fn


def run(cfg):
    try:
        return _run(cfg)
    finally:
        # the int8 switches are module globals: never leak them into a later
        # run in the same process
        llama.enable_int8_compute(False)
        enable_int8_bwd(False)


def _qspec(v) -> str:
    return "int4" if str(v).strip().lower().startswith("int4") else "int8"


def _check_ported(cfg, use_lora: bool, kind: str) -> None:
    """Options of the JAX CLI that the port does not have yet raise before
    any work is done."""
    if use_lora and cfg.get("quantize_base") and _qspec(cfg.quantize_base) == "int4":
        raise NotImplementedError("quantize_base=int4 under LoRA needs int4 training "
                                  "(dx through the W4A16 product), which is not ported yet")
    if not use_lora and common.is_vlm(kind) and not freezes_vision(cfg):
        raise NotImplementedError("a trainable vision tower (LoRA.r=0 with "
                                  "freeze_vision_module=false) is not ported yet: the port's "
                                  "VLM forward runs its vision tower without gradients")
    mesh = cfg.get("mesh") or {}
    big = {k: v for k, v in mesh.items() if v is not None and int(v) > 1}
    if big:
        raise NotImplementedError(f"mesh axes above 1 ({big}) need multi-GPU, which is not "
                                  "ported yet")


def freezes_vision(cfg) -> bool:
    return str(cfg.get("freeze_vision_module", "true")).lower() == "true"


def dense_trainable(model, kind, model_cfg, cfg):
    """(trainable, frozen) for full-parameter training: the model's own
    parameters (views, no copy) at the JAX tree's paths, the vision tower
    in ``frozen`` under ``freeze_vision_module`` (``None`` slots on the
    other side), else everything trainable and ``frozen`` None.  The
    trainable leaves get ``requires_grad``."""
    tree = param_tree(model)
    if common.is_vlm(kind) and freezes_vision(cfg):
        frozen, trainable = partition_tree(
            tree, path_predicate(str(model_cfg.get("vision_module", "vision_tower"))))
    else:
        trainable, frozen = tree, None
    for p in tree_leaves(trainable):
        p.requires_grad_(True)
    return trainable, frozen


def dense_model_tree(trainable, frozen, out_dtype=None) -> dict:
    """The model's own parameters, trainable and frozen at their paths, for
    a save: detached, in ``out_dtype`` if one is set (``merge_dtype``; the
    JAX CLI saves a full-parameter run as it is)."""
    full = trainable if frozen is None else merge_trees(trainable, frozen)
    return tree_map(lambda t: t.detach() if out_dtype is None else t.detach().to(out_dtype),
                    full)


def _run(cfg):
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    merge_dtype = common.parse_dtype(cfg.get("merge_dtype"))
    l_reg = cfg.get("l1_lambda", 0) != 0 or cfg.get("l0_lambda", 0) != 0
    # LoRA gating rule (mm/forget.py:126): L1 from zero means full parameters
    use_lora = cfg.LoRA.r != 0 and (cfg.get("l_norm_from") != "zero"
                                   or cfg.get("l1_lambda", 0) == 0)
    _check_ported(cfg, use_lora, common.model_kind(model_cfg))
    print(f"device: {device}")

    save_dir = Path(cfg.save_dir)
    if save_dir.exists() and not cfg.get("overwrite_dir", True):
        print("Directory already exists")
        return
    save_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, save_dir / "config.yaml")

    processor = common.build_processor(model_cfg, cfg)
    dataset = MMMixedForgetDataset(
        forget_data_path=cfg.forget_data_path, retain_data_path=cfg.retain_data_path,
        retain_split=cfg.retain_split, forget_split=cfg.forget_split,
        forget_loss=cfg.forget_loss, seed=cfg.seed, idk_fix=bool(cfg.get("idk_fix", False)))
    collate = partial(processor.collate_forget, max_length=cfg.max_length)
    loader = PrefetchLoader(DataLoader(dataset, cfg.batch_size * cfg.gradient_accumulation_steps,
                                       collate, shuffle=True, seed=cfg.seed), depth=2)
    steps_per_epoch, max_steps = compute_steps(
        len(dataset), cfg.batch_size, cfg.gradient_accumulation_steps, 1, cfg.num_epochs)
    max_steps = max(max_steps, 1)
    print(f"max_steps: {max_steps}")

    kind, mcfg, model = common.init_or_load_params(model_cfg, cfg.get("model_path"),
                                                   seed=cfg.seed, dtype=dtype, device=device)
    # the JAX CLI also builds a teacher for L1/L0 alone, which no such loss
    # reads: the port builds one only for a loss that does
    needs_teacher = L.loss_needs_teacher(cfg.forget_loss)
    # under LoRA the base is frozen: when base and teacher want the same
    # precision, the teacher IS the quantized base (no second copy)
    share_teacher = bool(needs_teacher and use_lora and cfg.get("quantize_base")
                         and cfg.get("quantize_teacher")
                         and _qspec(cfg.quantize_base) == _qspec(cfg.quantize_teacher))
    teacher = None
    if needs_teacher and not share_teacher:
        # a copy of the initial model, taken before any leaf is made trainable
        teacher = copy.deepcopy(model)
        if cfg.get("quantize_teacher"):
            teacher = common.quantize_base_params(teacher, kind, cfg.quantize_teacher)

    remat = str(model_cfg.get("gradient_checkpointing", "false")) == "true"
    if cfg.get("remat") is not None:  # the config overrides the registry's flag
        remat = bool(cfg.remat)
    remat_policy = cfg.get("remat_policy") or None
    attn_impl = "auto" if str(model_cfg.get("flash_attention2", "true")) == "true" else "plain"

    # LLaVA reads the vision tower's hidden_states[vision_feature_layer]: the
    # layers above it get no gradients and no weight decay
    reach = (lambda p: vlm_module(kind).reachable_mask(p, mcfg)) if kind == "llava" else None
    tx = optim.make_optimizer(
        cfg.get("optimizer", "adamw"), float(cfg.lr),
        weight_decay=float(cfg.get("weight_decay", 0.0)),
        warmup_steps=max(1, steps_per_epoch), total_steps=max_steps,
        max_grad_norm=common.max_grad_norm_of(cfg), reachable_mask=reach)

    scale = lora_mod.lora_scale(cfg.LoRA.r, cfg.LoRA.alpha) if use_lora else 0.0
    combine = None
    if use_lora:
        # projector adapters are on by default (every linear but lm_head);
        # LoRA.projector=false opts out
        trainable = lora_mod.init_model_lora(
            model, cfg.LoRA.r, torch.Generator(device=device).manual_seed(int(cfg.seed)),
            projector=bool(cfg.LoRA.get("projector", True)))
        print_trainable_parameters(trainable, model)
        if cfg.get("quantize_base"):
            model = common.quantize_base_params(model, kind, cfg.quantize_base)
            if cfg.get("int8_compute"):
                llama.enable_int8_compute(True)  # W8A8 on the frozen matmuls
            if cfg.get("int8_bwd"):
                enable_int8_bwd(True)  # the dx backward as an int8 product too
        if share_teacher:
            teacher = model
        frozen = model
        combine = lambda tr, fr: (fr, tr)  # noqa: E731
    else:
        trainable, frozen = dense_trainable(model, kind, model_cfg, cfg)
        print_trainable_parameters(trainable, frozen or {})
    apply_fn = make_apply_fn(kind, mcfg, lora_cfg=scale, remat=remat,
                             remat_policy=remat_policy, attn_impl=attn_impl,
                             compute_dtype=dtype, model=model)

    control_vec = None
    if str(cfg.forget_loss).lower() == "rmu":
        dec_cfg = mcfg.decoder if common.is_vlm(kind) else mcfg
        control_vec = L.make_control_vec(
            torch.Generator(device=device).manual_seed(int(cfg.seed)), cfg.batch_size,
            dec_cfg.hidden_size)
    step_fn = trainer.make_train_step(
        apply_fn, tx, loss_type=cfg.forget_loss, beta=float(cfg.get("loss_beta", 1.0)),
        l1_lambda=float(cfg.get("l1_lambda", 0.0)), l0_lambda=float(cfg.get("l0_lambda", 0.0)),
        l_norm_from=str(cfg.get("l_norm_from", "zero")), loss_args=SKU_LOSS_ARGS,
        dpo_fix=bool(cfg.get("dpo_fix", False)),
        grad_accum=cfg.gradient_accumulation_steps, combine=combine)
    keep_init = l_reg and cfg.get("l_norm_from") == "init"
    state = trainer.create_train_state(trainable, tx, control_vec=control_vec,
                                       keep_init=keep_init)

    def snapshot(trainable_now, out_dtype=None, consume=False):
        if use_lora:
            return lora_mod.merge_model(model, trainable_now, scale, consume=consume,
                                        out_dtype=out_dtype)
        return dense_model_tree(trainable_now, frozen, out_dtype)

    def on_save(state_snapshot, step_i):
        # model-only checkpoints once per epoch, in merge_dtype like the last
        common.save_model(save_dir / f"checkpoint-{step_i}", model_cfg,
                          snapshot(state_snapshot.trainable, merge_dtype))

    state, history = train_loop(
        train_step=step_fn, state=state, frozen=frozen, teacher_params=teacher,
        dataloader=loader, device=device, grad_accum=cfg.gradient_accumulation_steps,
        max_steps=max_steps, logging_steps=max(1, int(0.01 * max_steps)),
        on_save=on_save if cfg.get("save_ckpts") else None,
        save_steps=max(1, steps_per_epoch),
        state_ckpt_dir=str(save_dir / "train_state"),
        ckpt_async=bool(cfg.get("ckpt_async", True)),
        ckpt_keep=int(cfg.get("ckpt_keep", 0) or 0) or None,
        resume=bool(cfg.get("resume_from_checkpoint")),
        profile_dir=str(save_dir / "profile") if cfg.get("profile") else None)

    if cfg.get("save_model", True):
        # LoRA: consume=True merges leaf by leaf to the host, freeing the base
        # (and the teacher sharing it) as it goes; full parameters save the
        # model's own tensors
        del teacher
        final = snapshot(state.trainable, merge_dtype, consume=True)
        common.save_model(save_dir, model_cfg, final)
        del final
        print(f"Saved model to {save_dir}")
    if use_lora and cfg.get("save_adapters"):
        # the raw adapters beside the merged model, for multi-LoRA serving
        save_adapter(save_dir / "adapter", state.trainable, scale,
                     meta={"forget_loss": str(cfg.forget_loss)})
        print(f"Saved raw LoRA adapter to {save_dir / 'adapter'}")
    return history


main = config_main(config_dir() / "mm", "forget")(run)

if __name__ == "__main__":
    main()
