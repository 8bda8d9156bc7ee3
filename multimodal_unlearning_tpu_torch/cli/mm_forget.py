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
frozen under ``freeze_vision_module`` -- Qwen2-VL's merger with it -- or
trained too with ``freeze_vision_module=false``; a teacher is a bf16 copy,
or int8 / int4 under ``quantize_teacher``), LoRA (``LoRA.r > 0``) over a
dense, int8 (``quantize_base=true``) or grouped-int4 (``quantize_base=int4``,
QLoRA: dx through the W4A16 product) base with ``int8_compute`` and
``int8_bwd`` (int8 bases only: on an int4 base they change nothing, as in
the JAX package), ``quantize_teacher`` and the shared teacher, ``adamw`` and
``adamw_q8``, ``remat_policy`` (``save_attn``, ``save_attn_ffn``, ``dots``,
``dots_no_batch``), ``merge_dtype``, ``save_model``, ``save_adapters``,
``save_ckpts`` and resume.  Mesh axes above 1 raise.
"""

from __future__ import annotations

import copy
from functools import partial

import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.cli.common import dense_trainable  # noqa: F401
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader, MMMixedForgetDataset
from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import VLM_KINDS, llama
from multimodal_unlearning_tpu_torch.models.params import check_tree_of
from multimodal_unlearning_tpu_torch.train import losses as L, trainer
from multimodal_unlearning_tpu_torch.train.loop import compute_steps
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


def _run(cfg):
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    merge_dtype = common.parse_dtype(cfg.get("merge_dtype"))
    l_reg = cfg.get("l1_lambda", 0) != 0 or cfg.get("l0_lambda", 0) != 0
    # LoRA gating rule (mm/forget.py:126): L1 from zero means full parameters
    use_lora = cfg.LoRA.r != 0 and (cfg.get("l_norm_from") != "zero"
                                   or cfg.get("l1_lambda", 0) == 0)
    save_dir = common.start_run(cfg, device)
    if save_dir is None:
        return None

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
                         and common.qspec(cfg.quantize_base) == common.qspec(cfg.quantize_teacher))
    teacher = None
    if needs_teacher and not share_teacher:
        # a copy of the initial model, taken before any leaf is made trainable
        teacher = copy.deepcopy(model)
        if cfg.get("quantize_teacher"):
            teacher = common.quantize_base_params(teacher, kind, cfg.quantize_teacher)

    tx = common.make_tx(cfg, kind, mcfg, steps_per_epoch, max_steps)
    tr = common.make_trainable(model, kind, model_cfg, cfg, use_lora, device)
    if use_lora and cfg.get("quantize_base"):
        if cfg.get("int8_compute"):
            llama.enable_int8_compute(True)  # W8A8 on the frozen matmuls
        if cfg.get("int8_bwd"):
            enable_int8_bwd(True)  # the dx backward as an int8 product too
    if share_teacher:
        teacher = tr.model
    apply_fn = make_apply_fn(kind, mcfg, lora_cfg=tr.scale, compute_dtype=dtype, model=tr.model,
                             **common.train_flags(cfg, model_cfg))

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
        grad_accum=cfg.gradient_accumulation_steps, combine=tr.combine)
    keep_init = l_reg and cfg.get("l_norm_from") == "init"
    state = trainer.create_train_state(tr.trainable, tx, control_vec=control_vec,
                                       keep_init=keep_init)

    def on_save(state_snapshot, step_i):
        # model-only checkpoints once per epoch, in merge_dtype like the last
        common.save_model(save_dir / f"checkpoint-{step_i}", model_cfg,
                          tr.merged(state_snapshot.trainable, merge_dtype))

    state, history = common.run_train_loop(
        cfg, step_fn, state, tr.frozen, teacher, loader, device, max_steps=max_steps,
        save_steps=max(1, steps_per_epoch), logging_steps=max(1, int(0.01 * max_steps)),
        save_dir=save_dir, on_save=on_save if cfg.get("save_ckpts") else None)
    del teacher  # a LoRA merge frees the base as it goes, the teacher sharing it with it
    common.save_final(cfg, save_dir, model_cfg, tr, state.trainable, merge_dtype,
                      adapter_meta={"forget_loss": str(cfg.forget_loss)})
    return history


main = config_main(config_dir() / "mm", "forget")(run)

if __name__ == "__main__":
    main()
