"""Helpers shared by the port's entry points: the port's copy of
``multimodal_unlearning_tpu/cli/common.py`` (model and processor
construction, checkpoint I/O, dtype and quantization options).

The mesh, tensor, expert and pipeline parallelism and the multi-host parts
wait for multi-GPU.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import torch
from torch import nn

from multimodal_unlearning_tpu_torch.config import build_model_config, model_kind, save_config
from multimodal_unlearning_tpu_torch.data import ByteTokenizer, MMProcessor
from multimodal_unlearning_tpu_torch.data.processor import format_qwen
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import (
    VLM_KINDS, convert, decoder_module, hf_bridge, vlm_module)
from multimodal_unlearning_tpu_torch.models import lora as lora_mod
from multimodal_unlearning_tpu_torch.train import checkpoints, optim
from multimodal_unlearning_tpu_torch.train.loop import train_loop
from multimodal_unlearning_tpu_torch.utils.pytree import (
    merge_trees, param_tree, partition_tree, path_predicate, print_trainable_parameters,
    tree_leaves, tree_map)
from multimodal_unlearning_tpu_torch.utils.quantize import (
    QTensor, QTensor4, is_qtensor, quantize_tree_inplace)

__all__ = ["max_grad_norm_of", "dtype_of", "parse_dtype", "model_kind", "is_vlm",
           "build_model_config", "quantize_base_params", "init_or_load_params", "save_model",
           "build_processor", "model_tree", "rank_suffix", "make_tail_padder", "pad_width",
           "qspec", "freezes_vision", "check_ported", "start_run", "attn_impl_of", "train_flags",
           "make_tx",
           "dense_trainable", "dense_model_tree", "Trainable", "make_trainable",
           "run_train_loop", "save_final"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def rank_suffix() -> str:
    """Per-rank artifact suffix: ``_rank<r>`` when ``torch.distributed`` is
    initialised with more than one rank, else ``""``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return f"_rank{dist.get_rank()}"
    return ""


def max_grad_norm_of(cfg, forget_loss: str | None = None) -> float | None:
    """HF TrainingArguments' default max_grad_norm=1.0 applies to every
    reference run; ``max_grad_norm: null`` (or 0) disables it.  The
    gradient-projection trainer never effectively clips (its projection
    overwrites the clipped gradient), so it gets None."""
    if forget_loss and str(forget_loss).startswith("grad_proj"):
        return None
    v = cfg.get("max_grad_norm", 1.0)
    return float(v) if v else None


def dtype_of(cfg) -> torch.dtype:
    """The model's dtype: ``dtype`` of the config (bfloat16 or float32)."""
    name = str(cfg.get("dtype", "bfloat16"))
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"dtype {name!r}: accepted values are bfloat16, float32")
    return DTYPES[name]


def parse_dtype(name):
    """An optional dtype key (``merge_dtype``): None stays None; a name not
    in bfloat16 / float16 / float32 raises ValueError.  Entry points call it
    when they read the config, not when the value is first needed."""
    if name is None:
        return None
    if not isinstance(name, str) or name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}: accepted values are "
                         f"{', '.join(sorted(DTYPES))} (or null)")
    return DTYPES[name]


def is_vlm(kind: str) -> bool:
    return kind in VLM_KINDS


def quantize_base_params(model: nn.Module, kind: str, spec) -> nn.Module:
    """Quantize the decoder weights per the ``quantize_base`` config value:
    true / "int8" -> per-output-channel int8 (W8A16: each layer's weight is
    dequantized as the forward reaches it; W8A8 under
    ``llama.enable_int8_compute``); "int4" or "int4:g<N>" -> grouped int4
    with groups of 128 (or N) contracting rows (W4A16: kernel B8 streams the
    packed bytes; half the int8 weight stream again).  A VLM quantizes only
    its language tower; the vision tower and projector stay float.  A model
    that is already quantized passes through untouched.

    DESTRUCTIVE: quantizes leaf by leaf in place (``quantize_tree_inplace``),
    dropping each float leaf as it goes, so the float and quantized trees
    are never alive together.  Returns ``model``."""
    if any(is_qtensor(m) for m in model.modules()):
        return model  # quantized already
    s = str(spec).strip().lower()
    bits = 4 if s.startswith("int4") else 8
    gs = int(s.split(":g", 1)[1]) if bits == 4 and ":g" in s else 128
    quantize_tree_inplace(model.language_model if is_vlm(kind) else model, bits=bits,
                          group_size=gs)
    return model


def model_tree(module: nn.Module) -> dict:
    """A model's parameters as a nested dict at the JAX tree's paths
    (int8 leaves as ``{"q", "s"}``, int4 as ``{"q4", "s"}``)."""
    if isinstance(module, QTensor):
        return {"q": module.q.detach(), "s": module.s.detach()}
    if isinstance(module, QTensor4):
        return {"q4": module.q4.detach(), "s": module.s.detach()}
    out = {n: p.detach() for n, p in module.named_parameters(recurse=False)}
    out.update({n: model_tree(c) for n, c in module.named_children()})
    return out


def _init_model(kind, mcfg, seed: int, dtype, device):
    init = vlm_module(kind).init_params if is_vlm(kind) else decoder_module(mcfg).init_params
    return init(mcfg, torch.Generator(device=device).manual_seed(int(seed)), device=device,
                dtype=dtype)


def init_or_load_params(model_cfg, model_path: str | None, seed: int = 0,
                        dtype=torch.float32, device=None):
    """(kind, mcfg, model) on ``device`` (the card unless the caller names
    another): a quantized checkpoint under ``model_path`` if there is one,
    else an HF-layout safetensors checkpoint there (three attempts), else a
    random init from ``seed``.  A checkpoint is read tensor by tensor, each
    copied once to the device in ``dtype``, and the model takes those
    tensors as its parameters: the weights are on the device once."""
    device = resolve_device(device)
    kind = model_kind(model_cfg)
    mcfg = build_model_config(model_cfg)
    if model_path and checkpoints.quantized_checkpoint_exists(model_path):
        tree, meta = checkpoints.load_quantized_checkpoint(model_path, dtype, device=device)
        model = convert.from_jax(tree, mcfg, device=device, dtype=dtype)
        print(f"Loaded quantized checkpoint ({meta.get('bits', 'int8')}) from {model_path}")
        return kind, mcfg, model
    if model_path and checkpoints.model_checkpoint_exists(model_path):
        last_err = None
        for attempt in range(3):
            try:
                sd = checkpoints.load_hf_checkpoint(model_path)
                break
            except OSError as e:  # a transient file-system error
                last_err = e
                print(f"checkpoint load attempt {attempt + 1} failed: {e}")
        else:
            raise last_err
        try:
            if kind == "llava":
                tree = hf_bridge.llava_from_hf(sd, mcfg.decoder.num_layers,
                                               mcfg.vision.num_layers, device=device, dtype=dtype)
            elif kind == "qwen2_vl":
                tree = hf_bridge.qwen2vl_from_hf(sd, mcfg.decoder.num_layers, mcfg.vision.depth,
                                                 device=device, dtype=dtype)
            elif kind == "llama":
                tree = hf_bridge.llama_from_hf(sd, mcfg.num_layers, qkv_bias=mcfg.qkv_bias,
                                               device=device, dtype=dtype)
            else:
                raise NotImplementedError(f"loading a {kind!r} checkpoint is not ported yet")
        finally:
            sd.close()
        model = convert.from_jax(tree, mcfg, device=device, dtype=dtype)
        print(f"Loaded checkpoint from {model_path}")
        return kind, mcfg, model
    model = _init_model(kind, mcfg, seed, dtype, device)
    if model_path:
        print(f"No checkpoint at {model_path}; using random init (zero-egress mode)")
    return kind, mcfg, model


def save_model(save_dir, model_cfg, params) -> None:
    """``params`` (a model, or a dense dict tree such as ``merge_model``'s)
    as ``model.safetensors`` in HF layout, plus ``config.json``."""
    kind = model_kind(model_cfg)
    mcfg = build_model_config(model_cfg)
    tree = model_tree(params) if isinstance(params, nn.Module) else params
    if kind == "llava":
        sd = hf_bridge.llava_to_hf(tree, mcfg.vision.patch_size)
    elif kind == "qwen2_vl":
        sd = hf_bridge.qwen2vl_to_hf(tree)
    elif kind == "llama":
        sd = hf_bridge.llama_to_hf(tree)
    else:
        raise NotImplementedError(f"saving a {kind!r} model is not ported yet")
    arch = model_cfg["arch"]
    checkpoints.save_hf_checkpoint(save_dir, sd, config={
        "model_family_arch": arch.to_dict() if hasattr(arch, "to_dict") else dict(arch)})


def build_processor(model_cfg, cfg=None, *, padding_side: str = "left") -> MMProcessor:
    """The byte tokenizer and the family's chat template (llava, qwen) or
    tags (text families).  Qwen2-VL's processor wraps the image span in its
    vision start and end tokens and makes patches (``vision_mode``
    "qwen2vl").  Where the JAX package would load an HF tokenizer (a
    ``processor_path`` or ``tokenizer_path`` directory holding
    ``tokenizer*`` files, or any existing ``tokenizer_path`` of a text
    family), that needs ``transformers``, which the port does not use: it
    raises.  Any other path is ignored, as there."""
    cfg = cfg or {}
    vlm = is_vlm(model_kind(model_cfg))
    tok_path = (cfg.get("processor_path") or cfg.get("tokenizer_path") if vlm
                else cfg.get("tokenizer_path"))
    if tok_path and Path(str(tok_path)).exists() and (
            not vlm or any(Path(str(tok_path)).glob("tokenizer*"))):
        raise NotImplementedError(
            f"tokenizer at {tok_path}: loading an HF tokenizer needs `transformers`, which the "
            "port does not use yet (byte tokenizer only)")
    arch = model_cfg["arch"]
    if vlm:
        vision = arch["vision"]
        tok = ByteTokenizer(vocab_size=int(arch["decoder"]["vocab_size"]),
                            image_token=arch.get("image_token", "<image>"),
                            image_token_id=int(arch["image_token_id"]))
        template = model_cfg.get("chat_template", "llava")
        if model_kind(model_cfg) == "qwen2_vl":
            mcfg = build_model_config(model_cfg)
            if template == "qwen":  # the placeholder the tokenizer reads as the image token
                template = functools.partial(format_qwen, image_token=tok.image_token)
            kw = dict(num_image_tokens=mcfg.num_image_tokens, vision_mode="qwen2vl",
                      vision_wrap=(mcfg.vision_start_token_id, mcfg.vision_end_token_id),
                      patch_size=mcfg.vision.patch_size,
                      spatial_merge_size=mcfg.vision.spatial_merge_size)
        else:
            kw = dict(num_image_tokens=(int(vision["image_size"])
                                        // int(vision["patch_size"])) ** 2)
        return MMProcessor(tok, image_size=int(vision["image_size"]), chat_template=template,
                           padding_side=padding_side, **kw)
    tok = ByteTokenizer(vocab_size=int(arch["vocab_size"]),
                        image_token_id=int(arch["vocab_size"]) - 1)
    tags = {k: model_cfg.get(k, "") for k in
            ("question_start_tag", "question_end_tag", "answer_tag")}
    return MMProcessor(tok, chat_template="__tags__", tags=tags, padding_side=padding_side,
                       image_size=32, num_image_tokens=0)


def make_tail_padder(batch_size: int):
    """Tail-batch padding shared by the eval CLIs, as the JAX package pads
    (there, to keep the set of compiled shapes small; here, so that both
    packages run the same rows and shapes).

    A short tail batch is padded (its last row repeated) up to the loader's
    batch size, or to the perturbed loader's ``batch_size // 4`` when the
    tail is at least that small.  A batch LARGER than ``batch_size`` (the
    flattened perturbed batch, ``(batch_size // 4) x num_perturbed`` rows)
    rounds up to the next multiple of the small batch.  Callers slice
    outputs back to the true row count.

    Returns ``(pad_rows, target)``: ``pad_rows(a, to)`` pads array ``a``
    (None passes through) and ``target(B)`` is the padded size for ``B``
    rows."""
    import numpy as np

    small = max(batch_size // 4, 1)

    def pad_rows(a, to):
        if a is None or len(a) == to:
            return a
        return np.concatenate([a, np.repeat(a[-1:], to - len(a), axis=0)])

    def target(B):
        if B <= small:
            return small
        if B <= batch_size:
            return batch_size
        return -(-B // small) * small

    return pad_rows, target


def pad_width(a, multiple: int, fill):
    """Pad a [B, W] array's width up to a multiple of ``multiple`` with
    ``fill`` (per-batch side inputs such as ``draft_ref``)."""
    import numpy as np

    W = a.shape[1]
    Wp = -(-W // multiple) * multiple
    if Wp == W:
        return a
    return np.concatenate([a, np.full((a.shape[0], Wp - W), fill, a.dtype)], axis=1)


# ------------------------------------------------------------------ training
# The set-up that the finetune and forget CLIs (mm and nlp) share; each CLI
# keeps its dataset, collator, loss and teacher.


def qspec(v) -> str:
    """``quantize_base`` / ``quantize_teacher``'s precision: int4 or int8."""
    return "int4" if str(v).strip().lower().startswith("int4") else "int8"


def freezes_vision(cfg) -> bool:
    return str(cfg.get("freeze_vision_module", "true")).lower() == "true"


def check_ported(cfg) -> None:
    """Training options of the JAX CLIs that the port does not have yet (a
    mesh) raise before any work is done."""
    mesh = cfg.get("mesh") or {}
    big = {k: v for k, v in mesh.items() if v is not None and int(v) > 1}
    if big:
        raise NotImplementedError(f"mesh axes above 1 ({big}) need multi-GPU, which is not "
                                  "ported yet")


def start_run(cfg, device):
    """The training CLIs' opening: unported options raise, the device is
    printed, ``save_dir`` is made and the config written there.  Returns
    ``save_dir``, or None when it exists and ``overwrite_dir`` is false."""
    check_ported(cfg)
    print(f"device: {device}")
    save_dir = Path(cfg.save_dir)
    if save_dir.exists() and not cfg.get("overwrite_dir", True):
        print("Directory already exists")
        return None
    save_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, save_dir / "config.yaml")
    return save_dir


def attn_impl_of(model_cfg) -> str:
    """The attention kernels ("auto") unless the registry's
    ``flash_attention2`` is false ("plain": the tiny test families, whose
    head dim the kernels do not take)."""
    return "auto" if str(model_cfg.get("flash_attention2", "true")) == "true" else "plain"


def train_flags(cfg, model_cfg) -> dict:
    """``make_apply_fn``'s remat, remat_policy and attn_impl: the registry's
    ``gradient_checkpointing`` (``remat`` in the config overrides it),
    ``remat_policy``, and ``attn_impl_of`` the registry."""
    remat = str(model_cfg.get("gradient_checkpointing", "false")) == "true"
    if cfg.get("remat") is not None:
        remat = bool(cfg.remat)
    return dict(remat=remat, remat_policy=cfg.get("remat_policy") or None,
                attn_impl=attn_impl_of(model_cfg))


def make_tx(cfg, kind, mcfg, steps_per_epoch: int, max_steps: int, *, optimizer=None,
            forget_loss=None):
    """The config's optimizer (``optimizer`` overrides its name), warmed up
    over one epoch.  LLaVA reads the vision tower's
    hidden_states[vision_feature_layer]: the layers above it get no
    gradients and no weight decay."""
    reach = (lambda p: vlm_module(kind).reachable_mask(p, mcfg)) if kind == "llava" else None
    return optim.make_optimizer(
        optimizer or cfg.get("optimizer", "adamw"), float(cfg.lr),
        weight_decay=float(cfg.get("weight_decay", 0.0)),
        warmup_steps=max(1, steps_per_epoch), total_steps=max_steps,
        max_grad_norm=max_grad_norm_of(cfg, forget_loss), reachable_mask=reach)


def dense_trainable(model, kind, model_cfg, cfg):
    """(trainable, frozen) for full-parameter training: the model's own
    parameters (views, no copy) at the JAX tree's paths, the vision tower
    in ``frozen`` under ``freeze_vision_module`` (``None`` slots on the
    other side), else everything trainable and ``frozen`` None.  The
    trainable leaves get ``requires_grad``."""
    tree = param_tree(model)
    if is_vlm(kind) and freezes_vision(cfg):
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


@dataclasses.dataclass
class Trainable:
    """What a training CLI trains: ``trainable`` (LoRA adapters, or the
    model's own parameters at LoRA.r=0), the ``frozen`` rest that the step
    gets beside it, ``combine`` (the LoRA step's (base, adapters) pair) and
    the adapters' ``scale``."""
    model: nn.Module
    trainable: dict
    frozen: object
    use_lora: bool
    scale: float = 0.0
    combine: object = None

    def merged(self, trainable, out_dtype=None, consume=False) -> dict:
        """The whole model with ``trainable`` in it, as a dense tree for a
        save.  LoRA with ``consume=True`` merges leaf by leaf to the host,
        freeing the base (and a teacher sharing it) as it goes."""
        if self.use_lora:
            return lora_mod.merge_model(self.model, trainable, self.scale, consume=consume,
                                        out_dtype=out_dtype)
        return dense_model_tree(trainable, self.frozen, out_dtype)


def make_trainable(model, kind, model_cfg, cfg, use_lora: bool, device) -> Trainable:
    """LoRA adapters of rank ``LoRA.r`` from the seed (projector adapters
    unless ``LoRA.projector`` is false) over the base, quantized in place
    under ``quantize_base``; or, without LoRA, the model's own parameters
    (``dense_trainable``)."""
    if not use_lora:
        trainable, frozen = dense_trainable(model, kind, model_cfg, cfg)
        print_trainable_parameters(trainable, frozen or {})
        return Trainable(model, trainable, frozen, use_lora=False)
    trainable = lora_mod.init_model_lora(
        model, cfg.LoRA.r, torch.Generator(device=device).manual_seed(int(cfg.seed)),
        projector=bool(cfg.LoRA.get("projector", True)))
    print_trainable_parameters(trainable, model)
    if cfg.get("quantize_base"):
        model = quantize_base_params(model, kind, cfg.quantize_base)
    return Trainable(model, trainable, model, use_lora=True,
                     scale=lora_mod.lora_scale(cfg.LoRA.r, cfg.LoRA.alpha),
                     combine=lambda tr, fr: (fr, tr))


def run_train_loop(cfg, step_fn, state, frozen, teacher, loader, device, *, max_steps: int,
                   save_steps: int, logging_steps: int, save_dir: Path, on_save=None):
    """``train_loop`` with the config's accumulation, train-state saves
    under ``save_dir/train_state`` (``ckpt_async``, ``ckpt_keep``,
    ``resume_from_checkpoint``) and ``profile``."""
    return train_loop(
        train_step=step_fn, state=state, frozen=frozen, teacher_params=teacher,
        dataloader=loader, device=device, grad_accum=cfg.gradient_accumulation_steps,
        max_steps=max_steps, logging_steps=logging_steps, on_save=on_save,
        save_steps=save_steps, state_ckpt_dir=str(save_dir / "train_state"),
        ckpt_async=bool(cfg.get("ckpt_async", True)),
        ckpt_keep=int(cfg.get("ckpt_keep", 0) or 0) or None,
        resume=bool(cfg.get("resume_from_checkpoint")),
        profile_dir=str(save_dir / "profile") if cfg.get("profile") else None)


def save_final(cfg, save_dir: Path, model_cfg, run: Trainable, trainable, merge_dtype,
               adapter_meta: dict | None = None) -> None:
    """The trained model merged in ``merge_dtype`` and saved in HF layout
    (unless ``save_model`` is false), and under LoRA with
    ``save_adapters`` the raw adapters beside it, for multi-LoRA serving."""
    if cfg.get("save_model", True):
        final = run.merged(trainable, merge_dtype, consume=True)
        save_model(save_dir, model_cfg, final)
        del final
        print(f"Saved model to {save_dir}")
    if run.use_lora and cfg.get("save_adapters"):
        checkpoints.save_adapter(save_dir / "adapter", trainable, run.scale, meta=adapter_meta)
        print(f"Saved raw LoRA adapter to {save_dir / 'adapter'}")
