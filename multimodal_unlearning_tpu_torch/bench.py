"""Benchmark of the port: the MM forget step on LLaVA-1.5-7B on one NVIDIA GPU.

    python -m multimodal_unlearning_tpu_torch.bench

The operating point of the JAX package's ``bench.py``: the ``llava`` preset
at full width and depth, batch 2, sequence 768 (576 image tokens + text),
W8A8 (int8-quantized frozen decoder, int8 products for the activations
forward and for the dx backward) + bf16 LoRA r=8 alpha=32 on the decoder
layers, ``grad_diff_forget_ce_retain_ce`` (two student forwards and one
backward per step), vision tower frozen, per-layer remat with ``save_attn``,
bf16 logits, AdamW lr 1e-5 wd 0.01.  Weights are random from a seed and the
batch is synthetic (numpy seed 0), so nothing is read from disk.

Prints ONE JSON line: {"metric", "value", "unit"}; the unit names the card
and its power limit.  Like the JAX package's ``bench.py`` it takes no
options; it runs on the card unless ``device=cpu`` is passed, and prints no
device metric then.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.cli.mm_forget import make_apply_fn
from multimodal_unlearning_tpu_torch.config import build_model_config, get_model_identifiers
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import llama, llava
from multimodal_unlearning_tpu_torch.models import lora as lora_mod
from multimodal_unlearning_tpu_torch.train import optim, trainer
from multimodal_unlearning_tpu_torch.utils.quantize import enable_int8_bwd, quantize_tree_inplace

LOSS_TYPE = "grad_diff_forget_ce_retain_ce"
LORA_R, LORA_ALPHA = 8, 32
FAMILY, BATCH, SEQ, STEPS = "llava", 2, 768, 8


def synthetic_batch(mcfg, B: int, S: int, dtype, device, seed: int = 0) -> dict:
    """Forget and retain splits of [B, S] tokens whose first
    ``num_image_tokens`` positions are image tokens, with pixels."""
    rng = np.random.default_rng(seed)
    n_img, img = mcfg.num_image_tokens, mcfg.vision.image_size
    if S <= n_img + 1:
        raise ValueError(f"sequence {S} leaves no text after {n_img} image tokens")

    def split():
        ids = rng.integers(10, mcfg.decoder.vocab_size - 70, (B, S))
        ids[:, :n_img] = mcfg.image_token_id
        labels = ids.copy()
        labels[:, : min(n_img + 64, S - 1)] = -100
        pix = rng.normal(size=(B, img, img, 3)).astype(np.float32)
        return {
            "input_ids": torch.from_numpy(ids).to(device),
            "attention_mask": torch.ones((B, S), dtype=torch.int32, device=device),
            "labels": torch.from_numpy(labels).to(device),
            "pixel_values": torch.from_numpy(pix).to(device=device, dtype=dtype),
        }

    return {"forget": split(), "retain": split()}


def setup(model_family: str = FAMILY, *, device=None, dtype=torch.bfloat16, seed: int = 0,
          seq_len: int = SEQ, model=None):
    """Everything one forget step needs, through the port's entry points:
    model (built here from ``seed`` unless given), int8 decoder, adapters,
    batch, optimizer, step and state; ``make_step(attn_impl, remat_policy)``
    builds the same step with other attention or remat settings.  Turns W8A8
    and the int8 dx backward on; the caller turns them off again
    (``teardown``)."""
    dev = resolve_device(device)
    mcfg = build_model_config(get_model_identifiers(model_family))
    if model is None:
        model = llava.init_params(mcfg, torch.Generator(device=dev).manual_seed(seed),
                                  device=dev, dtype=dtype)
    # int8-quantize the frozen decoder leaf by leaf (embeddings and LM head
    # included); the vision tower and the projector stay in ``dtype``
    quantize_tree_inplace(model.language_model)
    adapters = {"language_model": lora_mod.init_lora(
        model.language_model.layers, LORA_R, torch.Generator(device=dev).manual_seed(seed + 1),
        dtype=dtype)}
    llama.enable_int8_compute(True)
    enable_int8_bwd(True)
    tx = optim.make_optimizer("adamw", 1e-5, weight_decay=0.01)

    def make_step(attn_impl: str = "auto", remat_policy: str | None = "save_attn"):
        apply_fn = make_apply_fn(
            "llava", mcfg, lora_cfg=lora_mod.lora_scale(LORA_R, LORA_ALPHA),
            compute_dtype=dtype, remat=True, remat_policy=remat_policy, logits_dtype=dtype,
            attn_impl=attn_impl)
        return trainer.make_train_step(apply_fn, tx, loss_type=LOSS_TYPE,
                                       combine=lambda tr, fr: (fr, tr))

    return SimpleNamespace(
        mcfg=mcfg, model=model, adapters=adapters, optimizer=tx, step=make_step(),
        make_step=make_step,
        state=trainer.create_train_state(adapters, tx), device=dev,
        batch=synthetic_batch(mcfg, BATCH, seq_len, dtype, dev))


def teardown() -> None:
    """The int8 switches are module globals: never leak them into a later
    run in the same process."""
    llama.enable_int8_compute(False)
    enable_int8_bwd(False)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(b, n_steps: int):
    """One warm step, then ``n_steps`` timed ones.  Returns (seconds, the
    list of each timed step's metrics as floats)."""
    b.state, metrics = b.step(b.state, b.model, None, b.batch)
    float(metrics["loss"])
    _sync(b.device)
    seen = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        b.state, metrics = b.step(b.state, b.model, None, b.batch)
        seen.append(metrics)
    _sync(b.device)
    dt = time.perf_counter() - t0
    return dt, [{k: float(v) for k, v in m.items()} for m in seen]


def card_name(device) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    if set(args) - {"device"}:
        raise KeyError(f"unknown arguments {sorted(set(args) - {'device'})}")
    try:
        b = setup(device=args.get("device"))
        dt, seen = run_steps(b, STEPS)
    finally:
        teardown()
    losses = [m["loss"] for m in seen]
    if not all(np.isfinite(losses)) or any(m["skipped_nonfinite"] for m in seen):
        raise RuntimeError(f"non-finite steps: {seen}")
    if losses[0] == losses[-1]:
        raise RuntimeError(f"the loss did not move over {STEPS} steps: the gradients "
                           f"were dropped ({losses})")
    if b.device.type != "cuda":
        # a CPU run shows the control flow only: no device metric is printed
        print(json.dumps({"metric": "mm_forget_cpu_smoke_steps", "value": STEPS,
                          "unit": f"steps completed on the CPU ({FAMILY}); not a measurement"}))
        return 0
    print(json.dumps({
        "metric": "mm_forget_steps_per_sec_per_chip",
        "value": round(STEPS / dt, 4),
        "unit": (f"steps/s ({FAMILY}, bs{BATCH}, seq{SEQ}, W8A8 int8 base fwd+bwd + bf16 LoRA "
                 f"r{LORA_R}, grad_diff, remat save_attn, one {card_name(b.device)})"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
