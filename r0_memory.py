#!/usr/bin/env python3
"""Peak device memory of one full-parameter forget step (``LoRA.r=0``) of
LLaVA-1.5-7B on one card, for each of {gradient accumulation 1, 4} x
{teacher bf16, int8} x {optimizer adamw, adamw_q8}.

    python3 r0_memory.py [model_family=llava] [device=cuda]

The step is built as ``cli/mm_forget.py`` builds it at ``LoRA.r=0``: the
model's own parameters trained in place with the vision tower frozen, NPO
(a teacher forward per micro-batch), remat ``save_attn``, micro-batches of 2
of the synthetic CLEAR forget split, the clip, weight decay and the decay
mask; weights from seed 42.  Each combination takes one step from a fresh
optimizer state and teacher; a combination that does not fit is reported as
out of memory.  Prints one JSON line per combination, then the card's name
and power limit.
"""

from __future__ import annotations

import copy
import gc
import json
import subprocess
import sys
from functools import partial

import torch

from multimodal_unlearning_tpu_torch.cli import common, mm_forget
from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader, MMMixedForgetDataset
from multimodal_unlearning_tpu_torch.data.loader import stack_microbatches
from multimodal_unlearning_tpu_torch.models import llava
from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.train import optim, trainer
from multimodal_unlearning_tpu_torch.train.loop import to_device

DATA = "synthetic:n_persons=20,qa_per_person=4"
GIB = 2**30


def _batch(processor, accum, device, max_length):
    ds = MMMixedForgetDataset(forget_data_path=DATA, retain_data_path=DATA,
                              retain_split="retain90+tofu", forget_split="forget10+tofu",
                              forget_loss="npo", seed=42)
    loader = DataLoader(ds, 2 * accum, partial(processor.collate_forget, max_length=max_length),
                        shuffle=True, seed=42)
    batch = next(iter(loader))
    return to_device(stack_microbatches(batch, accum) if accum > 1 else batch, device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv) -> int:
    args = dict(a.split("=", 1) for a in argv)
    family = args.pop("model_family", "llava")
    device = torch.device(args.pop("device", "cuda"))
    max_length = int(args.pop("max_length", 2048))
    if args:
        raise KeyError(f"unknown arguments {sorted(args)}")
    if device.type == "cuda":
        kernels.build()
    model_cfg = get_model_identifiers(family)
    kind, mcfg, model = common.init_or_load_params(model_cfg, None, seed=42,
                                                   dtype=torch.bfloat16, device=device)
    trainable, frozen = common.dense_trainable(model, kind, model_cfg, {})
    apply_fn = mm_forget.make_apply_fn(kind, mcfg, remat=True, remat_policy="save_attn",
                                       compute_dtype=torch.bfloat16, model=model)
    processor = common.build_processor(model_cfg)
    for accum in (1, 4):
        batch = _batch(processor, accum, device, max_length)
        for teacher_kind in ("bf16", "int8"):
            for opt in ("adamw_q8", "adamw"):
                row = dict(grad_accum=accum, teacher=teacher_kind, optimizer=opt)
                teacher = state = stepped = None
                try:
                    teacher = copy.deepcopy(model)
                    if teacher_kind == "int8":
                        teacher = common.quantize_base_params(teacher, kind, "int8")
                    tx = optim.make_optimizer(
                        opt, 1e-5, weight_decay=0.01, warmup_steps=8, total_steps=100,
                        max_grad_norm=1.0, reachable_mask=lambda p: llava.reachable_mask(p, mcfg))
                    state = trainer.create_train_state(trainable, tx)
                    step = trainer.make_train_step(apply_fn, tx, loss_type="npo",
                                                   grad_accum=accum)
                    _sync(device)
                    row["resident_gib"] = (torch.cuda.memory_allocated(device) / GIB
                                           if device.type == "cuda" else None)
                    if device.type == "cuda":
                        torch.cuda.reset_peak_memory_stats(device)
                    stepped, metrics = step(state, frozen, teacher, batch)
                    _sync(device)
                    row["loss"] = float(metrics["loss"])
                    del metrics
                    row["peak_gib"] = (torch.cuda.max_memory_allocated(device) / GIB
                                       if device.type == "cuda" else None)
                except torch.cuda.OutOfMemoryError:
                    row["peak_gib"] = "out of memory"
                finally:
                    # the stepped state holds the optimizer state too
                    del teacher, state, stepped
                    gc.collect()
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
                print(json.dumps(row), flush=True)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
