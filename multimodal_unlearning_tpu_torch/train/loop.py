"""Host-side training loop shared by the forget (and, later, finetune) entry
points: the port's copy of ``multimodal_unlearning_tpu/train/loop.py``.

Steps per epoch and in all from the dataset's length, the batch size, the
gradient accumulation and the number of devices; logging; ``on_save``
every ``save_steps``; train-state checkpoints with a deterministic resume
(the loader's epoch restored and the batches already consumed skipped).
Each batch crosses to the device once, explicitly, array by array.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.data.loader import stack_microbatches


def compute_steps(n_samples: int, batch_size: int, grad_accum: int, num_devices: int,
                  num_epochs: float):
    denom = batch_size * grad_accum * num_devices
    steps_per_epoch = n_samples // denom
    max_steps = int(num_epochs * n_samples) // denom
    return steps_per_epoch, max_steps


def to_device(batch: dict, device) -> dict:
    """A collated batch (nested dicts of numpy arrays) on ``device``: integer
    arrays as int64 (token ids and labels index), float arrays as they are;
    host-to-card copies from pinned memory, without a host sync."""
    cuda = torch.device(device).type == "cuda"

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        if cuda:
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return {k: to_device(v, device) if isinstance(v, dict) else put(v) for k, v in batch.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(*, train_step, state, frozen, teacher_params, dataloader, device,
               grad_accum: int, max_steps: int, logging_steps: int = 10, on_save=None,
               save_steps: int | None = None, profile_dir: str | None = None,
               state_ckpt_dir: str | None = None, resume: bool = False,
               ckpt_async: bool = True, ckpt_keep: int | None = None):
    """Runs until ``max_steps``; returns (state, history).

    ``state_ckpt_dir``: train-state checkpoints (optimizer moments
    included) every ``save_steps``; ``resume=True`` restores the latest
    before training and replays the data order from there, so the resumed
    losses equal an uninterrupted run's.  ``ckpt_async`` overlaps the
    write with training; ``ckpt_keep`` keeps the newest N.  ``profile_dir``:
    a ``torch.profiler`` trace of steps 3-5 as a Chrome trace there.  The
    loss is read to the host at logging steps only."""
    from multimodal_unlearning_tpu_torch.train import checkpoints as ckpt_mod

    start_step = 0
    skip_batches = 0
    if resume and state_ckpt_dir:
        latest = ckpt_mod.latest_train_state_step(state_ckpt_dir)
        if latest is not None:
            state = ckpt_mod.restore_train_state(state_ckpt_dir, latest, state)
            start_step = latest
            # the loader shuffles per epoch from its seed: restore its epoch
            # counter and skip the batches of the partial epoch
            steps_per_pass = len(dataloader)
            if steps_per_pass and hasattr(dataloader, "epoch"):
                dataloader.epoch = start_step // steps_per_pass
                skip_batches = start_step % steps_per_pass
            print(f"Resumed train state from step {latest}")
    if len(dataloader) == 0:
        raise ValueError(
            f"Dataset yields zero batches: {len(dataloader.dataset)} samples < "
            f"global batch {dataloader.batch_size} -- shrink batch/devices or grow data")
    step_i = start_step
    history = []
    ckptr = None
    prof = None
    t0 = time.perf_counter()
    tokens_seen = 0
    while step_i < max_steps:
        for batch in dataloader:
            if skip_batches:  # consumed before the resume point
                skip_batches -= 1
                continue
            if step_i >= max_steps:
                break
            if profile_dir and step_i == 2:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
                prof = profile(activities=acts)
                prof.__enter__()
            if grad_accum > 1:
                batch = stack_microbatches(batch, grad_accum)
            for part in batch.values():
                tokens_seen += int(np.prod(part["input_ids"].shape))
            state, metrics = train_step(state, frozen, teacher_params, to_device(batch, device))
            step_i += 1
            if prof is not None and step_i == 5:
                _sync(device)
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(f"{profile_dir}/trace.json")
                prof = None
            if logging_steps and (step_i % logging_steps == 0 or step_i == 1):
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                print(f"step {step_i}/{max_steps}  loss {loss:.4f}  "
                      f"{step_i / dt:.3f} steps/s  {tokens_seen / dt:.0f} tok/s", flush=True)
                history.append({"step": step_i, "loss": loss})
            if save_steps and step_i % save_steps == 0 and step_i < max_steps:
                if on_save:
                    on_save(state, step_i)
                if state_ckpt_dir:
                    if ckptr is None:
                        ckptr = ckpt_mod.TrainStateCheckpointer(
                            state_ckpt_dir, async_save=ckpt_async, keep_last=ckpt_keep)
                    ckptr.save(step_i, state)
    if prof is not None:
        prof.__exit__(None, None, None)
    _sync(device)
    wall = time.perf_counter() - t0
    if ckptr is not None:
        ckptr.wait()  # the write in flight lands before the run returns
    if hasattr(dataloader, "wait_seconds"):
        n = max(step_i - start_step, 1)
        print(f"host time per step: {dataloader.collate_seconds / n:.4f} s making batches "
              f"(loader thread), {dataloader.wait_seconds / n:.4f} s waiting on the loader "
              f"queue; {wall / n:.4f} s of wall per step over {step_i - start_step} steps",
              flush=True)
    return state, history
