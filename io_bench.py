#!/usr/bin/env python3
"""What a checkpoint save and a profiled window cost on the card's host.

    python3 io_bench.py

Saves: 6 GiB of bf16 tensors (48 of 128 MiB) into the temporary directory
four ways, each timed to the file's close:

- ``save_file``: each card tensor copied to the host, then
  ``safetensors.torch.save_file`` (the port's save before its own writer);
- ``_save, card``: ``train/checkpoints._save`` on the card tensors (through
  its pinned buffer);
- ``_save, host transposed``: ``_save`` on host tensors that are transposed
  views, as a merged model in HF layout hands them over (permuted on the
  card);
- and, apart: the host's transposed-to-contiguous copy alone, and a raw
  ``write`` of contiguous host bytes.

Profiles: 40,000 one-kernel launches under ``torch.profiler`` (the card's
activity alone, then with host ops): seconds in ``prof.events()``, the
profiler's own per-event processing, against reading its raw kineto events
as ``chip_smoke._device_events`` does.  Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multimodal_unlearning_tpu_torch.train import checkpoints  # noqa: E402

N, ROWS, COLS = 48, 4096, 16384  # 48 bf16 tensors of 128 MiB


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def saves(d) -> dict:
    from safetensors.torch import save_file

    g = torch.Generator(device="cuda").manual_seed(0)
    card = {f"t{i}": torch.randn(ROWS, COLS, device="cuda", generator=g, dtype=torch.bfloat16)
            for i in range(N)}
    host_t = {k: v.T.contiguous().cpu() for k, v in card.items()}  # [COLS, ROWS] on the host
    views = {k: v.T for k, v in host_t.items()}  # transposed views: [ROWS, COLS]
    nbytes = N * ROWS * COLS * 2
    torch.cuda.synchronize()
    out = {}

    def rate(name, fn):
        out[name] = round(nbytes / 1e9 / _timed(fn), 3)
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))

    rate("save_file", lambda: save_file({k: v.cpu() for k, v in card.items()},
                                        os.path.join(d, "a.safetensors")))
    rate("_save, card", lambda: checkpoints._save(card, os.path.join(d, "b.safetensors")))
    rate("_save, host transposed", lambda: checkpoints._save(views,
                                                             os.path.join(d, "c.safetensors")))
    rate("host transposed copy", lambda: [v.contiguous() for v in views.values()])

    def raw():
        with open(os.path.join(d, "d.bin"), "wb") as f:
            for v in host_t.values():
                f.write(v.view(torch.uint8).numpy().data)
    rate("raw write", raw)
    return {k + " GB/s": v for k, v in out.items()}


def profiles() -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    out = {}
    for label, acts in (("card", [ProfilerActivity.CUDA]),
                        ("card + host ops", [ProfilerActivity.CUDA, ProfilerActivity.CPU])):
        with profile(activities=acts) as prof:
            for _ in range(40_000):
                x.add_(1)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        t_raw = time.perf_counter() - t0
        t_events = _timed(prof.events)
        out[label] = {"device events": len(raw), "raw s": round(t_raw, 3),
                      "prof.events() s": round(t_events, 3)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("io_bench: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    d = tempfile.mkdtemp(prefix="io_bench_")
    try:
        res = {"card": card.strip(), "saves": saves(d), "profiles": profiles()}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
