#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100) end to end.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the kernels from
   ``multimodal_unlearning_tpu_torch/ops/csrc`` with nvcc (sm_90a) and
   prints the build time.
2. Holds each kernel against its plain PyTorch version in bf16 at the
   shapes the main paths give it -- B1 (flash forward): the ViT tower,
   a left-padded causal prefill, GQA, q_offset > 0, and the forget step's
   two shapes (decoder (2, 32, 768, 128) causal, ViT (2, 16, 577, 64)); B4 (flash decode): a
   stacked [4, 8, 32, 2048, 128] cache at layer 3 with ragged validity and
   an all-invalid row; B2 and B3 (flash backward, dq and dk/dv): the forget
   step's shape (2, 32, 768, 128) causal, the same with left padding, GQA,
   q_offset > 0 with Sk > Sq, a non-causal D=64 S=577 case and a case with
   dead rows, from the same saved o and lse -- and times kernel, plain
   version and one PyTorch library call (``scaled_dot_product_attention``
   and its backward, the yardstick only).
3. Serves LLaVA-1.5-7B at full width (random weights from a seed, bf16)
   through ``cli.serve.build_engine`` + ``ServingEngine``: ten requests of
   mixed prompt lengths, two with synthetic 336x336 pixels, 32..64 new
   tokens each.  Every request must finish with its budget (or an eos), and
   a second engine on the same model with the plain attention versions must
   give the same first token and last-position prefill logits within the
   stated tolerance.  Then times a steady decode window (8 live slots) on
   both paths.
4. Takes forget steps on the same model at full width and depth through
   ``cli.mm_forget.make_apply_fn`` + ``train.trainer.make_train_step`` at the
   operating point of the port's bench (int8 decoder, W8A8 forward and int8
   dx backward, bf16 LoRA r=8, remat with ``save_attn``, AdamW, batch 2,
   sequence 768): one warm step, four timed ones.  Every loss and gradient
   norm must be finite, no step skipped, the LoRA ``b`` leaves off zero, the
   loss moving, B1/B2/B3 launched exactly as often as the step's structure
   gives, and the loss and LoRA gradients must agree with the same step on
   the plain attention versions.  Then one step under the profiler.
5. Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_unlearning_tpu_torch import bench as forget_bench
from multimodal_unlearning_tpu_torch.cli import serve
from multimodal_unlearning_tpu_torch.data import preprocess_image
from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.ops.attention import (
    flash_attention_lse, flash_bwd_dkv, flash_bwd_dq)
from multimodal_unlearning_tpu_torch.ops.decode_attention import decode_attention
from multimodal_unlearning_tpu_torch.serve import ServingEngine
from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path

# bf16 kernel vs f32 plain version: the kernel rounds p to bf16 before the
# second product and o to bf16; |o| <= max|v| ~ 4 here, a few bf16 ulps
KERNEL_TOL = 2e-2
# backward kernels vs their plain version from the same saved o and lse: both
# round p and ds to bf16 at the same place, so what differs is the f32
# summation order and the last bf16 rounding of sums over up to 768 terms:
# 1% of the largest entry of the gradient plus one bf16 ulp of the entry
BWD_REL_TOL = 1e-2
BWD_ULP = 2.0 ** -7
# forget step, kernel attention vs plain attention from the same state: the two
# attention routes differ by bf16 rounding, and W8A8 re-quantizes activations
# (forward) and gradients (int8 dx backward) that differ by that noise, so
# roundings flip; the losses are means over ~250 tokens of CE ~ 10.4
STEP_LOSS_TOL = 0.05
# per LoRA leaf, cosine between the two routes' gradients (0.997 and more
# was measured on an H100; a dropped or wrong attention gradient gives ~0)
STEP_GRAD_COS = 0.95
# last-position prefill logits, kernel path vs plain path through 32 bf16
# layers of LLaVA-1.5-7B (random weights, logits ~ N(0, 1))
LOGIT_TOL = 0.25
# a first token may differ between the two paths only where the plain
# path's logits of the two tokens lie closer than this: random weights give
# top-2 margins of 0.01-0.1 at many prompts, inside the noise of two bf16
# computations of the same function
TIE_MARGIN = 0.2
# published peaks of one H100 SXM (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time the card could take (ms) and what bounds it."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)


# ------------------------------------------------------------- phase 2
def check_b1(dev, gen):
    """B1 cases; returns (max error over cases, {case: its numbers} for the
    serving prefill and the forget step's decoder and ViT shapes)."""
    cases = [
        # name, B, Hq, Hkv, Sq, Sk, D, causal, q_offset, left pad
        ("vit", 1, 16, 16, 577, 577, 64, False, 0, 0),
        ("prefill", 1, 32, 32, 768, 768, 128, True, 0, 100),
        ("gqa", 1, 32, 8, 512, 512, 128, True, 0, 37),
        ("q_offset", 1, 32, 32, 256, 1024, 128, True, 768, 0),
        # the forget step: batch 2, no padding, decoder and ViT
        ("step", 2, 32, 32, 768, 768, 128, True, 0, 0),
        ("step_vit", 2, 16, 16, 577, 577, 64, False, 0, 0),
    ]
    worst, record = 0.0, {}
    for name, B, Hq, Hkv, Sq, Sk, D, causal, q_off, pad in cases:
        q = randn(gen, (B, Hq, Sq, D), dev)
        k = randn(gen, (B, Hkv, Sk, D), dev)
        v = randn(gen, (B, Hkv, Sk, D), dev)
        mask = torch.ones((B, Sk), dtype=torch.int32, device=dev)
        mask[:, :pad] = 0
        o, lse = flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_off)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_off,
                                             impl="plain")
        err = (o.float() - o_ref.float()).abs().max().item()
        dead = lse_ref <= -1e29
        if err > KERNEL_TOL or not torch.all(o.float()[dead.expand_as(o)] == 0):
            raise AssertionError(f"B1 {name}: max |err| {err} (tol {KERNEL_TOL}) or a "
                                 "fully-masked row not 0")
        lse_err = (lse[~dead] - lse_ref[~dead]).abs().max().item()
        if lse_err > 1e-3 or not torch.all(lse[dead] == -1e30):
            raise AssertionError(f"B1 {name}: lse max |err| {lse_err}")
        worst = max(worst, err)

        # visible (query, key) pairs: causal cut and padding, per this input
        vis = mask.bool()[:, None, :].expand(B, Sq, Sk)
        if causal:
            qi = torch.arange(Sq, device=dev)[:, None] + q_off
            vis = vis & (qi >= torch.arange(Sk, device=dev)[None, :])
        pairs = Hq * int(vis.sum().item())
        flops = 4.0 * D * pairs
        nbytes = 2 * (q.numel() + o.numel() + k.numel() + v.numel()) + 4 * (lse.numel()
                                                                          + mask.numel())
        b_ms, b_by = bound(nbytes, flops)
        ms = cuda_ms(lambda: flash_attention_lse(q, k, v, mask, causal=causal, q_offset=q_off))
        plain_ms = cuda_ms(lambda: flash_attention_lse(q, k, v, mask, causal=causal,
                                                       q_offset=q_off, impl="plain"), iters=5)
        plain_causal = causal and pad == 0 and q_off == 0 and Sq == Sk
        bool_mask = None if (pad == 0 and not causal) or plain_causal \
            else vis[:, None]  # [B, 1, Sq, Sk]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bool_mask, is_causal=plain_causal, enable_gqa=Hq != Hkv))
        print(f"B1 {name} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} causal={causal} "
              f"q_offset={q_off} pad={pad}: max|err| {err:.3e} lse {lse_err:.2e} | kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)",
              flush=True)
        if name in ("prefill", "step", "step_vit"):
            record[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                bound_by=b_by)
        del q, k, v, o, lse, o_ref, lse_ref, vis, bool_mask
    return worst, record


def check_b4(dev, gen):
    L, B, Hq, Hkv, Smax, D, layer = 4, 8, 32, 32, 2048, 128, 3
    cache = {n: randn(gen, (L, B, Hkv, Smax, D), dev) for n in ("k", "v")}
    q = randn(gen, (B, Hq, 1, D), dev)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    # ragged rows as the engine leaves them: a left-padded prompt bucket plus
    # decoded columns; row 5 is an idle slot (all invalid)
    rng = np.random.default_rng(0)
    for b in range(B):
        if b == 5:
            continue
        bucket = int(rng.integers(1, 12)) * 128
        plen = int(rng.integers(1, bucket + 1))
        valid[b, bucket - plen:bucket + int(rng.integers(0, 64))] = 1
    o = decode_attention(q, cache, layer, valid)
    torch.cuda.synchronize()
    ref = decode_attention(q, cache, layer, valid, impl="plain")
    err = (o.float() - ref.float()).abs().max().item()
    if err > KERNEL_TOL or not torch.all(o[5] == 0):
        raise AssertionError(f"B4: max |err| {err} (tol {KERNEL_TOL}) or the all-invalid "
                             "row not 0")
    n_valid = int(valid.sum().item())
    # the function needs the valid K and V columns of layer 3, q, o, valid
    nbytes = 2 * n_valid * Hkv * D * 2 + 2 * (q.numel() + o.numel()) + 4 * valid.numel()
    flops = 4.0 * D * n_valid * Hq
    b_ms, b_by = bound(nbytes, flops)
    full_ms, _ = bound(2 * 2 * B * Hkv * Smax * D, 0.0)
    ms = cuda_ms(lambda: decode_attention(q, cache, layer, valid))
    plain_ms = cuda_ms(lambda: decode_attention(q, cache, layer, valid, impl="plain"))
    kl, vl = cache["k"][layer], cache["v"][layer]
    bool_mask = valid.bool()[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kl, vl, attn_mask=bool_mask))
    print(f"B4 cache [{L},{B},{Hkv},{Smax},{D}] layer {layer}, {n_valid} valid columns of "
          f"{B * Smax}: max|err| {err:.3e} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.2f} MB; "
          f"streaming all {B * Smax} columns would be {full_ms:.4f} ms)", flush=True)
    return err, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def check_bwd(dev, gen):
    """B2 and B3 cases; returns per kernel (max error over cases, numbers of
    the forget step's case)."""
    cases = [
        # name, B, Hq, Hkv, Sq, Sk, D, causal, q_offset, left pad, dead batch row
        ("step", 2, 32, 32, 768, 768, 128, True, 0, 0, False),
        ("left_pad", 2, 32, 32, 768, 768, 128, True, 0, 100, False),
        ("gqa", 2, 32, 8, 512, 512, 128, True, 0, 37, False),
        ("q_offset", 1, 32, 32, 256, 1024, 128, True, 768, 0, False),
        ("vit", 1, 16, 16, 577, 577, 64, False, 0, 0, False),
        ("dead_rows", 2, 8, 8, 200, 200, 128, True, 0, 0, True),
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    record = {}
    for name, B, Hq, Hkv, Sq, Sk, D, causal, q_off, pad, dead_row in cases:
        q = randn(gen, (B, Hq, Sq, D), dev)
        k = randn(gen, (B, Hkv, Sk, D), dev)
        v = randn(gen, (B, Hkv, Sk, D), dev)
        # do arrives from a transpose in the model: [B, S, H, D] storage
        do = randn(gen, (B, Sq, Hq, D), dev).transpose(1, 2)
        mask = torch.ones((B, Sk), dtype=torch.int32, device=dev)
        mask[:, :pad] = 0
        if dead_row:
            mask[0] = 0  # every query of batch row 0 sees no key
        kw = dict(causal=causal, q_offset=q_off)
        o, lse = flash_attention_lse(q, k, v, mask, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_bwd_dq(q, k, v, mask, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, **kw)
        torch.cuda.synchronize()
        dq_ref = flash_bwd_dq(q, k, v, mask, do, lse, delta, impl="plain", **kw)
        dk_ref, dv_ref = flash_bwd_dkv(q, k, v, mask, do, lse, delta, impl="plain", **kw)
        errs = {}
        for gname, g, w in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            g, w = g.float(), w.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"B2/B3 {name}: {gname} not finite")
            err = (g - w).abs()
            limit = BWD_REL_TOL * w.abs().max() + BWD_ULP * w.abs()
            if torch.any(err > limit):
                raise AssertionError(
                    f"B2/B3 {name}: {gname} max |err| {err.max().item():.4e} against "
                    f"max |ref| {w.abs().max().item():.4e} (tol {BWD_REL_TOL} of it + "
                    f"{BWD_ULP} of the entry)")
            errs[gname] = err.max().item()
        dead = (lse <= -1e29).expand_as(dq)
        if dead_row and not dead.any():
            raise AssertionError(f"B2/B3 {name}: the case has no dead row")
        if not torch.all(dq.float()[dead] == 0):
            raise AssertionError(f"B2 {name}: dq of a dead row is not exactly 0")
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])

        # visible (query, key) pairs of this input
        vis = mask.bool()[:, None, :].expand(B, Sq, Sk)
        if causal:
            qi = torch.arange(Sq, device=dev)[:, None] + q_off
            vis = vis & (qi >= torch.arange(Sk, device=dev)[None, :])
        pairs = Hq * int(vis.sum().item())
        small = 4 * (lse.numel() + delta.numel() + mask.numel())
        dq_bytes = 2 * (2 * q.numel() + do.numel() + k.numel() + v.numel()) + small
        dkv_bytes = 2 * (q.numel() + do.numel() + 2 * (k.numel() + v.numel())) + small
        dq_b = bound(dq_bytes, 6.0 * D * pairs)
        dkv_b = bound(dkv_bytes, 8.0 * D * pairs)
        dq_ms = cuda_ms(lambda: flash_bwd_dq(q, k, v, mask, do, lse, delta, **kw))
        dkv_ms = cuda_ms(lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, **kw))
        dq_plain = cuda_ms(lambda: flash_bwd_dq(q, k, v, mask, do, lse, delta, impl="plain",
                                                **kw), iters=5)
        dkv_plain = cuda_ms(lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, impl="plain",
                                                  **kw), iters=5)
        # the yardstick: the backward of one scaled_dot_product_attention call,
        # which gives dq, dk and dv together
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        plain_causal = causal and pad == 0 and not dead_row and q_off == 0 and Sq == Sk
        bool_mask = None if (plain_causal or (pad == 0 and not causal and not dead_row)) \
            else vis[:, None]
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bool_mask,
                                            is_causal=plain_causal, enable_gqa=Hq != Hkv)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))
        print(f"B2/B3 {name} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} causal={causal} "
              f"q_offset={q_off} pad={pad} dead_row={dead_row}: max|err| dq "
              f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} | B2 kernel "
              f"{dq_ms:.4f} ms, plain {dq_plain:.4f} ms, bound {dq_b[0]:.4f} ms ({dq_b[1]}; "
              f"{6.0 * D * pairs / 1e9:.3f} GFLOP, {dq_bytes / 1e6:.2f} MB) | B3 kernel "
              f"{dkv_ms:.4f} ms, plain {dkv_plain:.4f} ms, bound {dkv_b[0]:.4f} ms "
              f"({dkv_b[1]}; {8.0 * D * pairs / 1e9:.3f} GFLOP, {dkv_bytes / 1e6:.2f} MB) | "
              f"sdpa backward (dq, dk and dv in one call) {lib_ms:.4f} ms", flush=True)
        if name == "step":
            record["dq"] = dict(ms=dq_ms, plain_ms=dq_plain, library_ms=lib_ms,
                                bound_ms=dq_b[0], bound_by=dq_b[1])
            record["dkv"] = dict(ms=dkv_ms, plain_ms=dkv_plain, library_ms=lib_ms,
                                 bound_ms=dkv_b[0], bound_by=dkv_b[1])
        del q, k, v, do, o, lse, delta, dq, dk, dv, dq_ref, dk_ref, dv_ref, vis, bool_mask
        del ql, kl, vl, ol
    return worst, record


# ------------------------------------------------------------- phase 3
def make_requests(processor, image_size):
    rng = np.random.default_rng(0)
    words = "the quick brown fox jumps over a lazy dog while seven wizards quietly hum".split()
    text_lens = [10, 60, 150, 300, 500, 700, 900, 1200]
    reqs = []
    for i, n in enumerate(text_lens + [20, 200]):
        image = i >= len(text_lens)
        q = " ".join(rng.choice(words, size=n))[:n] + "?"
        ids = processor._encode_expand(processor.format(q, None, image))
        pix = None
        if image:
            pix = preprocess_image(rng.random((image_size, image_size, 3), dtype=np.float32),
                                   image_size)
        reqs.append((ids, 32 + (i * 7) % 33, pix))
    return reqs


def prefill_logits_of(engine, model, impl, dtype, specs):
    """Last-position prefill logits of every request through a one-slot
    engine on ``model`` with attention ``impl`` in ``dtype`` (prefill only)."""
    logits = {}
    eng = ServingEngine(model, engine.model_cfg, engine.kind, num_slots=1,
                        max_len=engine.smax, chunk=engine.chunk, pad_token_id=engine.pad_id,
                        eos_token_id=None, cache_dtype=dtype, compute_dtype=dtype,
                        attn_impl=impl, device=engine.device,
                        on_prefill=lambda r, last: logits.__setitem__(r.uid, last.float().cpu()))
    reqs = [eng.submit(ids, 1, pixel_values=pix) for ids, _, pix in specs]
    eng.run()
    return [logits[r.uid] for r in reqs]


def run_main_path(cfg):
    prefill_logits = {}

    def keep(req, last):
        prefill_logits[req.uid] = last.float().cpu()

    engine, processor, kind, mcfg = serve.build_engine(cfg, on_prefill=keep)
    specs = make_requests(processor, mcfg.vision.image_size)
    # warm-up (CUDA lazy module loading, cuBLAS handles): one text and one
    # image request, before the counts and clocks start
    for ids, _, pix in (specs[0], specs[-2]):
        engine.submit(ids, 2, pixel_values=pix)
    engine.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    chunks0 = engine.stats()["dispatches"]
    t0 = time.perf_counter()
    reqs = [engine.submit(ids, n, pixel_values=pix) for ids, n, pix in specs]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for req, (ids, n, pix) in zip(reqs, specs):
        if not req.done or not (len(req.tokens) == n or req.finish_reason == "eos"):
            raise AssertionError(f"request {req.uid} ({len(ids)} prompt tokens) ended with "
                                 f"{len(req.tokens)}/{n} tokens ({req.finish_reason!r})")
        lg = prefill_logits[req.uid]
        if lg.shape != (mcfg.decoder.vocab_size,) or not torch.isfinite(lg).all():
            raise AssertionError(f"request {req.uid}: prefill logits not finite [V]")
    for name in ("flash_fwd", "flash_decode"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the serving path")
    expect_b1 = mcfg.decoder.num_layers * len(reqs) + mcfg.vision.num_layers * sum(
        pix is not None for _, _, pix in specs)
    if launches["flash_fwd"] != expect_b1:
        raise AssertionError(f"flash_fwd launched {launches['flash_fwd']} times, "
                             f"expected {expect_b1}")
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = [r.first_t - r.submit_t for r in reqs]
    chunks = engine.stats()["dispatches"] - chunks0
    print(f"main path: {len(reqs)} requests (prompts {[len(s[0]) for s in specs]} tokens, "
          f"{sum(p is not None for *_, p in specs)} with images), {n_tok} tokens in "
          f"{wall:.3f} s = {n_tok / wall:.2f} tok/s; {chunks} decode chunks; TTFT "
          f"min {min(ttft):.3f} s median {statistics.median(ttft):.3f} s max "
          f"{max(ttft):.3f} s; max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches}", flush=True)

    # the same prompts through the plain attention versions (bf16), and
    # through the plain versions on an f32 copy of the weights as a yardstick
    # of how far each bf16 path is from exact arithmetic
    engine._state = None  # free the kernel engine's cache first
    kern = [prefill_logits[r.uid] for r in reqs]
    plain = prefill_logits_of(engine, engine.params, "plain", engine.compute_dtype, specs)
    m32 = type(engine.params)(mcfg, device=engine.device, dtype=torch.float32)
    with torch.no_grad():
        for a, b in zip(m32.parameters(), engine.params.parameters()):
            a.copy_(b)
    exact = prefill_logits_of(engine, m32, "plain", torch.float32, specs)
    del m32
    torch.cuda.empty_cache()
    d_kp, d_kf, d_pf, near_ties = [], [], [], []
    for req, a, b, f in zip(reqs, kern, plain, exact):
        d_kp.append((a - b).abs().max().item())
        d_kf.append((a - f).abs().max().item())
        d_pf.append((b - f).abs().max().item())
        if max(d_kp[-1], d_kf[-1], d_pf[-1]) > LOGIT_TOL:
            raise AssertionError(f"request {req.uid}: prefill logits differ by "
                                 f"{d_kp[-1]:.4f} (kernel-plain), {d_kf[-1]:.4f} (kernel-f32), "
                                 f"{d_pf[-1]:.4f} (plain-f32); tol {LOGIT_TOL}")
        tk, tp = req.tokens[0], int(torch.argmax(b))
        if tk != tp:
            gap = (b[tp] - b[tk]).item()
            if gap > TIE_MARGIN:
                raise AssertionError(f"request {req.uid}: first token {tk} on the kernel path, "
                                     f"{tp} on the plain path, {gap:.4f} apart there")
            near_ties.append((req.uid, round(gap, 4)))
    margins = [(lambda t: (t[0] - t[1]).item())(torch.topk(b, 2).values) for b in plain]
    print(f"prefill logits, max|diff| per request: kernel-plain "
          f"{[round(x, 4) for x in d_kp]}, kernel-f32 {[round(x, 4) for x in d_kf]}, "
          f"plain-f32 {[round(x, 4) for x in d_pf]} (tol {LOGIT_TOL}); first tokens equal "
          f"for {len(reqs) - len(near_ties)}/{len(reqs)} requests, near-ties {near_ties} "
          f"(tie margin {TIE_MARGIN}); plain-path top-2 margins "
          f"{[round(x, 4) for x in margins]}", flush=True)
    return engine, launches, specs


def profiled(fn, ranges=()):
    """Run ``fn`` once under torch.profiler; returns (wall ms, device ms,
    device kernels, the kernels taking most device time as text) and, with
    ``ranges``, also {name: device ms of the kernels launched under the host
    ops or ``record_function`` ranges of that name, or, where no host range
    has that name, of the device kernels whose name contains it}."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activities only: a record_function range also appears on the
    # device timeline (first to last kernel under it) and would count twice
    events = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.device_time_total for e in events) / 1e3
    by_name: dict[str, list] = {}
    for e in events:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.device_time_total / 1e3
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    top_txt = "; ".join(f"{name[:70]} x{n}: {ms / dev_ms:.3f}" for name, (ms, n) in top)
    if not ranges:
        return wall_ms, dev_ms, len(events), top_txt
    by_range = {r: 0.0 for r in ranges}
    for e in prof.events():
        if e.name in by_range and str(getattr(e, "device_type", "")).endswith("CPU"):
            by_range[e.name] += e.device_time_total / 1e3
    for r in ranges:
        by_range[r] += sum(ms for name, (ms, _) in by_name.items() if r in name)
    return wall_ms, dev_ms, len(events), top_txt, by_range


def prefill_profile(engine, spec):
    """One prefill (no decode) of ``spec`` through a one-slot engine on the
    same model, under the profiler."""
    ids, _, pix = spec
    eng = ServingEngine(engine.params, engine.model_cfg, engine.kind, num_slots=1,
                        max_len=engine.smax, chunk=engine.chunk, pad_token_id=engine.pad_id,
                        eos_token_id=None, cache_dtype=engine.cache_dtype,
                        compute_dtype=engine.compute_dtype, device=engine.device)
    eng.submit(ids, 1, pixel_values=pix)
    eng.run()  # warm
    eng.submit(ids, 1, pixel_values=pix)
    wall, dev_ms, n, top = profiled(eng.run)
    print(f"prefill profile ({len(ids)} prompt tokens{', with image' if pix is not None else ''}"
          f"): {wall:.2f} ms wall under the profiler, {n} device kernels, {dev_ms:.2f} ms of "
          f"device time (busy share {dev_ms / wall:.3f}); device time by kernel: {top}",
          flush=True)


def decode_window(engine, label, profile=False):
    """Steady decode with all slots live: ms per decode step over 3 chunks,
    and (optionally) the device's busy share over one more chunk."""
    rng = np.random.default_rng(1)
    # 1 + 5 chunks of tokens: every slot stays live through the timed and
    # the profiled chunks
    budget = 1 + 5 * engine.chunk
    hi = min(engine.dec_cfg.vocab_size, 30000)  # below LLaVA's image token 32000
    reqs = [engine.submit(rng.integers(3, hi, 100).tolist(), budget)
            for _ in range(engine.B)]
    engine.step()  # prefills every slot and dispatches the first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (3 * engine.chunk)
    busy = ""
    if profile:
        wall, dev_ms, n, top = profiled(engine.step)
        busy = (f"; under the profiler one chunk took {wall:.2f} ms wall, {n} device kernels, "
                f"{dev_ms:.2f} ms of device time (busy share {dev_ms / wall:.3f} under the "
                f"profiler, {dev_ms / (step_ms * engine.chunk):.3f} of an unprofiled chunk); "
                f"device time by kernel: {top}")
    engine.run()
    for r in reqs:
        if not r.done or not (len(r.tokens) == budget or r.finish_reason == "eos"):
            raise AssertionError(f"decode window: request {r.uid} ended with "
                                 f"{len(r.tokens)}/{budget} tokens ({r.finish_reason!r})")
    print(f"decode window ({label}, {engine.B} live slots): {step_ms:.3f} ms per decode step "
          f"= {engine.B * 1e3 / step_ms:.1f} tok/s{busy}", flush=True)
    return step_ms


# ------------------------------------------------------------- phase 4
def _cos(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return (torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-30)).item()


def run_forget_path(model, timed_steps=4):
    """Forget steps on ``model`` (the served LLaVA, quantized here) through
    the port's bench set-up; returns the launch counts of the timed steps."""
    try:
        return _forget_path(model, timed_steps)
    finally:
        forget_bench.teardown()


def _forget_path(model, timed_steps):
    b = forget_bench.setup(model=model)
    dec, vis = b.mcfg.decoder, b.mcfg.vision
    B, S = b.batch["forget"]["input_ids"].shape
    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # warm step (CUDA lazy loading, cuBLASLt int8 heuristics), not counted
    b.state, m0 = b.step(b.state, b.model, None, b.batch)
    first = {k: float(v) for k, v in m0.items()}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    seen = []
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        b.state, m = b.step(b.state, b.model, None, b.batch)
        seen.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    seen = [first] + [{k: float(v) for k, v in m.items()} for m in seen]

    for i, m in enumerate(seen):
        if not all(np.isfinite(x) for x in m.values()) or m["skipped_nonfinite"]:
            raise AssertionError(f"forget step {i}: non-finite or skipped: {m}")
    if seen[0]["loss"] == seen[-1]["loss"]:
        raise AssertionError(f"the loss did not move over {len(seen)} steps (the gradients "
                             f"were dropped): {[m['loss'] for m in seen]}")
    moved = {"/".join(p): leaf.detach().float().abs().max().item()
             for p, leaf in tree_leaves_with_path(b.state.trainable) if p[-1] == "b"}
    still = [p for p, x in moved.items() if x == 0.0]
    if still:
        raise AssertionError(f"LoRA b leaves still at zero after {len(seen)} steps: {still}")
    # per step: two splits; B1 once per decoder layer and per ViT layer (the
    # remat policy save_attn keeps o and lse, so B1 does not run again in the
    # backward pass); B2 and B3 once per decoder layer (the ViT is frozen)
    expect = {"flash_fwd": timed_steps * 2 * (dec.num_layers + vis.num_layers),
              "flash_bwd_dq": timed_steps * 2 * dec.num_layers,
              "flash_bwd_dkv": timed_steps * 2 * dec.num_layers,
              "flash_decode": 0}
    if launches != expect:
        raise AssertionError(f"forget path launches {launches}, expected {expect}")
    step_ms = wall * 1e3 / timed_steps
    print(f"forget path: {forget_bench.FAMILY} {dec.num_layers}+{vis.num_layers} layers, bs {B}, seq "
          f"{S}, W8A8 + int8 dx, bf16 LoRA r8, remat save_attn, AdamW; {timed_steps} timed "
          f"steps in {wall:.3f} s = {step_ms:.1f} ms per step = {timed_steps / wall:.4f} "
          f"steps/s; losses {[round(m['loss'], 4) for m in seen]} (forget "
          f"{[round(m['forget_loss'], 4) for m in seen]}, retain "
          f"{[round(m['retain_loss'], 4) for m in seen]}), grad norms "
          f"{[round(m['grad_norm'], 4) for m in seen]}; max |b| over LoRA leaves "
          f"{max(moved.values()):.3e} (min {min(moved.values()):.3e}); weights and adapters "
          f"{weights_gib:.2f} GiB, max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches}", flush=True)

    # the same micro-batch from the same state through the plain attention
    # versions (full remat there: the plain attention keeps [B,H,S,S] tensors)
    grad_of = lambda step: step.grad_fn(b.state.trainable, b.model, None, b.batch)
    (_, mk), gk = grad_of(b.step)
    (_, mp), gp = grad_of(b.make_step(attn_impl="plain", remat_policy=None))
    torch.cuda.synchronize()
    for key in ("forget_loss", "retain_loss"):
        if abs(float(mk[key]) - float(mp[key])) > STEP_LOSS_TOL:
            raise AssertionError(f"{key}: {float(mk[key]):.4f} with the kernels, "
                                 f"{float(mp[key]):.4f} with plain attention "
                                 f"(tol {STEP_LOSS_TOL})")
    cos = {"/".join(p): _cos(g, w) for (p, g), (_, w) in
           zip(tree_leaves_with_path(gk), tree_leaves_with_path(gp))}
    num = sum((g.float() - w.float()).pow(2).sum() for (_, g), (_, w) in
              zip(tree_leaves_with_path(gk), tree_leaves_with_path(gp))).sqrt().item()
    den = sum(w.float().pow(2).sum() for _, w in tree_leaves_with_path(gp)).sqrt().item()
    worst = min(cos, key=cos.get)
    print(f"kernel vs plain attention, same state: forget loss {float(mk['forget_loss']):.4f} "
          f"vs {float(mp['forget_loss']):.4f}, retain loss {float(mk['retain_loss']):.4f} vs "
          f"{float(mp['retain_loss']):.4f} (tol {STEP_LOSS_TOL}); LoRA gradients: global "
          f"relative error {num / den:.4f}, per-leaf cosine min {cos[worst]:.4f} at {worst}, "
          f"median {statistics.median(cos.values()):.4f} (tol {STEP_GRAD_COS})", flush=True)
    if cos[worst] < STEP_GRAD_COS:
        raise AssertionError(f"LoRA gradient of {worst}: cosine {cos[worst]:.4f} between the "
                             f"kernel and the plain attention step (tol {STEP_GRAD_COS})")
    del gk, gp

    def one_step():
        b.state, _ = b.step(b.state, b.model, None, b.batch)

    names = ("aten::_int_mm", "mmu::int8_quantize", "mmu::int8_rescale",
             "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    wall_p, dev_ms, n, top, by_range = profiled(one_step, ranges=names)
    shares = ", ".join(f"{r} {ms:.1f} ms ({ms / dev_ms:.3f})" for r, ms in by_range.items())
    print(f"forget step profile: {wall_p:.1f} ms wall under the profiler, {n} device kernels, "
          f"{dev_ms:.1f} ms of device time (busy share {dev_ms / wall_p:.3f} under the "
          f"profiler, {dev_ms / step_ms:.3f} of an unprofiled step); by range: {shares}; "
          f"device time by kernel: {top}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({took})", flush=True)
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    b1_err, b1 = check_b1(dev, gen)
    b4_err, b4 = check_b4(dev, gen)
    bwd_err, bwd = check_bwd(dev, gen)
    torch.cuda.empty_cache()

    cfg = serve.load_config(["model_family=llava", "quantize_base=false", "num_slots=8",
                             "max_length=2048", "chunk=16", "dtype=bfloat16", "seed=0"])
    engine, launches, specs = run_main_path(cfg)
    prefill_profile(engine, specs[7])   # the longest text prompt
    prefill_profile(engine, specs[8])   # an image request
    kernel_step = decode_window(engine, "kernels", profile=True)
    plain = ServingEngine(engine.params, engine.model_cfg, engine.kind, num_slots=engine.B,
                          max_len=engine.smax, chunk=engine.chunk, pad_token_id=engine.pad_id,
                          eos_token_id=None, cache_dtype=engine.cache_dtype,
                          compute_dtype=engine.compute_dtype, attn_impl="plain",
                          device=engine.device)
    engine._state = None
    plain_step = decode_window(plain, "plain attention")
    print(f"decode step, kernels vs plain attention: {kernel_step:.3f} vs {plain_step:.3f} ms",
          flush=True)

    # the forget step on the served model, once the serving phases are done
    # and their caches freed
    model = engine.params
    plain._state = None
    del engine, plain
    torch.cuda.empty_cache()
    step_launches = run_forget_path(model)

    rows = [
        dict(name="flash_fwd (B1)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="multimodal_unlearning_tpu/ops/attention.py:117",
             launches=launches["flash_fwd"], max_abs_err=b1_err, **b1["prefill"],
             # the same kernel on the forget path: its launches there and its
             # numbers at that path's decoder and ViT shapes
             forget_step=dict(launches=step_launches["flash_fwd"], decoder=b1["step"],
                              vit=b1["step_vit"])),
        dict(name="flash_bwd_dq (B2)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_bwd_dq.cu",
             replaces="multimodal_unlearning_tpu/ops/attention.py:219",
             launches=step_launches["flash_bwd_dq"], max_abs_err=bwd_err["dq"], **bwd["dq"]),
        dict(name="flash_bwd_dkv (B3)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
             replaces="multimodal_unlearning_tpu/ops/attention.py:268",
             launches=step_launches["flash_bwd_dkv"], max_abs_err=bwd_err["dkv"],
             **bwd["dkv"]),
        dict(name="flash_decode (B4)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/decode_attention.py:51",
             launches=launches["flash_decode"], max_abs_err=b4_err, **b4),
    ]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
