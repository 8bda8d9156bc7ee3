#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card (H100) end to end.

    python3 chip_smoke.py [--kernels-only | --qwen-only | --nlp-only | --methods-only]

(``--kernels-only`` stops after phase 2 and prints its numbers instead of
a result line; ``--qwen-only`` runs phases 1, 2 and 8 (8g-8i included),
``--nlp-only`` phase 1, phase 2's text-stack cases and phase 9 (9c's
grad_proj_l2 at 500 tokens included), ``--methods-only`` phase 1, phase
2's f32 cases and phase 10 on a random Llama-2-7B in place of 9a's
checkpoint, and print theirs.)

1. Prints the card's name and power limit, builds the kernels from
   ``multimodal_unlearning_tpu_torch/ops/csrc`` with nvcc (sm_90a) and
   prints the build time.
2. Holds each kernel against its plain PyTorch version in bf16 at the
   shapes the main paths give it -- B4q (int8 flash decode) on the int8
   cache [32, 8, 32, 2048, 128]; B5 and B5q (verify chunk, bf16 and int8
   cache) at the verify round (B 8, C 5), a chunked-prefill pass (B 1, C 512
   over a 1,536-column slab view), GQA and phase 7b's verify round (B 8, C 5
   over the engine's 4,480-column slot view at offsets 128..427);
   B1 (flash forward): the ViT tower,
   a left-padded causal prefill, GQA, q_offset > 0, and the forget step's
   two shapes (decoder (2, 32, 768, 128) causal, ViT (2, 16, 577, 64)); B4 (flash decode): a
   stacked [4, 8, 32, 2048, 128] cache at layer 3 with ragged validity and
   an all-invalid row; B2 and B3 (flash backward, dq and dk/dv): the forget
   step's shape (2, 32, 768, 128) causal, the same with left padding, GQA,
   q_offset > 0 with Sk > Sq, a non-causal D=64 S=577 case and a case with
   dead rows, from the same saved o and lse; B6 and B6q (paged decode)
   through the block table of a 4-layer pool at layer 3, 8 rows, pages of 128
   and of 16 columns assigned by a random permutation, ragged rows, a gap
   page and an idle row; B7 and B7q (paged verify chunk) at the verify round,
   a chunked-prefill pass (C 512 behind 1,024 columns), GQA, chunks that
   straddle a page boundary and the verify round on pages of 16, each pool
   holding a dense cache's columns, on which the paged kernels must give the
   dense kernels' output bit for bit; B8 (grouped-int4 W4A16 matmul) at
   LLaVA-1.5-7B's q/k/v/o, gate/up, down and lm_head products at M = 8, 40,
   512 and 1024, groups of 64 and a ragged N, within 1e-2 of the largest
   plain output -- and times kernel, plain version,
   (paged) the dense kernel on the same columns, and one PyTorch library call
   (``scaled_dot_product_attention`` and its backward, on the gathered bf16
   view for the paged kernels; ``torch._weight_int4pack_mm`` for B8; the
   yardstick only), all by device time from the profiler on inputs cycled
   past the L2 (copies, or the cache's layers), with the CUDA-event time of
   back-to-back calls on one input (the older method) beside the kernel's.
   B8 also: the bound by bytes and by operations at every case, the port's
   own route above 1024 rows (per-weight dequant + ``torch.matmul``,
   dequant included) at M 40, 512 and 1024, and its host time per call at
   M 8.  The one-token decode kernels print their split plan.  Then every
   kernel at phase 8's Qwen shapes (``check_qwen``): B1 at head dim 80,
   (8, 16, 576, 80) without a mask and (8 x 9, 16, 64, 80) with ragged
   window padding; B4, B4q, B6, B6q at B 8, 12 q-heads on 2 kv-heads (GQA
   group 6), D 128; B5, B5q, B7, B7q at the verify round at group 6; B2 and
   B3 at (2, 12/2, 512, 128) causal with left padding, and at head dim 80
   for the trainable towers: Qwen2-VL-2B's (2, 16, 576, 80) without a mask
   and Qwen2.5-VL-3B's windows (2 x 9, 16, 64, 80) with ragged right
   padding, each against its plain version within ``BWD_REL_TOL`` and timed
   beside its bound, the plain version and SDPA's whole backward.  Then B1, B2 and B3
   at phase 9's shapes (``check_nlp``): Llama-2-7B's training batch
   (4, 32, 500, 128), causal and right-padded with rows of 200-500 tokens
   (500 is no multiple of a tile: a partial last tile under the causal
   cut), and B1 at its teacher-forced eval batch (8, 32, 1024, 128).
   Then the f32 instances of B1 and of the one-token decode kernel at
   phase 10b's shapes (``check_f32``): ECO's prefill (8, 32, 128, 128)
   causal with left-padded rows, and a decode step against an f32 cache
   [4, 8, 32, 160, 128] with the mask narrowed to the 145 columns written,
   each against its plain version in f32 within ``F32_TOL`` and timed
   beside its bound (f32 operations at the CUDA cores' 67 TFLOP/s), the
   plain version and SDPA in f32.
3. Serves LLaVA-1.5-7B at full width with its decoder cut to
   ``LLAVA_SERVE_DEPTH`` (16) of its 32 layers (random weights from a seed, bf16)
   through ``cli.serve.build_engine`` + ``ServingEngine``: ten requests of
   mixed prompt lengths, two with synthetic 336x336 pixels, 32..64 new
   tokens each.  Every request must finish with its budget (or an eos), and
   a second engine on the same model with the plain attention versions must
   give the same first token and last-position prefill logits within the
   stated tolerance.  Then times a steady decode window (8 live slots) on
   both paths.
   3b. The same model and requests with speculation (K 4, drafts on half
   the requests), chunked prefill (512) and a registered system prompt
   (text requests behind it on every other request, the others whole and
   chunked): streams held against the full prompts through the plain engine
   up to any first difference, which must sit at a near-tie of the
   reference; B1 and B5 launches asserted.
   3c. The serve config as it ships: ``quantize_base=true`` (int8 decoder,
   W8A16, quantized in place) with ``kv_cache_dtype=int8``; B4q launches
   asserted, prefill logits against the bf16 run printed; then speculation
   on the same quantized model, held against the plain int8 run by the same
   rule, B5q launches asserted.  Decode windows of each configuration.
   3f. (run before 3c, on a second init of the bf16 model from the same
   seed, the bf16 model parked on the host) ``quantize_base=int4``: grouped
   int4 (W4A16) through kernel B8, (i) with the bf16 cache, B8 launches
   asserted (one per product) and the dequant path taken only for the
   1,280-row prompt bucket (rows above 1024), its streams held against the
   same model on B8's plain
   version by the first-difference rule, prefill logits against the bf16
   run printed, a decode window under the profiler with B8's share; (ii)
   with speculation (K 4) and chunked prefill (512): B8 runs at M = 40 and
   512, streams held against (i).
   3d. The bf16 model on a paged cache (pages of 128 columns): (i) plain
   decode on a 25-page pool with budgets 96 tokens longer, so that admission
   queues and a slot is preempted (asserted), its streams' first tokens held
   against the dense bf16 run's by the first-difference rule; (ii) paged60
   (the pool at 60% of the dense layout) with speculation, chunked prefill
   and the system prompt, held against the dense speculative run.  B6 (i)
   and B7 (ii) launch, B4 and B5 never; pool peak, preemptions and peak
   memory printed; a decode window of each under the profiler.
   3e. The quantized model with the int8 cache on a paged60 pool, plain and
   speculative, held against the dense int8 runs; B6q and B7q launch, B4q
   and B5q never.
4. Takes forget steps on LLaVA-1.5-7B at full width and depth (a model of
   its own from seed 0, int8-quantized by the bench's set-up) through
   ``cli.mm_forget.make_apply_fn`` + ``train.trainer.make_train_step`` at the
   operating point of the port's bench (int8 decoder, W8A8 forward and int8
   dx backward, bf16 LoRA r=8, remat with ``save_attn``, AdamW, batch 2,
   sequence 768): one warm step, four timed ones.  Every loss and gradient
   norm must be finite, no step skipped, the LoRA ``b`` leaves off zero, the
   loss moving, B1/B2/B3 launched exactly as often as the step's structure
   gives, and the loss and LoRA gradients must agree with the same step on
   the plain attention versions.  4b: the same micro-batch under
   ``remat_policy`` null, ``dots`` and ``dots_no_batch``: each dots policy's
   loss and LoRA gradients held against null's (``STEP_LOSS_TOL``,
   ``STEP_GRAD_COS``), each policy's peak and ms printed.  Then one step
   under the profiler.
Phases 5-7 run LLaVA-1.5-7B at full width with its decoder cut to
``LLAVA_CLI_DEPTH`` (8) of its 32 layers, so that the script with phases 8
and 9 (each at full depth) stays within its time limit.
5. Frees that model and runs the forget CLI as a user runs it:
   ``cli.mm_forget.main`` on ``configs/mm/forget.yaml`` with ``FORGET_CLI_ARGS``
   (LLaVA-1.5-7B at full width from seed 42, synthetic CLEAR data:
   16 forget rows, 8 with a 336-px image; phase 4's operating point; 2
   accumulated micro-batches of 2; 6 steps, a train-state save at step 4;
   the merged model saved in bf16 to a temporary directory, removed after).
   Every logged loss finite and moving, B1/B2/B3 launched exactly as the
   steps' structure gives, ``model.safetensors`` holding exactly
   ``llava_to_hf``'s names in bf16; then ``cli.serve.build_engine`` with
   ``model_path`` loads it, holding no more on the card during the load
   than the file's size and half a GiB (one copy of the weights), and
   serves four of phase 3's requests to their budgets, B1 and B4
   launching, prefill logits within the tolerance of the same engine's
   plain attention.  Prints the merge, save and load seconds and GB/s, the
   free disk, the peak memory (the CLI's, the host's, the load's) and
   whether the native host library is live (the CLI prints its steps/s,
   tok/s and host time per step).
6. CLEAR's recipe through the CLIs, LLaVA-1.5-7B at full width from
   seed 42, synthetic CLEAR data (``RECIPE_DATA``): 6a ``cli.mm_finetune.main``
   (``FINETUNE_CLI_ARGS``: LoRA r 8 over the bf16 base, 3 steps, merged and saved
   in bf16 to a temporary directory); 6b ``cli.mm_forget.main`` on that
   checkpoint (``R0_FORGET_CLI_ARGS``: ``LoRA.r=0`` with the vision tower frozen,
   NPO, ``adamw_q8``, a bf16 teacher, 3 steps, no save); 6c on the student,
   teacher and state 6b leaves: NPO's first batch on the kernels and on plain
   attention (loss within 0.05, cosine >= 0.95 on every gradient leaf),
   ``adamw_q8``'s update and the teacher's forward timed alone, then one step
   each of scrub, KL, llmu, rmu, dpo, sku, idk and eco_ft with their own splits
   and of grad_ascent with L1 from the initial model under plain AdamW.  Every
   loss and gradient norm finite, no step skipped, NPO's loss moving, the
   trainable leaves moved and the vision tower equal bit for bit to the loaded
   one, B1/B2/B3 launched exactly as each loss's splits give, peak memory under
   ``PEAK_BOUND_GIB`` (each reading at ``LLAVA_CLI_DEPTH`` layers with ~15%
   room) and printed; steps/s and tok/s per CLI step, ms and launches per loss.
   6d ``cli.mm_finetune.main`` from 6a's checkpoint at ``LoRA.r=0`` with
   ``freeze_vision_module=false`` (two steps: the warmup's first runs at lr
   0): the ViT trains at D 64 (``_tower_cli_run``: its leaves move, the
   block above ``vision_feature_layer`` and ``post_ln`` stay bit for bit --
   no gradient, no decay --, B2/B3 at D 64 once per reached block and
   backward pass, the kernel route's gradient against plain attention's on
   every leaf, the peak printed).
7. CLEAR's evaluation of phase 6a's checkpoint through the CLIs (kept until
   this phase ends): 7a ``cli.mm_eval.main`` on ``configs/mm/eval.yaml`` as
   it ships (bf16, the plain ``greedy_generate`` route, 300 new tokens, batch
   8) with ``EVAL_CLI_ARGS`` (the family, ``synthetic:`` data for all six
   tasks and ``ds_size`` 8: one batch of 8 rows a task); 7b the same with
   ``engine_generate=true speculative_k=4`` (the serving engine, drafts from
   the ground-truth answers); 7c ``cli.mm_calculate_metrics.main`` on 7a's
   aggregate as the checkpoint and 7b's as retain; 7d the first task again
   with ``speculative_k=4`` on ``greedy_generate``'s own speculative route.
   Each task's JSON holds the JAX schema's keys, one entry per row, finite
   numbers; 7a's and 7b's teacher-forced numbers equal (``EVAL_TF_TOL``);
   7b's and 7d's streams equal 7a's up to a first difference at a near-tie;
   every token of every stream of 7a, 7b and 7d is the argmax of a
   teacher-forced forward over its prompt and the stream before it, or
   within ``TIE_MARGIN`` of it; B1, B4 (7a) and B1, B5 (7b, 7d) launched
   exactly as the structure gives; 7c's keys those of the JAX CLI, all
   finite.  Prints seconds per task (teacher-forced and generation),
   generated tok/s, ms per decode step (per verify round in 7b and 7d),
   tokens per verify round and peak memory.
8. Qwen2-VL, the family every shipped mm config names (``run_qwen_path``):
   8a ``cli.mm_finetune.main`` on ``configs/mm/finetune.yaml`` as it ships
   (qwen-vl2-2b at full width and depth, from seed 42, bf16, LoRA r 8 with
   the merger's adapters, batch 4, accumulation 2; ``QWEN_DATA``, 3 steps,
   merged save); 8b ``cli.mm_forget.main`` on ``configs/mm/forget.yaml`` as
   it ships from 8a's checkpoint (``LoRA.r=0``, batch 2, accumulation 4,
   grad_diff_forget_ce_retain_ce, AdamW at lr 1e-5; 3 steps, saved), its
   peak device memory printed; 8c ``cli.mm_eval.main`` on
   ``configs/mm/eval.yaml`` with 8b's checkpoint (``ds_size`` 8) and
   ``cli.mm_calculate_metrics.main``, every stream held against
   teacher-forced forwards; 8d ``cli.serve.main`` on ``configs/mm/serve.yaml``
   as it ships (the int8 W8A16 decoder) with ``model_path`` at 8b's
   checkpoint, six requests (three with a 200x300 image) to 160 tokens,
   held against teacher-forced forwards; then on the same model the int8
   cache dense (B4q), paged on a 17-page pool (B6q; a preemption asserted)
   and paged with speculation (B7q), held against the dense run up to
   near-ties; 8g ``cli.mm_forget.main`` on forget.yaml as it ships from
   8a's checkpoint with ``freeze_vision_module=false``, three steps: the
   tower trains, B2/B3 at D 80 (``_tower_cli_run``'s checks); 8h the same
   with ``LoRA.r=8 quantize_base=int4`` (QLoRA over grouped int4): the first
   batch's loss and adapter gradients against the same over the base's
   dequantized bf16 copy (``STEP_LOSS_TOL``, cosine ``QLORA_GRAD_COS``),
   three steps, the rows and route (B8 or the dequant) of every int4 product
   printed, the merge saved in bf16, reloaded by ``build_engine`` and four
   tokens served; 8e Qwen2.5-VL-3B (qwen-vl-3b, the windowed tower) from its
   seed in bf16: prefill logits against plain attention and four image
   requests served, streams held against teacher-forced forwards; 8f (after
   8d, on its model) the rest of ``serve.yaml``: 8b's checkpoint quantized
   by ``cli.quantize_model.main``, adapters "ft" (8a's) and "rnd" (random, r
   8) served by ``cli.serve.main`` with ``logprobs=true`` to six requests on
   the base, "ft" and "rnd" -- (a) each stream equal, up to a first near-tie,
   to its stream from an engine holding only its adapter, each adapter
   changing some stream; (b) every token and logprob held against a
   teacher-forced forward with its adapter; (c) the same mix on an int8
   cache with a system prompt registered per adapter, dense (B4q, B5q),
   paged (B6q, B7q) and paged with K 4 (B7q); (d) sampled (temperature 0.7,
   top-k 50, top-p 0.9) in two submission orders and through
   ``greedy_generate(do_sample=True)``, every token held against the
   sampler's own noise on teacher-forced logits -- then a decode step's
   kernels and device ms with 0, 1 and 2 adapters live and sampled.  Every
   run's launches asserted from its structure (training steps and
   micro-batches, teacher-forced forwards, the engine's prompt, image,
   decode and chunk forwards).  8i (last) one ``cli.mm_finetune.main`` run of
   qwen-vl-3b at ``LoRA.r=0`` with ``freeze_vision_module=false``, two steps:
   the windowed tower trains (its permutation and merger too), B2/B3 at D
   80 once per block and backward pass.  ``--qwen-only`` runs phases 1, 2
   and 8 and prints their numbers instead of a result line.
9. CLEAR's text-only stack, ``configs/nlp/*.yaml``, on Llama-2-7B at full
   width and depth from seed 42, bf16, synthetic TOFU-style rows
   (``run_nlp_path``): 9a ``cli.nlp_finetune.main`` on finetune.yaml (LoRA
   r 8, max_length 500; its 128-row batch as 16 accumulated micro-batches of
   8; 2 steps; merged and saved in bf16); 9b ``cli.nlp_forget.main`` on
   forget.yaml as it ships (RMU, LoRA r 8, batch 4, accumulation 2, AdamW)
   from 9a's checkpoint, 3 steps, saved; at 9b's loop's end, on its student
   (9c): RMU's first batch on the kernels and on plain attention (loss
   within 0.05, cosine >= 0.95 on every LoRA leaf), then one step each of
   idk (one concatenated forward), dpo, npo (the text trainer's form) and
   grad_ascent with L1 of the adapters; 9c grad_proj (full parameters, SGD,
   two backward passes) and grad_proj_l2 (second order: first-order passes
   on the kernels, its two Hessian-vector products a layer at a time on the
   plain attention) through the CLI from 9b's checkpoint as forget.yaml
   ships them (8 rows of 500 tokens a step), each one step, its peak
   printed; 9d
   ``cli.nlp_eval.main`` on eval_everything.yaml with 9b's checkpoint (four
   tasks, ``ds_size`` 8, max_length 1024, 200 new tokens, greedy: B1, B4);
   9e the same on 9a's checkpoint (the retain model's stand-in) with
   ``engine_generate=true speculative_k=4`` (B1, B5); 9f
   ``cli.nlp_aggregate.main`` on 9d's and 9e's aggregates; 9g
   ``inspect_runs`` sweep and gens over the runs, ``build_tables`` over
   phase 7's two aggregates, ``push_model``'s layout check.  Every loss and
   gradient norm finite, no step skipped, RMU's loss moving and the LoRA b
   leaves off zero, the launches of B1-B5 exactly as each run's structure
   gives, the checkpoints holding exactly
   ``llama_to_hf``'s names in bf16, the eval files in the JAX schema, every
   generated token within ``TIE_MARGIN`` of a teacher-forced argmax, the CSV
   with the JAX CLI's columns, all finite.  Prints seconds per sub-phase,
   steps/s and tok/s per step, peaks, eval seconds per task, tok/s and ms
   per decode step (per verify round in 9e), merge, save and load seconds.
10. CLEAR's unlearning methods and the sweep (``run_methods_path``, run
   at phase 9's end while 9a's checkpoint exists): 10a
   ``cli.salun_generate.main`` on ``configs/methods/salun.yaml`` as it
   ships (tiny-llama-test, f32, plain attention: no launch), then on
   Llama-2-7B at full width with its decoder cut to ``SALUN_DEPTH`` (2)
   layers (bf16, batch 4, max_length 128): the saliency finite, B1-B3 once
   a layer and batch, and the ten ``with_{t}.npz`` (26.7 GB, in memory
   files of the process, ``_ram_dir``, closed after) read back a tensor at
   a time: the parameter tree's paths and shapes in float32, exactly
   ``int(t * n)`` kept per tensor (per layer of a stacked leaf), each mask
   inside the next, t = 1.0 all ones; 10b ``cli.eco_prepare.main`` on
   ``configs/methods/eco_llama2-7b.yaml`` in f32 from 9a's checkpoint
   (``NLP_DATA``: 25 forget rows, batches of 8, 8, 8 and 1, 32 new tokens):
   the flagged tokens of every gated prompt exactly its entity's, every
   generated token within ``TIE_MARGIN`` of a teacher-forced argmax on the
   corrupted embeddings, an ungated row's logits equal to the clean
   forward's bit for bit and a flagged row's not, the prefill logits
   within ``ECO_LOGIT_TOL`` of f32 plain attention's, B1's and B4's f32
   instances launched exactly once a layer per prefill and decode step
   (nothing else), ``eco_prompts.jsonl`` in the JAX schema; then detectors
   trained by ``cli.eco_train_classifiers.main`` on the host
   (``ECO_DETECTOR_EPOCHS``) driving ECO on the same model; 10c
   ``cli.nlp_forget.main`` with ``forget_loss=eco_ft`` on 10b's prompts
   from 9a's checkpoint (forget.yaml's LoRA r 8, bf16, two steps): finite,
   the LoRA b leaves off zero, B1-B3 as the steps give; 10d
   ``orchestrate.run_exps`` (``SWEEP_ARGS``: ``stack=nlp``, grad_ascent on
   tiny-llama-test) running forget and evaluation as subprocesses on the
   card, exit 0, both artifacts and both logs, then a second run that
   skips both and launches no subprocess.  Prints seconds, peaks and
   launches per sub-phase.
11. Prints one ``{"eval": ...}`` line (phase 7's numbers, 8c's, 8f's,
   9d/9e's and phase 10's), one ``{"kernels": [...]}`` line (twelve kernels; B1-B3 with
   phase 6's launches, B1, B4 and B5 with phase 7's, each with a
   ``qwen2vl`` entry: phase 2's numbers at the Qwen shapes and phase 8's
   launches, 8f's included; B2 and B3 with their head-dim-80 launches in 8g
   and 8i; B8 with 8h's), and B1-B5 with an ``nlp`` entry: phase 2's
   numbers at phase 9's shapes and phase 9's launches; B1-B3 with phase
   10's launches, B1 and B4 with an ``f32`` entry: their f32 instances'
   phase 2 numbers and 10b's launches), the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_unlearning_tpu_torch import bench as forget_bench
from multimodal_unlearning_tpu_torch.cli import common, serve
from multimodal_unlearning_tpu_torch.config import Config
from multimodal_unlearning_tpu_torch.data import preprocess_image
from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.ops.attention import (
    flash_attention_lse, flash_bwd_dkv, flash_bwd_dq)
from multimodal_unlearning_tpu_torch.ops import decode_attention as dec_ops
from multimodal_unlearning_tpu_torch.ops import int4_matmul as b8
from multimodal_unlearning_tpu_torch.ops.decode_attention import (
    chunk_decode_attention, decode_attention)
from multimodal_unlearning_tpu_torch.ops.paged_attention import (
    gather_layer_kv, paged_chunk_decode_attention, paged_decode_attention)
from multimodal_unlearning_tpu_torch.serve import ServingEngine
from multimodal_unlearning_tpu_torch.utils import quantize
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
# B8 against its plain version: both form exact products of bf16 activations
# and int4 values and sum them in f32 in another order; the kernel then rounds
# each output to bf16, one ulp being 2^-8 of it: max |err| <= 1e-2 of the
# largest plain output
B8_REL_TOL = 1e-2
# a weight stream timed cold: B8 cycles through copies of its weight that
# together exceed the H100's 50 MB L2, as a decode step reads each weight once
COLD_BYTES = 120e6
# published peaks of one H100 SXM (dense bf16 tensor cores, f32 on the CUDA
# cores outside the tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the f32 instances of B1 and B4 (ECO) against their plain version in f32:
# both compute in f32 and differ in the summation order and the online
# softmax's rescaling, a few f32 ulps of sums over up to 160 columns
F32_TOL = 5e-5
F32_LSE_TOL = 1e-5
# ECO's prefill logits, f32 kernels against f32 plain attention through 32
# layers of Llama-2-7B (random weights, logits ~ N(0, 1)): f32 rounding only
ECO_LOGIT_TOL = 1e-3


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


def n_cold(nbytes: float) -> int:
    """How many copies of inputs of ``nbytes`` together exceed the L2
    (``COLD_BYTES``), so that a cycle over them reads each one cold."""
    return max(2, int(-(-COLD_BYTES // nbytes)))


def bound(bytes_moved: float, flops: float, peak_flops=PEAK_BF16_FLOPS) -> tuple[float, str]:
    """Least time the card could take (ms) and what bounds it (operations at
    ``peak_flops``: the bf16 tensor cores' by default)."""
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)


# ------------------------------------------------------------- phase 2
def check_b1(dev, gen):
    """B1 cases; returns (max error over cases, {case: its numbers} for the
    serving ViT and prefill and the forget step's decoder and ViT shapes)."""
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
        # device time on copies of q, k, v cycled past the L2; the CUDA-event
        # time of 20 back-to-back calls on one copy beside it (the older
        # method, which counts the host's launch gaps)
        copies = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                                for _ in range(n_cold(nbytes) - 1)]
        ms = device_ms_cycle([lambda c=c: flash_attention_lse(
            *c, mask, causal=causal, q_offset=q_off) for c in copies])
        event_ms = cuda_ms(lambda: flash_attention_lse(q, k, v, mask, causal=causal,
                                                       q_offset=q_off))
        plain_ms = device_ms_cycle([lambda c=c: flash_attention_lse(
            *c, mask, causal=causal, q_offset=q_off, impl="plain") for c in copies[:2]], iters=4)
        plain_causal = causal and pad == 0 and q_off == 0 and Sq == Sk
        bool_mask = None if (pad == 0 and not causal) or plain_causal \
            else vis[:, None]  # [B, 1, Sq, Sk]
        lib_ms = device_ms_cycle([lambda c=c: F.scaled_dot_product_attention(
            *c, attn_mask=bool_mask, is_causal=plain_causal, enable_gqa=Hq != Hkv)
            for c in copies])
        print(f"B1 {name} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} causal={causal} "
              f"q_offset={q_off} pad={pad}: max|err| {err:.3e} lse {lse_err:.2e} | device time: "
              f"kernel {ms:.4f} ms (CUDA events {event_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB; {len(copies)} input copies cycled)", flush=True)
        if name in ("vit", "prefill", "step", "step_vit"):
            record[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                bound_by=b_by, event_ms=event_ms)
        del copies
        del q, k, v, o, lse, o_ref, lse_ref, vis, bool_mask
    return worst, record


def decode_plan(B, Hkv, G, Smax):
    """The one-token kernel's column runs at this shape, as text (a tree
    without the split plan runs one block per row)."""
    plan = getattr(dec_ops, "decode_split_plan", None)
    if plan is None:
        return "one block per (row, kv-head)"
    splits, per = plan(B, Hkv, G, Smax, dec_ops.sm_count(torch.device("cuda")))
    return f"{splits} run(s) of {per} columns per (row, kv-head)"


def narrowed(valid, extent):
    """The mask as the serving engine hands it to attention: narrowed to its
    first ``extent`` columns (no row holds a valid column past them), on a
    tree whose decode kernels take a narrowed mask; the full mask otherwise."""
    return valid[:, :extent] if hasattr(dec_ops, "valid_columns") else valid


def short_rows(B, S, rng, idle=5):
    """The engine's decode rows in its profiled windows: 100-180 valid
    columns (a left-padded 128-column prompt bucket plus decoded columns),
    row ``idle`` all invalid; the engine's extent for them is 256 columns."""
    valid = torch.zeros((B, S), dtype=torch.int32)
    for b in range(B):
        if b != idle:
            plen = int(rng.integers(60, 121))
            valid[b, 128 - plen:128 + int(rng.integers(40, 61))] = 1
    return valid, 256


def check_b4(dev, gen):
    """B4 at the stacked [4, 8, 32, 2048, 128] cache, layer 3, in two cases:
    ragged rows of 0-1,470 valid columns (the mask at full width), and the
    engine's short decode rows (100-180 valid) with the mask narrowed to the
    engine's extent.  Returns (max error, numbers of the ragged case with the
    short case's under "short_rows")."""
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
    short, extent = short_rows(B, Smax, rng)
    cases = (("ragged", valid), ("short rows", narrowed(short.to(dev), extent)))
    worst, record = 0.0, {}
    for label, mask in cases:
        o = decode_attention(q, cache, layer, mask)
        torch.cuda.synchronize()
        ref = decode_attention(q, cache, layer, mask, impl="plain")
        err = (o.float() - ref.float()).abs().max().item()
        if err > KERNEL_TOL or not torch.all(o[5] == 0):
            raise AssertionError(f"B4 {label}: max |err| {err} (tol {KERNEL_TOL}) or the "
                                 "all-invalid row not 0")
        worst = max(worst, err)
        n_valid = int(mask.sum().item())
        # the function needs the valid K and V columns of layer 3, q, o, the mask
        nbytes = 2 * n_valid * Hkv * D * 2 + 2 * (q.numel() + o.numel()) + 4 * mask.numel()
        flops = 4.0 * D * n_valid * Hq
        b_ms, b_by = bound(nbytes, flops)
        full_ms, _ = bound(2 * 2 * B * Hkv * Smax * D, 0.0)
        # device time cycled over the cache's layers (each read cold), CUDA events beside it
        ms = device_ms_cycle([lambda l=l: decode_attention(q, cache, l, mask) for l in range(L)])
        event_ms = cuda_ms(lambda: decode_attention(q, cache, layer, mask))
        plain_ms = device_ms_cycle([lambda: decode_attention(q, cache, layer, mask,
                                                             impl="plain")], iters=4)
        S = mask.shape[1]
        bool_mask = mask.bool()[:, None, None, :]
        lib_ms = device_ms_cycle([lambda l=l: F.scaled_dot_product_attention(
            q, cache["k"][l][:, :, :S], cache["v"][l][:, :, :S], attn_mask=bool_mask)
            for l in range(L)])
        print(f"B4 {label}: cache [{L},{B},{Hkv},{Smax},{D}] layer {layer}, mask of {S} "
              f"columns, {n_valid} valid columns of {B * Smax}, "
              f"{decode_plan(B, Hkv, Hq // Hkv, S)}: max|err| {err:.3e} | "
              f"device time: kernel {ms:.4f} ms (CUDA events "
              f"{event_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.2f} MB; "
              f"streaming all {B * Smax} columns would be {full_ms:.4f} ms)", flush=True)
        numbers = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, event_ms=event_ms)
        if label == "ragged":
            record.update(numbers)
        else:
            record["short_rows"] = dict(numbers, mask_columns=S, valid_columns=n_valid)
    return worst, record


def _int8_cache(shape, dev, gen):
    """A random int8 cache with f32 scales [L, B, Hkv, 1, Smax] (positive,
    of the size the quantize-at-write gives unit-variance K/V)."""
    cache = {}
    for n in ("k", "v"):
        cache[n] = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        cache[n + "_s"] = 0.02 + 0.01 * torch.rand(shape[:3] + (1, shape[3]), generator=gen,
                                                    device=dev)
    return cache


def check_b4q(dev, gen):
    """B4q at the int8 decode shape of LLaVA-1.5-7B's serving path."""
    L, B, Hq, Hkv, Smax, D, layer = 32, 8, 32, 32, 2048, 128, 31
    cache = _int8_cache((L, B, Hkv, Smax, D), dev, gen)
    q = randn(gen, (B, Hq, 1, D), dev)
    valid = torch.zeros((B, Smax), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(1)
    for b in range(B):
        if b == 2:
            continue  # an idle slot: all invalid
        bucket = int(rng.integers(1, 12)) * 128
        plen = int(rng.integers(1, bucket + 1))
        valid[b, bucket - plen:bucket + int(rng.integers(0, 64))] = 1
    o = decode_attention(q, cache, layer, valid)
    torch.cuda.synchronize()
    ref = decode_attention(q, cache, layer, valid, impl="plain")
    err = (o.float() - ref.float()).abs().max().item()
    if err > KERNEL_TOL or not torch.all(o[2] == 0):
        raise AssertionError(f"B4q: max |err| {err} (tol {KERNEL_TOL}) or the all-invalid row "
                             "not 0")
    n_valid = int(valid.sum().item())
    # valid int8 K and V columns of the layer with their two f32 scales, q, o, valid
    nbytes = n_valid * Hkv * (2 * D + 8) + 2 * (q.numel() + o.numel()) + 4 * valid.numel()
    b_ms, b_by = bound(nbytes, 4.0 * D * n_valid * Hq)
    # device time cycled over the last four layers, CUDA events beside it
    cold = range(L - 4, L)
    ms = device_ms_cycle([lambda l=l: decode_attention(q, cache, l, valid) for l in cold])
    event_ms = cuda_ms(lambda: decode_attention(q, cache, layer, valid))
    plain_ms = device_ms_cycle([lambda: decode_attention(q, cache, layer, valid, impl="plain")],
                               iters=4)
    # the yardstick: no PyTorch call reads an int8 cache; SDPA over bf16
    # slabs of the same shape, four of them cycled
    slabs = [tuple(randn(gen, (B, Hkv, Smax, D), dev) for _ in range(2)) for _ in cold]
    bool_mask = valid.bool()[:, None, None, :]
    lib_ms = device_ms_cycle([lambda c=c: F.scaled_dot_product_attention(
        q, *c, attn_mask=bool_mask) for c in slabs])
    print(f"B4q int8 cache [{L},{B},{Hkv},{Smax},{D}] layer {layer}, {n_valid} valid columns of "
          f"{B * Smax}, {decode_plan(B, Hkv, Hq // Hkv, Smax)}: max|err| {err:.3e} | "
          f"device time: kernel {ms:.4f} ms (CUDA events "
          f"{event_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"sdpa on a bf16 cache of the same shape {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {nbytes / 1e6:.2f} MB)", flush=True)
    del slabs
    record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                  event_ms=event_ms)
    # the engine's short decode rows, the mask narrowed to its extent
    short, extent = short_rows(B, Smax, rng, idle=2)
    mask = narrowed(short.to(dev), extent)
    o = decode_attention(q, cache, layer, mask)
    torch.cuda.synchronize()
    s_err = (o.float() - decode_attention(q, cache, layer, mask, impl="plain").float()
             ).abs().max().item()
    if s_err > KERNEL_TOL or not torch.all(o[2] == 0):
        raise AssertionError(f"B4q short rows: max |err| {s_err} (tol {KERNEL_TOL}) or the "
                             "all-invalid row not 0")
    n_s = int(mask.sum().item())
    s_bound, _ = bound(n_s * Hkv * (2 * D + 8) + 2 * (q.numel() + o.numel()) + 4 * mask.numel(),
                       4.0 * D * n_s * Hq)
    s_ms = device_ms_cycle([lambda l=l: decode_attention(q, cache, l, mask) for l in cold])
    print(f"B4q short rows: mask of {mask.shape[1]} columns, {n_s} valid, "
          f"{decode_plan(B, Hkv, Hq // Hkv, mask.shape[1])}: max|err| {s_err:.3e} | device "
          f"time: kernel {s_ms:.4f} ms, bound {s_bound:.4f} ms", flush=True)
    record["short_rows"] = dict(ms=s_ms, bound_ms=s_bound, mask_columns=mask.shape[1],
                                valid_columns=n_s, max_abs_err=s_err)
    return max(err, s_err), record


def check_b5(dev, gen):
    """B5 and B5q: the verify round of speculation (B 8, C 5, per-row
    offsets, stale columns past each chunk), a chunked-prefill pass (B 1,
    C 512 over a 1,536-column slab view), a GQA case and phase 7b's verify
    round, on a bf16 and an int8 cache.  Returns per kernel (max error,
    {case: numbers})."""
    cases = [
        # name, B, Hq, Hkv, C, Smax (columns the cache holds), slab columns read
        ("verify", 8, 32, 32, 5, 2048, 2048),
        ("prefill_chunk", 1, 32, 32, 512, 2048, 1536),
        ("gqa", 4, 32, 8, 5, 2048, 2048),
        # 7b's engine: eval.yaml's max_length 4096 + 300 new tokens + slack
        # 10, bucketed to 4,480 columns a slot, all of them in the mask
        ("eval_verify", 8, 32, 32, 5, 4480, 4480),
    ]
    L, D, layer = 4, 128, 3
    rng = np.random.default_rng(2)
    worst = {"chunk_decode": 0.0, "chunk_decode_q8": 0.0}
    record = {"chunk_decode": {}, "chunk_decode_q8": {}}
    for name, B, Hq, Hkv, C, Smax, S in cases:
        valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
        offset = torch.zeros((B,), dtype=torch.int32, device=dev)
        for b in range(B):
            if name == "prefill_chunk":
                off, start = S - C, 0  # 1,024 prefix columns, then the chunk
            elif name == "eval_verify":
                # a question left-padded to 128 columns, then up to 300
                # generated tokens
                off = 128 + int(rng.integers(0, 300))
                start = 128 - int(rng.integers(16, 128))
            else:
                off = int(rng.integers(200, S - 64))
                start = int(rng.integers(0, 128))  # left padding below the prefix
            valid[b, start:off] = 1
            offset[b] = off
        q = randn(gen, (B, Hq, C, D), dev)
        vis = valid.bool()[:, None, :] | (
            (torch.arange(S, device=dev)[None, None, :] >= offset[:, None, None].long())
            & (torch.arange(S, device=dev)[None, None, :]
               <= offset[:, None, None].long() + torch.arange(C, device=dev)[None, :, None]))
        pairs = Hq * int(vis.sum().item())
        cols = Hkv * int(vis.any(dim=1).sum().item())  # (row, kv-head, column) read
        for kname, int8 in (("chunk_decode", False), ("chunk_decode_q8", True)):
            shape = (L, B, Hkv, Smax, D)
            full = _int8_cache(shape, dev, gen) if int8 else {
                n: randn(gen, shape, dev) for n in ("k", "v")}
            # the columns a pass reads are a view (a slot's or a slab's)
            cache = {n: t[..., :S, :] if n in ("k", "v") else t[..., :S] for n, t in full.items()}
            o = chunk_decode_attention(q, cache, layer, valid, offset)
            torch.cuda.synchronize()
            ref = chunk_decode_attention(q, cache, layer, valid, offset, impl="plain")
            err = (o.float() - ref.float()).abs().max().item()
            if err > KERNEL_TOL:
                raise AssertionError(f"{kname} {name}: max |err| {err} (tol {KERNEL_TOL})")
            worst[kname] = max(worst[kname], err)
            per_col = 2 * D + 8 if int8 else 4 * D
            nbytes = cols * per_col + 2 * (q.numel() + o.numel()) + 4 * (valid.numel() + B)
            b_ms, b_by = bound(nbytes, 4.0 * D * pairs)
            # device time cycled over the cache's layers (each read cold),
            # CUDA events around back-to-back calls on one layer beside it
            ms = device_ms_cycle([lambda l=l: chunk_decode_attention(q, cache, l, valid, offset)
                                  for l in range(L)])
            event_ms = cuda_ms(lambda: chunk_decode_attention(q, cache, layer, valid, offset))
            plain_ms = device_ms_cycle([lambda: chunk_decode_attention(
                q, cache, layer, valid, offset, impl="plain")], iters=4)
            # the yardstick: SDPA with an explicit boolean mask over the
            # layers' bf16 columns (for B5q a bf16 cache of the same shape)
            slabs = ([(cache["k"][l], cache["v"][l]) for l in range(L)] if not int8
                     else [tuple(randn(gen, (B, Hkv, S, D), dev) for _ in range(2))
                           for _ in range(L)])
            lib_ms = device_ms_cycle([lambda c=c: F.scaled_dot_product_attention(
                q, *c, attn_mask=vis[:, None], enable_gqa=Hq != Hkv) for c in slabs])
            print(f"{'B5q' if int8 else 'B5'} {name} B{B} Hq{Hq} Hkv{Hkv} C{C} slab {S} of "
                  f"Smax {Smax}{' int8' if int8 else ''}: max|err| {err:.3e} | device time: "
                  f"kernel {ms:.4f} ms (CUDA events {event_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"sdpa{' (bf16 cache)' if int8 else ''} "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{4.0 * D * pairs / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
            record[kname][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                       bound_ms=b_ms, bound_by=b_by, event_ms=event_ms)
            del full, cache, o, ref, slabs
    return worst, record


def _dense_and_paged(dev, gen, rng, L, B, Hkv, S, P, D, int8):
    """A random dense cache [L, B, Hkv, S, D] (bf16, or int8 with f32
    scales) and the same columns as a paged pool [L, Hkv, NP, P, D] with a
    block table, pages assigned to the rows by a random permutation of
    1..NP-1 (page 0 unused, as the engine keeps it)."""
    shape = (L, B, Hkv, S, D)
    dense = _int8_cache(shape, dev, gen) if int8 else {n: randn(gen, shape, dev)
                                                       for n in ("k", "v")}
    MP = S // P
    table = torch.from_numpy((1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)).to(dev)
    pool = {"table": table}
    for n, t in dense.items():
        if n in ("k", "v"):
            pool[n] = torch.zeros((L, Hkv, B * MP + 1, P, D), dtype=t.dtype, device=dev)
            pool[n][:, :, table.long()] = t.reshape(L, B, Hkv, MP, P, D).transpose(1, 2)
        else:  # scales [L, B, Hkv, 1, S] -> [L, Hkv, NP, 1, P]
            pool[n] = torch.zeros((L, Hkv, B * MP + 1, 1, P), dtype=t.dtype, device=dev)
            pool[n][:, :, table.long()] = t.reshape(L, B, Hkv, 1, MP, P).permute(0, 2, 1, 4, 3, 5)
    return dense, pool


def check_b6(dev, gen):
    """B6 and B6q: one-token attention through the block table of a 4-layer
    pool at layer 3, 8 rows, 32 heads, D 128, pages of 128 and of 16
    columns; ragged rows as the engine leaves them, an all-invalid gap page
    after a 100-column prefix in row 1, an idle row 5.  The pool holds a
    dense cache's columns: B6/B6q must give B4/B4q's output bit for bit on
    it, and B4/B4q's time on it stands beside theirs.  At pages of 128 also
    the engine's short decode rows with the mask narrowed to its extent.
    Returns per kernel (max error, {page size: numbers})."""
    L, B, Hq, Hkv, S, D, layer = 4, 8, 32, 32, 2048, 128, 3
    rng = np.random.default_rng(3)
    valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b in range(B):
        if b == 5:
            continue
        if b == 1:
            valid[b, :100] = 1
            valid[b, 256:256 + int(rng.integers(1, 700))] = 1
            continue
        bucket = int(rng.integers(1, 12)) * 128
        plen = int(rng.integers(1, bucket + 1))
        valid[b, bucket - plen:bucket + int(rng.integers(0, 64))] = 1
    short, extent = short_rows(B, S, np.random.default_rng(4))
    q = randn(gen, (B, Hq, 1, D), dev)
    n_valid = int(valid.sum().item())
    worst = {"paged_decode": 0.0, "paged_decode_q8": 0.0}
    record = {"paged_decode": {}, "paged_decode_q8": {}}
    for P in (128, 16):
        for kname, int8 in (("paged_decode", False), ("paged_decode_q8", True)):
            dense, pool = _dense_and_paged(dev, gen, rng, L, B, Hkv, S, P, D, int8)
            o = paged_decode_attention(q, pool, layer, valid)
            torch.cuda.synchronize()
            ref = paged_decode_attention(q, pool, layer, valid, impl="plain")
            err = (o.float() - ref.float()).abs().max().item()
            if err > KERNEL_TOL or not torch.all(o[5] == 0):
                raise AssertionError(f"{kname} P{P}: max |err| {err} (tol {KERNEL_TOL}) or the "
                                     "idle row not 0")
            if not torch.equal(o, decode_attention(q, dense, layer, valid)):
                raise AssertionError(f"{kname} P{P}: not B4's output bit for bit")
            worst[kname] = max(worst[kname], err)
            per_col = 2 * D + 8 if int8 else 4 * D
            nbytes = (n_valid * Hkv * per_col + 2 * (q.numel() + o.numel())
                      + 4 * (valid.numel() + pool["table"].numel()))
            b_ms, b_by = bound(nbytes, 4.0 * D * n_valid * Hq)
            # device time cycled over the pool's layers (each read cold),
            # CUDA events beside it
            ms = device_ms_cycle([lambda l=l: paged_decode_attention(q, pool, l, valid)
                                  for l in range(L)])
            event_ms = cuda_ms(lambda: paged_decode_attention(q, pool, layer, valid))
            dense_ms = device_ms_cycle([lambda l=l: decode_attention(q, dense, l, valid)
                                        for l in range(L)])
            plain_ms = device_ms_cycle([lambda: paged_decode_attention(
                q, pool, layer, valid, impl="plain")], iters=4)
            # the yardstick: SDPA over the gathered bf16 view (gather excluded)
            views = [gather_layer_kv(pool, l, torch.bfloat16) for l in range(L)]
            lib_ms = device_ms_cycle([lambda c=c: F.scaled_dot_product_attention(
                q, *c, attn_mask=valid.bool()[:, None, None, :]) for c in views])
            label = "B6q" if int8 else "B6"
            print(f"{label} pool [{L},{Hkv},{pool['k'].shape[2]},{P},{D}]{' int8' if int8 else ''} "
                  f"layer {layer}, {B} rows of {S} logical columns, {n_valid} valid, "
                  f"{decode_plan(B, Hkv, Hq // Hkv, S)}: max|err| "
                  f"{err:.3e}, equal to the dense kernel's | device time: kernel {ms:.4f} ms "
                  f"(CUDA events {event_ms:.4f} ms; the dense kernel on the same columns "
                  f"{dense_ms:.4f} ms), plain (gather + attention) {plain_ms:.4f} ms, "
                  f"sdpa on the gathered bf16 view {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{nbytes / 1e6:.2f} MB)", flush=True)
            record[kname][P] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                    bound_by=b_by, dense_kernel_ms=dense_ms, event_ms=event_ms)
            if P == 128:  # the engine's short decode rows, the mask narrowed to its extent
                mask = narrowed(short.to(dev), extent)
                o = paged_decode_attention(q, pool, layer, mask)
                torch.cuda.synchronize()
                s_err = (o.float() - paged_decode_attention(q, pool, layer, mask, impl="plain")
                         .float()).abs().max().item()
                if s_err > KERNEL_TOL or not torch.all(o[5] == 0):
                    raise AssertionError(f"{kname} short rows: max |err| {s_err} (tol "
                                         f"{KERNEL_TOL}) or the idle row not 0")
                if not torch.equal(o, decode_attention(q, dense, layer, mask)):
                    raise AssertionError(f"{kname} short rows: not B4's output bit for bit")
                worst[kname] = max(worst[kname], s_err)
                n_s = int(mask.sum().item())
                s_bound, _ = bound(n_s * Hkv * per_col + 2 * (q.numel() + o.numel())
                                   + 4 * (mask.numel() + pool["table"].numel()),
                                   4.0 * D * n_s * Hq)
                s_ms = device_ms_cycle([lambda l=l: paged_decode_attention(q, pool, l, mask)
                                        for l in range(L)])
                print(f"{label} P{P} short rows: mask of {mask.shape[1]} columns, {n_s} valid, "
                      f"{decode_plan(B, Hkv, Hq // Hkv, mask.shape[1])}: max|err| {s_err:.3e}, "
                      f"equal to the dense kernel's | device time: kernel {s_ms:.4f} ms, bound "
                      f"{s_bound:.4f} ms", flush=True)
                record[kname][P]["short_rows"] = dict(ms=s_ms, bound_ms=s_bound,
                                                      mask_columns=mask.shape[1],
                                                      valid_columns=n_s, max_abs_err=s_err)
            del dense, pool, o, ref, views
    return worst, record


def check_b7(dev, gen):
    """B7 and B7q: the verify round (B 8, C 5), a chunked-prefill pass (B 1,
    C 512 behind 1,024 prefix columns), GQA, and chunks that straddle a page
    boundary, through the block table of pages of 128 columns (and the
    verify round on pages of 16).  The pool holds a dense cache's columns:
    B7/B7q must give B5/B5q's output bit for bit on it, and B5/B5q's time on
    it stands beside theirs.  Returns per kernel (max error, {case:
    numbers})."""
    cases = [
        # name, B, Hq, Hkv, C, page
        ("verify", 8, 32, 32, 5, 128),
        ("prefill_chunk", 1, 32, 32, 512, 128),
        ("gqa", 4, 32, 8, 5, 128),
        ("straddle", 8, 32, 32, 5, 128),
        ("verify_p16", 8, 32, 32, 5, 16),
    ]
    L, S, D, layer = 4, 2048, 128, 3
    rng = np.random.default_rng(4)
    worst = {"paged_chunk": 0.0, "paged_chunk_q8": 0.0}
    record = {"paged_chunk": {}, "paged_chunk_q8": {}}
    for name, B, Hq, Hkv, C, P in cases:
        valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
        offset = torch.zeros((B,), dtype=torch.int32, device=dev)
        for b in range(B):
            if name == "prefill_chunk":
                off, start = 1024, 0
            elif name == "straddle":  # the chunk starts 2 columns before a page boundary
                off, start = int(rng.integers(2, 15)) * P - 2, int(rng.integers(0, 128))
            else:
                off, start = int(rng.integers(200, S - 64)), int(rng.integers(0, 128))
            valid[b, start:off] = 1
            offset[b] = off
        q = randn(gen, (B, Hq, C, D), dev)
        vis = valid.bool()[:, None, :] | (
            (torch.arange(S, device=dev)[None, None, :] >= offset[:, None, None].long())
            & (torch.arange(S, device=dev)[None, None, :]
               <= offset[:, None, None].long() + torch.arange(C, device=dev)[None, :, None]))
        pairs = Hq * int(vis.sum().item())
        cols = Hkv * int(vis.any(dim=1).sum().item())  # (row, kv-head, column) read
        for kname, int8 in (("paged_chunk", False), ("paged_chunk_q8", True)):
            dense, pool = _dense_and_paged(dev, gen, rng, L, B, Hkv, S, P, D, int8)
            o = paged_chunk_decode_attention(q, pool, layer, valid, offset)
            torch.cuda.synchronize()
            ref = paged_chunk_decode_attention(q, pool, layer, valid, offset, impl="plain")
            err = (o.float() - ref.float()).abs().max().item()
            if err > KERNEL_TOL:
                raise AssertionError(f"{kname} {name}: max |err| {err} (tol {KERNEL_TOL})")
            if not torch.equal(o, chunk_decode_attention(q, dense, layer, valid, offset)):
                raise AssertionError(f"{kname} {name}: not B5's output bit for bit")
            worst[kname] = max(worst[kname], err)
            per_col = 2 * D + 8 if int8 else 4 * D
            nbytes = (cols * per_col + 2 * (q.numel() + o.numel())
                      + 4 * (valid.numel() + B + pool["table"].numel()))
            b_ms, b_by = bound(nbytes, 4.0 * D * pairs)
            ms = device_ms_cycle([lambda l=l: paged_chunk_decode_attention(
                q, pool, l, valid, offset) for l in range(L)])
            event_ms = cuda_ms(lambda: paged_chunk_decode_attention(q, pool, layer, valid, offset))
            dense_ms = device_ms_cycle([lambda l=l: chunk_decode_attention(
                q, dense, l, valid, offset) for l in range(L)])
            plain_ms = device_ms_cycle([lambda: paged_chunk_decode_attention(
                q, pool, layer, valid, offset, impl="plain")], iters=4)
            views = [gather_layer_kv(pool, l, torch.bfloat16) for l in range(L)]
            lib_ms = device_ms_cycle([lambda c=c: F.scaled_dot_product_attention(
                q, *c, attn_mask=vis[:, None], enable_gqa=Hq != Hkv) for c in views])
            print(f"{'B7q' if int8 else 'B7'} {name} B{B} Hq{Hq} Hkv{Hkv} C{C} page {P}, {S} "
                  f"logical columns{' int8' if int8 else ''}: max|err| {err:.3e}, equal to the "
                  f"dense kernel's | device time: kernel {ms:.4f} ms (CUDA events "
                  f"{event_ms:.4f} ms; the dense kernel on the same columns "
                  f"{dense_ms:.4f} ms), plain (gather + attention) {plain_ms:.4f} ms, sdpa on the "
                  f"gathered bf16 view {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{4.0 * D * pairs / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
            record[kname][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                       bound_ms=b_ms, bound_by=b_by, dense_kernel_ms=dense_ms,
                                       event_ms=event_ms)
            del dense, pool, o, ref, views
    return worst, record


def cuda_ms_cycle(fns, iters=24) -> float:
    """cuda_ms over a cycle of calls (each on its own copy of the inputs)."""
    calls = itertools.cycle(fns)
    return cuda_ms(lambda: next(calls)(), iters=iters, warmup=len(fns))


def device_ms_cycle(fns, iters=24) -> float:
    """Device time per call (ms) over a cycle of calls: the summed time of
    the device kernels the calls launch, from torch.profiler.  Unlike CUDA
    events around back-to-back calls it leaves out the gaps in which the
    device waits for the host to launch the next call, which for calls of
    ~10-20 us are most of the window.  The profiler now and then drops
    device events from a window (a window of zero, or of half the time, was
    seen; once three windows of zero in a row), so two windows are taken and
    the larger kept; a window with no device kernel at all is taken again
    (six times at most), then raises."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    calls = itertools.cycle(fns)
    for _ in range(len(fns)):
        next(calls)()
    torch.cuda.synchronize()
    totals = []
    for _ in range(8):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                next(calls)()
            torch.cuda.synchronize()
        total = sum(ns for _, ns, _ in _device_events(prof)) / 1e3
        if total > 0:
            totals.append(total)
        if len(totals) == 2:
            return max(totals) / 1e3 / iters
    raise RuntimeError("the profiler recorded no device time in seven of eight windows")


def _int4pack_yardstick(q4, s, G):
    """One PyTorch call computing B8's function: ``torch._weight_int4pack_mm``
    on the same int4 values repacked by ``torch._convert_weight_to_int4pack``
    (tinygemm's unsigned nibbles: q = v + 8, zero 0, bf16 scales); None where
    the card's torch refuses the shape."""
    try:
        v = quantize.unpack_int4(q4).to(torch.int32) + 8          # [K, N], row order
        q = v.t().contiguous()                                     # [N, K]
        packed = torch._convert_weight_to_int4pack(((q[:, ::2] << 4) | q[:, 1::2]).to(
            torch.uint8), 8)
        st = s.t()
        sz = torch.stack([st, torch.zeros_like(st)], -1).transpose(0, 1).contiguous().to(
            torch.bfloat16)                                        # [K/G, N, 2]
        return lambda x: torch._weight_int4pack_mm(x, packed, G, sz)
    except (RuntimeError, AttributeError, TypeError) as e:
        print(f"  torch._weight_int4pack_mm refused this shape: {str(e)[:120]}", flush=True)
        return None


# B8's cases: LLaVA-1.5-7B's products (name, K, N, group), then the rows M
B8_SHAPES = [("qkvo", 4096, 4096, 128), ("gate_up", 4096, 11008, 128),
             ("down", 11008, 4096, 128), ("lm_head", 4096, 32000, 128),
             ("g64", 4096, 4096, 64), ("ragged_n", 4096, 4000, 128)]
B8_ROWS = (8, 40, 512, 1024)


def _dequant_yardstick():
    """The port's own route above ``INT4_MAX_KERNEL_ROWS``: each half of the
    weight dequantized to bf16, then ``torch.matmul`` (dequant included);
    None on a tree that does not have it as a function."""
    return getattr(quantize, "int4_dequant_matmul", None)


def b8_host_us(dev, gen, calls=1000, layers=4):
    """Host microseconds per ``grouped_int4_matmul`` call at M = 8 on the
    q/k/v/o product, called as the engine calls it: each call indexes one
    layer of a stacked ``QTensor4`` (fresh ``q4``/``s`` views every call).  A
    host timer around ``calls`` back-to-back calls, read before the device is
    waited for (the kernels, ~5-12 us each, keep up)."""
    w = torch.randn((layers, 4096, 4096), generator=gen, device=dev) * 4096 ** -0.5
    leaf = quantize.quantize_leaf_int4(w, 128)
    del w
    stacked = quantize.QTensor4(leaf["q4"], leaf["s"])
    x = randn(gen, (8, 4096), dev)

    def call(i):
        lw = stacked[i % layers]
        return b8.grouped_int4_matmul(x, lw["q4"], lw["s"])

    for i in range(20):
        call(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        call(i)
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e6
    print(f"B8 host time per call at M 8 (q/k/v/o, {calls} back-to-back calls, each on one "
          f"layer of a {layers}-layer stacked leaf): {host:.2f} us (to the device's end "
          f"{wall:.2f} us)", flush=True)
    return host


def check_b8(dev, gen):
    """B8 (grouped-int4 W4A16 matmul) against its plain version at
    LLaVA-1.5-7B's products -- q/k/v/o 4096x4096, gate/up 4096x11008, down
    11008x4096 (43 groups per half), lm_head 4096x32000 -- at M = 8 (decode),
    40 (a verify round of 8 rows x 5), 512 (a chunked-prefill pass) and 1024
    (the largest prefill bucket B8 takes), plus groups of 64 and a ragged N.
    Times kernel, plain version and one PyTorch call by their device time
    (profiler) on weights cycled through more than the L2 holds, with the
    bounds by bytes and by operations at every case; at M 40, 512 and 1024
    also the port's dequant route (per-weight dequant + ``torch.matmul``,
    dequant included), the route above ``INT4_MAX_KERNEL_ROWS``.  Returns
    (max error, {case: numbers})."""
    worst, record = 0.0, {}
    dequant_mm = _dequant_yardstick()
    for name, K, N, G in B8_SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        leaf = quantize.quantize_leaf_int4(w, G)
        del w
        q4, s = leaf["q4"], leaf["s"]
        wbytes = q4.numel() + 4 * s.numel()
        copies = [(quantize.in_contiguous(q4.clone()), s.clone())
                  for _ in range(max(1, int(-(-COLD_BYTES // wbytes))))]
        lib = _int4pack_yardstick(q4, s, G)
        lib_copies = None
        for M in (B8_ROWS if name in ("qkvo", "gate_up", "down", "lm_head") else B8_ROWS[:2]):
            x = randn(gen, (M, K), dev)
            y = b8.grouped_int4_matmul(x, q4, s)
            torch.cuda.synchronize()
            ref = b8.int4_matmul_reference(x, q4, s, torch.float32)
            err = (y.float() - ref).abs().max().item()
            top = ref.abs().max().item()
            if not torch.isfinite(y).all() or err > B8_REL_TOL * top:
                raise AssertionError(f"B8 {name} M{M}: max |err| {err:.4e} against max |plain| "
                                     f"{top:.4e} (tol {B8_REL_TOL} of it)")
            worst = max(worst, err)
            nbytes = 2 * M * K + wbytes + 2 * M * N
            flops = 2.0 * M * K * N
            b_ms, b_by = bound(nbytes, flops)
            bytes_ms, ops_ms = bound(nbytes, 0.0)[0], bound(0.0, flops)[0]
            per, splits = b8.splits_for(M, N, s.shape[0] // 2)
            kernel_calls = [lambda q=q, t=t: b8.grouped_int4_matmul(x, q, t) for q, t in copies]
            ms = device_ms_cycle(kernel_calls)
            event_ms = cuda_ms_cycle(kernel_calls)
            plain_ms = device_ms_cycle([lambda q=q, t=t: b8.int4_matmul_reference(x, q, t)
                                        for q, t in copies[:2]], iters=4)
            lib_name, lib_err = "torch._weight_int4pack_mm", None
            if lib is not None:
                try:
                    lib_err = (lib(x).float() - ref).abs().max().item()
                except RuntimeError as e:
                    print(f"  torch._weight_int4pack_mm failed at M{M}: {str(e)[:120]}")
            if lib_err is not None:
                if lib_copies is None:
                    lib_copies = [_int4pack_yardstick(q, t, G) for q, t in copies]
                lib_ms = device_ms_cycle([lambda f=f: f(x) for f in lib_copies])
            else:  # the stated fallback: bf16 matmul on the dequantized weight
                lib_name = "bf16 torch.matmul on the dequantized weight (dequant excluded)"
                dense = [quantize.dequantize_leaf({"q4": q, "s": t}) for q, t in copies[:3]]
                lib_ms = device_ms_cycle([lambda d=d: x @ d for d in dense])
                del dense
            dq_ms, dq_txt = None, ""
            if dequant_mm is not None and M >= 40 and name in ("qkvo", "gate_up", "down",
                                                                "lm_head"):
                dq_ms = device_ms_cycle([lambda q=q, t=t: dequant_mm(x, q, t)
                                         for q, t in copies[:2]], iters=8)
                dq_txt = f", the dequant route (dequant + torch.matmul) {dq_ms:.4f} ms"
            print(f"B8 {name} M{M} K{K} N{N} G{G}: max|err| {err:.3e} (max|plain| {top:.3e}), "
                  f"{splits} split(s) of {per} groups | device time per call: kernel "
                  f"{ms:.4f} ms (CUDA events around back-to-back calls {event_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms (max|err| vs plain "
                  f"{'n/a' if lib_err is None else f'{lib_err:.3e}'}){dq_txt}, bound {b_ms:.4f} "
                  f"ms ({b_by}; bytes {bytes_ms:.4f} ms for {nbytes / 1e6:.2f} MB, operations "
                  f"{ops_ms:.4f} ms for {flops / 1e9:.3f} GFLOP); {len(copies)} weight copies "
                  f"cycled", flush=True)
            record[f"{name}_m{M}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                          bound_ms=b_ms, bound_by=b_by, bound_bytes_ms=bytes_ms,
                                          bound_ops_ms=ops_ms, library=lib_name,
                                          dequant_matmul_ms=dq_ms, event_ms=event_ms)
            del x, y, ref
        del copies, lib, lib_copies, q4, s, leaf
        torch.cuda.empty_cache()
    # B8's share of a decode step (M = 8): 32 layers x (q, k, v, o, gate, up,
    # down) + lm_head
    step = lambda key: 32 * (4 * record["qkvo_m8"][key] + 2 * record["gate_up_m8"][key]
                             + record["down_m8"][key]) + record["lm_head_m8"][key]
    print(f"B8 per decode step at M 8 (225 launches), device time: kernels {step('ms'):.3f} ms "
          f"against a bound of {step('bound_ms'):.3f} ms; the yardstick "
          f"{step('library_ms'):.3f} ms; CUDA events around back-to-back B8 calls "
          f"{step('event_ms'):.3f} ms", flush=True)
    record["decode_step_ms"] = step("ms")
    record["host_us_m8"] = b8_host_us(dev, gen)
    return worst, record


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
    # the forget path's own batch is unpadded (bench.synthetic_batch), as "step"
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
        # both bounds, the larger of which is the kernel's bound
        dq_ops_ms = 6.0 * D * pairs / PEAK_BF16_FLOPS * 1e3
        dkv_ops_ms = 8.0 * D * pairs / PEAK_BF16_FLOPS * 1e3
        dq_bytes_ms = dq_bytes / PEAK_HBM_BYTES * 1e3
        dkv_bytes_ms = dkv_bytes / PEAK_HBM_BYTES * 1e3
        # device time on copies of q, k, v, do cycled past the L2; the
        # CUDA-event time of back-to-back calls on one copy beside it
        copies = [(q, k, v, do)] + [tuple(t.clone() for t in (q, k, v, do))
                                    for _ in range(n_cold(dkv_bytes) - 1)]
        dq_ms = device_ms_cycle([lambda c=c: flash_bwd_dq(*c[:3], mask, c[3], lse, delta, **kw)
                                 for c in copies])
        dkv_ms = device_ms_cycle([lambda c=c: flash_bwd_dkv(*c[:3], mask, c[3], lse, delta, **kw)
                                  for c in copies])
        dq_event = cuda_ms(lambda: flash_bwd_dq(q, k, v, mask, do, lse, delta, **kw))
        dkv_event = cuda_ms(lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta, **kw))
        dq_plain = device_ms_cycle([lambda: flash_bwd_dq(q, k, v, mask, do, lse, delta,
                                                         impl="plain", **kw)], iters=4)
        dkv_plain = device_ms_cycle([lambda: flash_bwd_dkv(q, k, v, mask, do, lse, delta,
                                                           impl="plain", **kw)], iters=4)
        # the yardstick: the backward of one scaled_dot_product_attention call,
        # which gives dq, dk and dv together (one graph per copy)
        plain_causal = causal and pad == 0 and not dead_row and q_off == 0 and Sq == Sk
        bool_mask = None if (plain_causal or (pad == 0 and not causal and not dead_row)) \
            else vis[:, None]
        graphs = []
        for c in copies:
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in c[:3])
            ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bool_mask,
                                                is_causal=plain_causal, enable_gqa=Hq != Hkv)
            graphs.append((ol, (ql, kl, vl), c[3]))
        lib_ms = device_ms_cycle([lambda g=g: torch.autograd.grad(g[0], g[1], g[2],
                                                                  retain_graph=True)
                                  for g in graphs])
        print(f"B2/B3 {name} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} causal={causal} "
              f"q_offset={q_off} pad={pad} dead_row={dead_row}: max|err| dq "
              f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} | device time: B2 kernel "
              f"{dq_ms:.4f} ms (CUDA events {dq_event:.4f} ms), plain {dq_plain:.4f} ms, bound "
              f"{dq_b[0]:.4f} ms ({dq_b[1]}; bytes {dq_bytes_ms:.4f} ms for "
              f"{dq_bytes / 1e6:.2f} MB, operations {dq_ops_ms:.4f} ms for "
              f"{6.0 * D * pairs / 1e9:.3f} GFLOP) | B3 kernel "
              f"{dkv_ms:.4f} ms (CUDA events {dkv_event:.4f} ms), plain {dkv_plain:.4f} ms, "
              f"bound {dkv_b[0]:.4f} ms ({dkv_b[1]}; bytes {dkv_bytes_ms:.4f} ms for "
              f"{dkv_bytes / 1e6:.2f} MB, operations {dkv_ops_ms:.4f} ms for "
              f"{8.0 * D * pairs / 1e9:.3f} GFLOP) | "
              f"sdpa backward (dq, dk and dv in one call) {lib_ms:.4f} ms", flush=True)
        if name == "step":
            record["dq"] = dict(ms=dq_ms, plain_ms=dq_plain, library_ms=lib_ms,
                                bound_ms=dq_b[0], bound_by=dq_b[1], event_ms=dq_event)
            record["dkv"] = dict(ms=dkv_ms, plain_ms=dkv_plain, library_ms=lib_ms,
                                 bound_ms=dkv_b[0], bound_by=dkv_b[1], event_ms=dkv_event)
        del q, k, v, do, o, lse, delta, dq, dk, dv, dq_ref, dk_ref, dv_ref, vis, bool_mask
        del copies, graphs
    return worst, record


# ------------------------------------------------------------- phase 2, Qwen2-VL
# The shapes phase 8 gives the kernels: B1 at head dim 80 (Qwen2-VL-2B's
# tower: 576 patches, 16 heads, no mask; Qwen2.5-VL-3B's windowed blocks: 9
# windows of 64 patches a row folded into the batch, here with ragged right
# padding); the decoder's GQA group 6 (12 q-heads on 2 kv-heads) on the
# one-token kernels (B4, B4q, B6, B6q), the chunk kernels at the verify
# round (B5, B5q, B7, B7q; B 8, C 5) and the backward kernels (B2, B3;
# batch 2 of 512 tokens, causal, left padding).
QWEN_CACHE = (4, 8, 2, 2048, 128)  # L, B, Hkv, Smax, D of the decode cases
QWEN_HQ = 12


def _timed_case(label, kernel_fns, plain_fn, lib_fns, nbytes, flops, extra="",
                peak_flops=PEAK_BF16_FLOPS):
    """Device time of the kernel cycled over ``kernel_fns`` (inputs cycled
    past the L2), of its plain version and of one PyTorch call, beside the
    bound (operations at ``peak_flops``); prints one line and returns the
    numbers."""
    b_ms, b_by = bound(nbytes, flops, peak_flops)
    ms = device_ms_cycle(kernel_fns)
    plain_ms = device_ms_cycle([plain_fn], iters=4)
    lib_ms = device_ms_cycle(lib_fns)
    print(f"{label}: device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB){extra}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def _qwen_b1(dev, gen, worst, record):
    rng = np.random.default_rng(5)
    # name, B (windows folded in), heads, S, ragged right padding
    for name, B, H, S, ragged in (("qwen_tower", 8, 16, 576, False),
                                  ("qwen25_windows", 8 * 9, 16, 64, True)):
        D = 80
        q, k, v = (randn(gen, (B, H, S, D), dev) for _ in range(3))
        mask = None
        if ragged:
            lens = rng.integers(16, S + 1, B)
            lens[::9] = S  # the first window of each row is full
            mask = (torch.arange(S)[None, :] < torch.from_numpy(lens)[:, None]).to(
                dev, torch.int32)
        o = flash_attention_lse(q, k, v, mask)[0]
        torch.cuda.synchronize()
        ref = flash_attention_lse(q, k, v, mask, impl="plain")[0]
        err = (o.float() - ref.float()).abs().max().item()
        if err > KERNEL_TOL:
            raise AssertionError(f"B1 {name}: max |err| {err} (tol {KERNEL_TOL})")
        worst["flash_fwd"] = max(worst["flash_fwd"], err)
        # every query row (the padding rows too) against the valid keys of its row
        pairs = H * S * (B * S if mask is None else int(mask.sum().item()))
        nbytes = 2 * 4 * q.numel() + 4 * B * H * S + (0 if mask is None else 4 * mask.numel())
        copies = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                                for _ in range(n_cold(nbytes) - 1)]
        bool_mask = None if mask is None else mask.bool()[:, None, None, :]
        record["flash_fwd"][name] = dict(max_abs_err=err, **_timed_case(
            f"B1 {name} B{B} H{H} S{S} D{D}{' ragged mask' if ragged else ''}: max|err| "
            f"{err:.3e}", [lambda c=c: flash_attention_lse(*c, mask) for c in copies],
            lambda: flash_attention_lse(q, k, v, mask, impl="plain"),
            [lambda c=c: F.scaled_dot_product_attention(*c, attn_mask=bool_mask)
             for c in copies], nbytes, 4.0 * D * pairs))
        del q, k, v, o, ref, copies


def _bf16_views(cache, L):
    """Each layer's K and V as bf16 [B, Hkv, S, D] (an int8 cache
    dequantized, a paged one gathered): what the SDPA yardstick reads."""
    if "table" in cache:
        return [gather_layer_kv(cache, l, torch.bfloat16) for l in range(L)]
    return [dec_ops.dequant_layer(cache, l, torch.bfloat16) for l in range(L)]


def _qwen_rows(B, S, rng, idle):
    """Ragged decode rows as the engine leaves them (a left-padded prompt
    bucket, then decoded columns); row ``idle`` all invalid."""
    valid = torch.zeros((B, S), dtype=torch.int32)
    for b in range(B):
        if b != idle:
            bucket = int(rng.integers(1, 12)) * 128
            plen = int(rng.integers(1, bucket + 1))
            valid[b, bucket - plen:bucket + int(rng.integers(0, 64))] = 1
    return valid


def _qwen_decode(dev, gen, worst, record):
    L, B, Hkv, S, D = QWEN_CACHE
    Hq, layer, idle = QWEN_HQ, 3, 5
    rng = np.random.default_rng(6)
    valid = _qwen_rows(B, S, rng, idle).to(dev)
    q = randn(gen, (B, Hq, 1, D), dev)
    n_valid = int(valid.sum().item())
    bool_mask = valid.bool()[:, None, None, :]
    for int8 in (False, True):
        dense, pool = _dense_and_paged(dev, gen, rng, L, B, Hkv, S, 128, D, int8)
        per_col = 2 * D + 8 if int8 else 4 * D
        for kname, cache in ((("flash_decode_q8", dense) if int8 else ("flash_decode", dense)),
                             (("paged_decode_q8", pool) if int8 else ("paged_decode", pool))):
            o = decode_attention(q, cache, layer, valid)
            torch.cuda.synchronize()
            ref = decode_attention(q, cache, layer, valid, impl="plain")
            err = (o.float() - ref.float()).abs().max().item()
            if err > KERNEL_TOL or not torch.all(o[idle] == 0):
                raise AssertionError(f"{kname} group 6: max |err| {err} (tol {KERNEL_TOL}) or "
                                     "the idle row not 0")
            if "table" in cache and not torch.equal(o, decode_attention(q, dense, layer, valid)):
                raise AssertionError(f"{kname} group 6: not the dense kernel's output bit for bit")
            worst[kname] = max(worst[kname], err)
            nbytes = (n_valid * Hkv * per_col + 2 * (q.numel() + o.numel()) + 4 * valid.numel()
                      + (4 * pool["table"].numel() if "table" in cache else 0))
            views = _bf16_views(cache, L)
            record[kname]["qwen_group6"] = dict(max_abs_err=err, **_timed_case(
                f"{kname} group 6 (B{B} Hq{Hq} Hkv{Hkv} D{D}, {n_valid} valid columns of "
                f"{B * S}, {decode_plan(B, Hkv, Hq // Hkv, S)}): max|err| {err:.3e}",
                [lambda l=l: decode_attention(q, cache, l, valid) for l in range(L)],
                lambda: decode_attention(q, cache, layer, valid, impl="plain"),
                [lambda c=c: F.scaled_dot_product_attention(q, *c, attn_mask=bool_mask,
                                                            enable_gqa=True) for c in views],
                nbytes, 4.0 * D * n_valid * Hq))
            del views
        del dense, pool


def _qwen_chunk(dev, gen, worst, record):
    L, B, Hkv, S, D = QWEN_CACHE
    Hq, C, layer = QWEN_HQ, 5, 3
    rng = np.random.default_rng(7)
    valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    for b in range(B):
        off = int(rng.integers(200, S - 64))
        valid[b, int(rng.integers(0, 128)):off] = 1
        offset[b] = off
    q = randn(gen, (B, Hq, C, D), dev)
    ar = torch.arange(S, device=dev)[None, None, :]
    vis = valid.bool()[:, None, :] | ((ar >= offset[:, None, None].long()) & (
        ar <= offset[:, None, None].long() + torch.arange(C, device=dev)[None, :, None]))
    pairs = Hq * int(vis.sum().item())
    cols = Hkv * int(vis.any(dim=1).sum().item())
    for int8 in (False, True):
        dense, pool = _dense_and_paged(dev, gen, rng, L, B, Hkv, S, 128, D, int8)
        per_col = 2 * D + 8 if int8 else 4 * D
        for kname, cache in ((("chunk_decode_q8", dense) if int8 else ("chunk_decode", dense)),
                             (("paged_chunk_q8", pool) if int8 else ("paged_chunk", pool))):
            o = chunk_decode_attention(q, cache, layer, valid, offset)
            torch.cuda.synchronize()
            ref = chunk_decode_attention(q, cache, layer, valid, offset, impl="plain")
            err = (o.float() - ref.float()).abs().max().item()
            if err > KERNEL_TOL:
                raise AssertionError(f"{kname} group 6: max |err| {err} (tol {KERNEL_TOL})")
            if "table" in cache and not torch.equal(
                    o, chunk_decode_attention(q, dense, layer, valid, offset)):
                raise AssertionError(f"{kname} group 6: not the dense kernel's output bit for bit")
            worst[kname] = max(worst[kname], err)
            nbytes = (cols * per_col + 2 * (q.numel() + o.numel()) + 4 * (valid.numel() + B)
                      + (4 * pool["table"].numel() if "table" in cache else 0))
            views = _bf16_views(cache, L)
            record[kname]["qwen_group6"] = dict(max_abs_err=err, **_timed_case(
                f"{kname} group 6 verify round (B{B} Hq{Hq} Hkv{Hkv} C{C} D{D})"
                f": max|err| {err:.3e}",
                [lambda l=l: chunk_decode_attention(q, cache, l, valid, offset)
                 for l in range(L)],
                lambda: chunk_decode_attention(q, cache, layer, valid, offset, impl="plain"),
                [lambda c=c: F.scaled_dot_product_attention(q, *c, attn_mask=vis[:, None],
                                                            enable_gqa=True) for c in views],
                nbytes, 4.0 * D * pairs))
            del views
        del dense, pool


def _bwd_case(dev, gen, worst, record, label, key, B, Hq, Hkv, S, D, mask, causal):
    """B2 and B3 at one shape against their plain versions (from the same
    saved o and lse), within ``BWD_REL_TOL`` of the largest entry plus
    ``BWD_ULP`` of each; then their device times beside the bound, the plain
    versions' and SDPA's whole backward (dq, dk and dv in one call) on the
    same inputs, recorded under ``record[kernel][key]``."""
    q, do = randn(gen, (B, Hq, S, D), dev), randn(gen, (B, S, Hq, D), dev).transpose(1, 2)
    k, v = randn(gen, (B, Hkv, S, D), dev), randn(gen, (B, Hkv, S, D), dev)
    kw = dict(causal=causal)
    o, lse = flash_attention_lse(q, k, v, mask, **kw)
    delta = (do.float() * o.float()).sum(-1)
    got = (flash_bwd_dq(q, k, v, mask, do, lse, delta, **kw),
           *flash_bwd_dkv(q, k, v, mask, do, lse, delta, **kw))
    torch.cuda.synchronize()
    want = (flash_bwd_dq(q, k, v, mask, do, lse, delta, impl="plain", **kw),
            *flash_bwd_dkv(q, k, v, mask, do, lse, delta, impl="plain", **kw))
    errs = {}
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        if not torch.isfinite(g).all() or torch.any(err > BWD_REL_TOL * w.abs().max()
                                                    + BWD_ULP * w.abs()):
            raise AssertionError(f"B2/B3 {label}: {gname} max |err| {err.max().item():.4e}")
        errs[gname] = err.max().item()
    worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
    worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"], errs["dv"])
    vis = torch.ones((B, S, S), dtype=torch.bool, device=dev)
    if mask is not None:
        vis &= mask.bool()[:, None, :]
    if causal:
        vis &= torch.arange(S, device=dev)[:, None] >= torch.arange(S, device=dev)[None, :]
    pairs = Hq * int(vis.sum().item())
    small = 4 * (lse.numel() + delta.numel() + (0 if mask is None else mask.numel()))
    copies = [(q, k, v, do)] + [tuple(t.clone() for t in (q, k, v, do))
                                for _ in range(n_cold(2 * 4 * q.numel()) - 1)]
    sdpa_mask = None if mask is None and not causal else vis[:, None]
    graphs = []
    for c in copies:
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in c[:3])
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=sdpa_mask,
                                            enable_gqa=Hq != Hkv)
        graphs.append((ol, (ql, kl, vl), c[3]))
    lib = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True) for g in graphs]
    for kname, fn, nbytes, flops, err in (
            ("flash_bwd_dq", flash_bwd_dq,
             2 * (2 * q.numel() + do.numel() + k.numel() + v.numel()) + small, 6.0 * D * pairs,
             errs["dq"]),
            ("flash_bwd_dkv", flash_bwd_dkv,
             2 * (q.numel() + do.numel() + 2 * (k.numel() + v.numel())) + small,
             8.0 * D * pairs, max(errs["dk"], errs["dv"]))):
        record[kname][key] = dict(max_abs_err=err, **_timed_case(
            f"{kname} {label} (B{B} Hq{Hq} Hkv{Hkv} S{S} D{D}): max|err| {err:.3e}; sdpa is the "
            "whole backward (dq, dk and dv)",
            [lambda c=c, fn=fn: fn(*c[:3], mask, c[3], lse, delta, **kw) for c in copies],
            lambda fn=fn: fn(q, k, v, mask, do, lse, delta, impl="plain", **kw),
            lib, nbytes, flops))
    del copies, graphs


def _qwen_bwd(dev, gen, worst, record):
    """B2 and B3 at Qwen2-VL-2B's decoder (group 6, D 128, causal, left
    padding) and, since its towers train (``freeze_vision_module=false``), at
    D 80: the tower's (2, 16, 576, 80) without a mask and Qwen2.5-VL-3B's
    windows (2 x 9, 16, 64, 80) with ragged right padding."""
    B, S, pad = 2, 512, 37
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    mask[:, :pad] = 0
    _bwd_case(dev, gen, worst, record, f"group 6, causal, left pad {pad}", "qwen_group6", B,
              QWEN_HQ, 2, S, 128, mask, True)
    _bwd_case(dev, gen, worst, record, "Qwen2-VL tower, D 80", "qwen_tower_d80", 2, 16, 16,
              576, 80, None, False)
    W, Lw = 2 * 9, 64
    lens = np.random.default_rng(6).integers(16, Lw + 1, W)
    lens[::9] = Lw  # the first window of each row is full
    wmask = (torch.arange(Lw)[None, :] < torch.from_numpy(lens)[:, None]).to(dev, torch.int32)
    _bwd_case(dev, gen, worst, record, "Qwen2.5-VL windows, D 80, ragged",
              "qwen25_windows_d80", W, 16, 16, Lw, 80, wmask, False)


def check_qwen(dev, gen):
    """Every kernel at the shapes phase 8 (Qwen2-VL-2B, Qwen2.5-VL-3B) gives
    it; returns ({kernel: max error}, {kernel: {case: numbers}})."""
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_decode", "flash_decode_q8",
             "paged_decode", "paged_decode_q8", "chunk_decode", "chunk_decode_q8",
             "paged_chunk", "paged_chunk_q8")
    worst, record = dict.fromkeys(names, 0.0), {n: {} for n in names}
    _qwen_b1(dev, gen, worst, record)
    _qwen_decode(dev, gen, worst, record)
    _qwen_chunk(dev, gen, worst, record)
    _qwen_bwd(dev, gen, worst, record)
    return worst, record


# ------------------------------------------------------------- phase 2, text stack
# The shapes phase 9 (Llama-2-7B, configs/nlp) gives the kernels: B1, B2 and
# B3 at the training batch (4, 32, 500, 128), causal, right-padded with rows
# of 200-500 tokens (500 is no multiple of any tile: the last tile is
# partial under the causal cut), and B1 at the teacher-forced evaluation
# batch (8, 32, 1024, 128), right-padded.  B4 and B5 run there at phase 2's
# own decode and verify shapes (32 heads on 32 kv-heads, D 128, 8 rows).
NLP_TRAIN = (4, 32, 500, 128)  # B, H, S, D
NLP_EVAL = (8, 32, 1024, 128)


def _right_padded(B, S, lo, rng, dev):
    """[B, S] validity of right-padded rows of lo..S tokens (the first full)."""
    lens = rng.integers(lo, S + 1, B)
    lens[0] = S
    return (torch.arange(S)[None, :] < torch.from_numpy(lens)[:, None]).to(dev, torch.int32)


def _causal_pairs(mask):
    """[B, S, S] visible (query, key) pairs: the key valid and not after the
    query (every query row, the padding rows too, as the kernels run them)."""
    S = mask.shape[1]
    ar = torch.arange(S, device=mask.device)
    return mask.bool()[:, None, :] & (ar[:, None] >= ar[None, :])


def _nlp_b1(dev, gen, worst, record):
    rng = np.random.default_rng(8)
    for name, (B, H, S, D), lo in (("train", NLP_TRAIN, 200), ("eval", NLP_EVAL, 60)):
        q, k, v = (randn(gen, (B, H, S, D), dev) for _ in range(3))
        mask = _right_padded(B, S, lo, rng, dev)
        o, lse = flash_attention_lse(q, k, v, mask, causal=True)
        torch.cuda.synchronize()
        ref, lse_ref = flash_attention_lse(q, k, v, mask, causal=True, impl="plain")
        err = (o.float() - ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if err > KERNEL_TOL or lse_err > 1e-3:
            raise AssertionError(f"B1 nlp {name}: max |err| {err} (tol {KERNEL_TOL}), lse "
                                 f"{lse_err}")
        worst["flash_fwd"] = max(worst["flash_fwd"], err)
        vis = _causal_pairs(mask)
        pairs = H * int(vis.sum().item())
        nbytes = 2 * 4 * q.numel() + 4 * (lse.numel() + mask.numel())
        copies = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                                for _ in range(n_cold(nbytes) - 1)]
        record["flash_fwd"][name] = dict(max_abs_err=err, **_timed_case(
            f"B1 nlp {name} B{B} H{H} S{S} D{D} causal, right-padded (rows of "
            f"{int(mask.sum(1).min())}-{S}): max|err| {err:.3e} lse {lse_err:.2e}",
            [lambda c=c: flash_attention_lse(*c, mask, causal=True) for c in copies],
            lambda: flash_attention_lse(q, k, v, mask, causal=True, impl="plain"),
            [lambda c=c: F.scaled_dot_product_attention(*c, attn_mask=vis[:, None])
             for c in copies], nbytes, 4.0 * D * pairs))
        del q, k, v, o, lse, ref, lse_ref, copies, vis


def _nlp_bwd(dev, gen, worst, record):
    B, H, S, D = NLP_TRAIN
    rng = np.random.default_rng(9)
    q, do = randn(gen, (B, H, S, D), dev), randn(gen, (B, S, H, D), dev).transpose(1, 2)
    k, v = randn(gen, (B, H, S, D), dev), randn(gen, (B, H, S, D), dev)
    mask = _right_padded(B, S, 200, rng, dev)
    o, lse = flash_attention_lse(q, k, v, mask, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    got = (flash_bwd_dq(q, k, v, mask, do, lse, delta, causal=True),
           *flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal=True))
    torch.cuda.synchronize()
    want = (flash_bwd_dq(q, k, v, mask, do, lse, delta, causal=True, impl="plain"),
            *flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal=True, impl="plain"))
    errs = {}
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        if not torch.isfinite(g).all() or torch.any(err > BWD_REL_TOL * w.abs().max()
                                                    + BWD_ULP * w.abs()):
            raise AssertionError(f"B2/B3 nlp train: {gname} max |err| {err.max().item():.4e}")
        errs[gname] = err.max().item()
    worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
    worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"], errs["dv"])
    vis = _causal_pairs(mask)
    pairs = H * int(vis.sum().item())
    small = 4 * (lse.numel() + delta.numel() + mask.numel())
    copies = [(q, k, v, do)] + [tuple(t.clone() for t in (q, k, v, do))
                                for _ in range(n_cold(2 * 4 * q.numel()) - 1)]
    graphs = []
    for c in copies:
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in c[:3])
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=vis[:, None])
        graphs.append((ol, (ql, kl, vl), c[3]))
    lib = [lambda g=g: torch.autograd.grad(g[0], g[1], g[2], retain_graph=True) for g in graphs]
    for kname, fn, nbytes, flops, err in (
            ("flash_bwd_dq", flash_bwd_dq,
             2 * (2 * q.numel() + do.numel() + k.numel() + v.numel()) + small, 6.0 * D * pairs,
             errs["dq"]),
            ("flash_bwd_dkv", flash_bwd_dkv,
             2 * (q.numel() + do.numel() + 2 * (k.numel() + v.numel())) + small,
             8.0 * D * pairs, max(errs["dk"], errs["dv"]))):
        record[kname]["train"] = dict(max_abs_err=err, **_timed_case(
            f"{kname} nlp train (B{B} H{H} S{S} D{D} causal, right-padded rows of "
            f"{int(mask.sum(1).min())}-{S}): max|err| {err:.3e}; sdpa is the whole backward "
            f"(dq, dk and dv)",
            [lambda c=c, fn=fn: fn(*c[:3], mask, c[3], lse, delta, causal=True)
             for c in copies],
            lambda fn=fn: fn(q, k, v, mask, do, lse, delta, causal=True, impl="plain"),
            lib, nbytes, flops))
    del copies, graphs


def check_nlp(dev, gen):
    """B1, B2 and B3 at the shapes phase 9 (Llama-2-7B) gives them; returns
    ({kernel: max error}, {kernel: {case: numbers}})."""
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    worst, record = dict.fromkeys(names, 0.0), {n: {} for n in names}
    _nlp_b1(dev, gen, worst, record)
    _nlp_bwd(dev, gen, worst, record)
    return worst, record


ECO_BATCH, ECO_PROMPT, ECO_NEW = 8, 128, 32  # phase 10b's batches: prompt bucket, new tokens


def _eco_rows(rng, dev, extra=0):
    """[B, 128 + extra] validity of ECO's batches: left-padded prompts of
    40-60 tokens in the 128-column bucket, then ``extra`` decoded columns."""
    lens = rng.integers(40, 61, ECO_BATCH)
    cols = torch.arange(ECO_PROMPT + extra)[None, :]
    return ((cols >= ECO_PROMPT - torch.from_numpy(lens)[:, None])).to(dev, torch.int32)


def check_f32(dev, gen):
    """The f32 instances of B1 and of the one-token decode kernel at ECO's
    shapes on Llama-2-7B (phase 10b): the prefill (8, 32, 128, 128) causal
    with left-padded rows, and a decode step halfway through the 32 new
    tokens against an f32 cache [4, 8, 32, 160, 128] with the mask narrowed
    to the 145 columns written.  Returns ({kernel: max error}, {kernel:
    numbers})."""
    rng = np.random.default_rng(10)
    B, H, S, D = ECO_BATCH, 32, ECO_PROMPT, 128
    f32 = lambda shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    worst, record = {}, {}
    # B1 f32: the prefill
    q, k, v = (f32((B, H, S, D)) for _ in range(3))
    mask = _eco_rows(rng, dev)
    before = kernels.LAUNCHES["flash_fwd_f32"]
    o, lse = flash_attention_lse(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["flash_fwd_f32"] != before + 1 or o.dtype != torch.float32:
        raise AssertionError("B1 f32: the f32 instance did not launch")
    ref, lse_ref = flash_attention_lse(q, k, v, mask, causal=True, impl="plain")
    live = lse_ref > -1e29
    err = (o - ref).abs().max().item()
    lse_err = (lse[live] - lse_ref[live]).abs().max().item()
    if err > F32_TOL or lse_err > F32_LSE_TOL or not torch.all(o[~live.expand_as(o)] == 0):
        raise AssertionError(f"B1 f32: max |err| {err} (tol {F32_TOL}), lse {lse_err} (tol "
                             f"{F32_LSE_TOL}) or a dead row not 0")
    worst["flash_fwd_f32"] = err
    vis = _causal_pairs(mask)
    nbytes = 4 * 4 * q.numel() + 4 * (lse.numel() + mask.numel())
    copies = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v)) for _ in range(n_cold(nbytes) - 1)]
    record["flash_fwd_f32"] = dict(max_abs_err=err, **_timed_case(
        f"B1 f32 (ECO's prefill B{B} H{H} S{S} D{D} causal, left-padded rows of "
        f"{int(mask.sum(1).min())}-{int(mask.sum(1).max())}): max|err| {err:.3e} lse "
        f"{lse_err:.2e}; sdpa in f32",
        [lambda c=c: flash_attention_lse(*c, mask, causal=True) for c in copies],
        lambda: flash_attention_lse(q, k, v, mask, causal=True, impl="plain"),
        [lambda c=c: F.scaled_dot_product_attention(*c, attn_mask=vis[:, None]) for c in copies],
        nbytes, 4.0 * D * H * int(vis.sum().item()), peak_flops=PEAK_F32_FLOPS))
    del q, k, v, o, lse, ref, lse_ref, copies, vis
    # B4 f32: decode step 16 of 32 (145 columns written) at layer 3 of 4
    L, smax, step, layer = 4, ECO_PROMPT + ECO_NEW, 16, 3
    cache = {n: f32((L, B, H, smax, D)) for n in ("k", "v")}
    qd = f32((B, H, 1, D))
    valid = _eco_rows(rng, dev, extra=step + 1)
    before = kernels.LAUNCHES["flash_decode_f32"]
    od = decode_attention(qd, cache, layer, valid)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["flash_decode_f32"] != before + 1 or od.dtype != torch.float32:
        raise AssertionError("B4 f32: the f32 instance did not launch")
    ref = decode_attention(qd, cache, layer, valid, impl="plain")
    err = (od - ref).abs().max().item()
    if err > F32_TOL:
        raise AssertionError(f"B4 f32: max |err| {err} (tol {F32_TOL})")
    worst["flash_decode_f32"] = err
    n_valid = int(valid.sum().item())
    nbytes = 2 * n_valid * H * D * 4 + 4 * (qd.numel() + od.numel() + valid.numel())
    cols = valid.shape[1]
    record["flash_decode_f32"] = dict(max_abs_err=err, **_timed_case(
        f"B4 f32 (ECO's decode: cache [{L},{B},{H},{smax},{D}] f32, layer {layer}, mask of "
        f"{cols} columns, {n_valid} valid, {decode_plan(B, H, 1, cols)}): max|err| {err:.3e}; "
        f"sdpa in f32 on the layer's first {cols} columns",
        [lambda l=l: decode_attention(qd, cache, l, valid) for l in range(L)],
        lambda: decode_attention(qd, cache, layer, valid, impl="plain"),
        [lambda l=l: F.scaled_dot_product_attention(
            qd, cache["k"][l][:, :, :cols], cache["v"][l][:, :, :cols],
            attn_mask=valid.bool()[:, None, None, :]) for l in range(L)],
        nbytes, 4.0 * D * n_valid * H, peak_flops=PEAK_F32_FLOPS))
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
    return engine, launches, specs, kern, [r.tokens for r in reqs]


def _device_events(prof):
    """The device kernels (and copies) of a profiled window as (name, ns,
    the id of the host op that launched it), read from the profiler's raw
    events: its own per-event processing (``prof.events()``) took ~6 s per
    40,000 device kernels on the H100's host, ~12 s with host ops.  Device
    events of ``record_function`` ranges are left out: they span the
    range's kernels and would count them twice."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns(), e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
            and not e.is_hidden_event()]


def _in_ranges(prof, ranges):
    """{range: the ids of the host ops run inside a host op or
    ``record_function`` range of that name (on its thread), itself
    included}."""
    from torch.autograd import DeviceType

    host = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0]
    out = {}
    for r in ranges:
        spans: dict[int, list] = {}  # thread -> disjoint (start, end) of the range
        for e in sorted((e for e in host if e.name() == r), key=lambda e: e.start_ns()):
            t = spans.setdefault(e.start_thread_id(), [])
            if t and e.start_ns() <= t[-1][1]:
                t[-1][1] = max(t[-1][1], e.end_ns())
            else:
                t.append([e.start_ns(), e.end_ns()])
        starts = {th: [a for a, _ in t] for th, t in spans.items()}
        out[r] = set()
        for e in host:
            t = spans.get(e.start_thread_id())
            if t:
                i = bisect.bisect_right(starts[e.start_thread_id()], e.start_ns()) - 1
                if i >= 0 and e.start_ns() <= t[i][1]:
                    out[r].add(e.correlation_id())
    return out


def profiled(fn, ranges=()):
    """Run ``fn`` once under torch.profiler; returns (wall ms, device ms,
    device kernels, the kernels taking most device time as text) and, with
    ``ranges``, also {name: device ms of the kernels launched under the host
    ops or ``record_function`` ranges of that name, or, where no host range
    has that name, of the device kernels whose name contains it}."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    # host ops only when a range is asked for (or in a rehearsal without a
    # card)
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if ranges or not torch.cuda.is_available() else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    dev_ms = sum(ns for _, ns, _ in events) / 1e6
    by_name: dict[str, list] = {}
    for name, ns, _ in events:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += ns / 1e6
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    top_txt = "; ".join(f"{name[:70]} x{n}: {ms / max(dev_ms, 1e-9):.3f}"
                        for name, (ms, n) in top)
    if not ranges:
        return wall_ms, dev_ms, len(events), top_txt
    inside = _in_ranges(prof, ranges)
    by_range = {r: sum(ns for _, ns, op in events if op in inside[r]) / 1e6 for r in ranges}
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


def decode_window(engine, label, profile=False, ranges=()):
    """Steady decode with all slots live: ms per decode step (a verify round
    under speculation) and delivered tokens/s over 3 chunks, and
    (optionally) the device's busy share over one more chunk, with the
    device time of the kernels whose names contain one of ``ranges``."""
    rng = np.random.default_rng(1)
    # 1 + 5 chunks of tokens: every slot stays live through the timed and
    # the profiled chunks
    budget = 1 + 5 * engine.chunk
    hi = min(engine.dec_cfg.vocab_size, 30000)  # below LLaVA's image token 32000
    reqs = [engine.submit(rng.integers(3, hi, 100).tolist(), budget)
            for _ in range(engine.B)]
    engine.step()  # prefills every slot and dispatches the first chunk
    torch.cuda.synchronize()
    n0 = sum(len(r.tokens) for r in reqs)
    t0 = time.perf_counter()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = wall * 1e3 / (3 * engine.chunk)
    tok_s = (sum(len(r.tokens) for r in reqs) - n0) / wall
    busy = ""
    if profile:
        wall, dev_ms, n, top, *by_range = profiled(engine.step, ranges=ranges)
        shares = "".join(f"; {r} {ms:.2f} ms ({ms / dev_ms:.3f} of device time)"
                         for r, ms in (by_range[0].items() if by_range else ()))
        busy = (f"; under the profiler one chunk took {wall:.2f} ms wall, {n} device kernels, "
                f"{dev_ms:.2f} ms of device time (busy share {dev_ms / wall:.3f} under the "
                f"profiler, {dev_ms / (step_ms * engine.chunk):.3f} of an unprofiled chunk)"
                f"{shares}; device time by kernel: {top}")
    engine.run()
    for r in reqs:
        if not r.done or not (len(r.tokens) == budget or r.finish_reason == "eos"):
            raise AssertionError(f"decode window: request {r.uid} ended with "
                                 f"{len(r.tokens)}/{budget} tokens ({r.finish_reason!r})")
    print(f"decode window ({label}, {engine.B} live slots): {step_ms:.3f} ms per decode step "
          f"(verify round under speculation), {tok_s:.1f} tok/s delivered{busy}", flush=True)
    engine._state = None  # free its cache
    return step_ms


# ------------------------------------------------------------- phase 3b/3c
SYSTEM_PROMPT = ("You are a careful assistant for a vision-language benchmark. Answer the "
                 "question in one short sentence.")


def _tf_positions(model, ids, n):
    """Teacher-forced positions of prompt ``ids`` and ``n`` generated tokens
    after it: on Qwen2-VL the prompt's M-RoPE positions, then one position
    a token from the prompt's extent, as the engine decodes them (a
    generated token that happens to be the image token is text there, which
    the positions of the whole sequence would not say); None elsewhere."""
    from multimodal_unlearning_tpu_torch.models import qwen2_vl

    if not isinstance(model, qwen2_vl.QwenVL):
        return None
    cfg = model.cfg
    g, ms = cfg.default_grid, cfg.vision.spatial_merge_size
    ids_t = torch.tensor([list(ids)], device=next(model.parameters()).device)
    pos, delta = qwen2_vl.mrope_positions(ids_t, torch.ones_like(ids_t), cfg.image_token_id,
                                          (g[0], g[1] // ms, g[2] // ms))
    tail = len(ids) + delta[0] + torch.arange(n, device=ids_t.device)
    return torch.cat([pos, tail.expand(3, 1, n)], dim=-1)


def first_difference(model, label, got, want, prompts, dtype=torch.bfloat16, extras=None):
    """The two stream sets must agree token for token up to any first
    difference; there the reference path (a teacher-forced forward of
    ``model`` over the prompt and the reference tokens before it, with the
    stream's ``extras`` model arguments: its LoRA adapter) must see its top
    two logits closer than TIE_MARGIN.  Nothing after a first difference is
    compared.  Returns the near-ties found."""
    ties = []
    extras = extras or [{}] * len(got)
    for i, (g, w, (ids, pix), kw) in enumerate(zip(got, want, prompts, extras)):
        n = min(len(g), len(w))
        t = next((j for j in range(n) if g[j] != w[j]), n if len(g) != len(w) else None)
        if t is None:
            continue
        dev = next(model.parameters()).device
        seq = torch.tensor([list(ids) + list(w[:t])], device=dev)
        pv = None if pix is None else torch.from_numpy(np.asarray(pix)[None]).to(dev, dtype)
        with torch.inference_mode():
            logits = model(seq, pixel_values=pv, compute_dtype=dtype, last_logit_only=True,
                           positions=_tf_positions(model, ids, t), **kw)["logits"][0, -1].float()
        top2 = torch.topk(logits, 2).values
        gap = (top2[0] - top2[1]).item()
        if gap >= TIE_MARGIN:
            raise AssertionError(f"{label}: request {i} differs from the reference at token {t} "
                                 f"({g[t] if t < len(g) else 'end'} vs "
                                 f"{w[t] if t < len(w) else 'end'}) where the reference's top "
                                 f"two logits are {gap:.4f} apart (tie margin {TIE_MARGIN})")
        ties.append((i, t, round(gap, 4)))
    return ties


def _serve(engine, jobs, counted=True, extra=None):
    """Submit (ids, max_new, pixels, draft, prefix) jobs (with ``extra``'s
    per-job submit arguments: an adapter, a sampling seed), run to the end;
    returns (requests, wall s, launches, peak GiB) with the launch counts of
    this run alone."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if counted:
        kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(ids, n, pixel_values=pix, draft_ref=d, prefix=pid, **kw)
            for (ids, n, pix, d, pid), kw in zip(jobs, extra or [{}] * len(jobs))]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for r, (ids, n, *_rest) in zip(reqs, jobs):
        if not r.done or not (len(r.tokens) == n or r.finish_reason == "eos"):
            raise AssertionError(f"request {r.uid} ({len(ids)} prompt tokens) ended with "
                                 f"{len(r.tokens)}/{n} tokens ({r.finish_reason!r})")
    return reqs, wall, launches, torch.cuda.max_memory_allocated() / 2**30


def _report(label, engine, reqs, wall, launches, peak):
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = [r.first_t - r.submit_t for r in reqs]
    st = engine.stats()
    print(f"{label}: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.2f} tok/s; TTFT median {statistics.median(ttft):.3f} s max "
          f"{max(ttft):.3f} s; tokens per verify round {st['tokens_per_round']:.3f}; "
          f"prefill chunks {st['prefill_chunks']}; max_memory_allocated {peak:.2f} GiB; "
          f"launches {launches}", flush=True)


SERVE_ARGS = ["model_family=llava", "num_slots=8", "max_length=2048", "chunk=16",
              "dtype=bfloat16", "seed=0"]


def spec_jobs(engine, specs, processor):
    """The system prompt registered as a prefix of ``engine``; returns the
    jobs of the speculative workload (drafts on half the requests, text
    requests behind the prefix on every other request, the others whole)
    and the same requests as full prompts without drafts."""
    tok = processor.tokenizer
    system = tok.encode(SYSTEM_PROMPT, add_special_tokens=True)
    pid = engine.register_prefix(system)
    jobs, full = [], []
    for i, (ids, n, pix) in enumerate(specs):
        draft = list(ids[-engine.R:]) if i % 2 == 0 else None  # draft text on half
        if pix is not None:  # image prompts prefill whole, as the CLI does
            jobs.append((ids, n, pix, draft, None))
            full.append((ids, n, pix, None, None))
        elif i % 2 == 0:     # behind the prefix: only the suffix is prefilled
            jobs.append((ids, n, None, draft, pid))
            full.append((system + ids, n, None, None, None))
        else:                # whole, chunked when longer than 512 tokens
            jobs.append((system + ids, n, None, draft, None))
            full.append((system + ids, n, None, None, None))
    return jobs, full


def run_spec_path(model, specs, processor, base=SERVE_ARGS):
    """bf16 serving with speculation (K 4), chunked prefill (512) and a
    registered system prompt, through cli/serve's build_engine, against the
    full prompts through the plain engine."""
    cfg = serve.load_config(base + ["quantize_base=false", "speculative_k=4",
                                    "prefill_chunk=512"])
    engine, _, _, _ = serve.build_engine(cfg, model=model)
    jobs, full = spec_jobs(engine, specs, processor)
    _serve(engine, jobs[:2], counted=False)  # warm-up
    reqs, wall, launches, peak = _serve(engine, jobs)
    _report("speculative + chunked + prefix path (bf16, K=4, chunk 512)", engine, reqs, wall,
            launches, peak)
    for name in ("flash_fwd", "chunk_decode"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the speculative path")
    if engine.stats()["prefill_chunks"] == 0:
        raise AssertionError("no prompt went through chunked prefill")
    spec_engine = engine
    engine._state = None
    plain = ServingEngine(model, spec_engine.model_cfg, "llava", num_slots=spec_engine.B,
                          max_len=spec_engine.smax, chunk=spec_engine.chunk,
                          bucket_multiple=spec_engine.bucket_multiple,
                          pad_token_id=spec_engine.pad_id, eos_token_id=spec_engine.eos,
                          cache_dtype=spec_engine.compute_dtype,
                          compute_dtype=spec_engine.compute_dtype, device=spec_engine.device)
    want, *_ = _serve(plain, full, counted=False)
    plain._state = None
    ties = first_difference(model, "speculative path", [r.tokens for r in reqs],
                            [r.tokens for r in want], [(ids, pix) for ids, _, pix, *_ in full],
                            spec_engine.compute_dtype)
    print(f"speculative path vs the plain engine on the full prompts: streams agree up to "
          f"first differences at near-ties {ties} (request, token, reference top-2 gap; "
          f"tie margin {TIE_MARGIN})", flush=True)
    return spec_engine, launches, [r.tokens for r in reqs]


def run_int8_path(model, specs, bf16_logits, base=SERVE_ARGS):
    """The serve config as it ships (int8 decoder, W8A16) with the int8 KV
    cache, through cli/serve's build_engine, which quantizes ``model`` in
    place; then speculation (K 4) on the same quantized model, held against
    the plain int8 run."""
    logits = {}
    cfg = serve.load_config(base + ["quantize_base=true", "kv_cache_dtype=int8"])
    engine, _, _, _ = serve.build_engine(
        cfg, model=model, on_prefill=lambda r, last: logits.__setitem__(r.uid, last.float().cpu()))
    jobs = [(ids, n, pix, None, None) for ids, n, pix in specs]
    _serve(engine, [(ids, 2, pix, None, None) for ids, _, pix in (specs[0], specs[-2])],
           counted=False)  # warm-up
    reqs, wall, launches, peak = _serve(engine, jobs)
    _report("int8 path (quantize_base=true, kv_cache_dtype=int8)", engine, reqs, wall,
            launches, peak)
    if launches["flash_decode_q8"] == 0 or launches["flash_decode"] != 0:
        raise AssertionError(f"the int8 path must decode through B4q alone: {launches}")
    d = [(logits[r.uid] - b).abs().max().item() for r, b in zip(reqs, bf16_logits)]
    if not all(torch.isfinite(logits[r.uid]).all() for r in reqs):
        raise AssertionError("int8 path: prefill logits not finite")
    print(f"int8 path prefill logits vs the bf16 run, max|diff| per request (a finding, not a "
          f"gate): {[round(x, 4) for x in d]}", flush=True)
    engine._state = None

    spec_cfg = Config(dict(cfg, speculative_k=4))
    spec, _, _, _ = serve.build_engine(spec_cfg, model=model)
    _serve(spec, [(ids, 2, pix, None, None) for ids, _, pix in (specs[0], specs[-2])],
           counted=False)
    sreqs, swall, slaunches, speak = _serve(spec, jobs)
    _report("int8 path with speculation (K=4)", spec, sreqs, swall, slaunches, speak)
    if slaunches["chunk_decode_q8"] == 0:
        raise AssertionError(f"B5q never launched on the int8 speculative path: {slaunches}")
    ties = first_difference(model, "int8 speculative path", [r.tokens for r in sreqs],
                            [r.tokens for r in reqs], [(ids, pix) for ids, _, pix in specs],
                            spec.compute_dtype)
    print(f"int8 speculative path vs the plain int8 run: streams agree up to first "
          f"differences at near-ties {ties} (tie margin {TIE_MARGIN})", flush=True)
    spec._state = None
    return engine, spec, launches, slaunches, ([r.tokens for r in reqs],
                                               [r.tokens for r in sreqs])


# ------------------------------------------------------------- phase 3f
@contextlib.contextmanager
def b8_rows():
    """Counts the rows M of every W4A16 product that ``utils/quantize``
    hands to ``grouped_int4_matmul`` (B8, or its plain version under
    ``use_plain``) while the block runs."""
    seen = collections.Counter()
    orig = quantize.grouped_int4_matmul

    def spy(x, *args, **kw):
        seen[x.shape[0]] += 1
        return orig(x, *args, **kw)

    quantize.grouped_int4_matmul = spy
    try:
        yield seen
    finally:
        quantize.grouped_int4_matmul = orig


def run_int4_path(model, specs, bf16_logits, base=SERVE_ARGS):
    """The serve config with ``quantize_base=int4`` (grouped int4, W4A16
    through B8) on a second init of the bf16 model from the same seed, the
    bf16 model parked on the host meanwhile so that the int4 runs' peak
    memory is their own: (i) plain decode with the bf16 cache, held against
    the same model on B8's plain version; (ii) speculation (K 4) with
    chunked prefill (512), held against (i).  Returns the B8 launches of
    (i) and (ii) and the rows of (i)'s products."""
    dev = next(model.parameters()).device
    model.to("cpu")
    torch.cuda.empty_cache()
    try:
        return _int4_path(model, specs, bf16_logits, base)
    finally:
        model.to(dev)
        torch.cuda.empty_cache()


def _check_dequant(label, want_rows):
    """The dequant path ran exactly for the prompt buckets of ``want_rows``
    (rows above ``INT4_MAX_KERNEL_ROWS``) and for nothing else."""
    got = {m for m, _, _ in quantize.INT4_DEQUANT_CALLS}
    if got != want_rows or any(m <= quantize.INT4_MAX_KERNEL_ROWS for m in got):
        raise AssertionError(f"{label}: the dequant path ran at rows {sorted(got)}, expected "
                             f"{sorted(want_rows)} (B8 takes up to "
                             f"{quantize.INT4_MAX_KERNEL_ROWS} rows)")


def _int4_path(bf16_model, specs, bf16_logits, base):
    logits = {}
    cfg = serve.load_config(base + ["quantize_base=int4"])
    t0 = time.perf_counter()
    engine, _, _, _ = serve.build_engine(
        cfg, on_prefill=lambda r, last: logits.__setitem__(r.uid, last.float().cpu()))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = engine.params
    if not torch.equal(model.projector.fc1.cpu(), bf16_model.projector.fc1):
        raise AssertionError("the int4 model was not drawn from the bf16 model's seed")
    tower = model.language_model
    n4 = sum(isinstance(m, quantize.QTensor4) for m in tower.modules())
    wbytes = quantize.tree_nbytes(tower)
    bf16_bytes = quantize.tree_nbytes(bf16_model.language_model)
    long_buckets = {-(-len(ids) // engine.bucket_multiple) * engine.bucket_multiple
                    for ids, _, _ in specs} - set(range(quantize.INT4_MAX_KERNEL_ROWS + 1))
    jobs = [(ids, n, pix, None, None) for ids, n, pix in specs]
    warm = [(ids, 2, pix, None, None) for ids, _, pix in (specs[0], specs[-2])]
    prompts = [(ids, pix) for ids, _, pix in specs]
    _serve(engine, warm, counted=False)
    quantize.INT4_DEQUANT_CALLS.clear()
    with b8_rows() as rows:
        reqs, wall, launches, peak = _serve(engine, jobs)
    label = "int4 path (i) (quantize_base=int4, bf16 cache)"
    _report(label, engine, reqs, wall, launches, peak)
    print(f"{label}: {n4} int4 leaves, decoder weights {wbytes / 2**30:.3f} GiB (bf16 "
          f"{bf16_bytes / 2**30:.3f} GiB), init + quantize {build_s:.1f} s; B8 launches "
          f"{launches['int4_matmul']}, rows per product {dict(sorted(rows.items()))}; dequant "
          f"path {dict(quantize.INT4_DEQUANT_CALLS)}", flush=True)
    if launches["int4_matmul"] == 0 or any(m > quantize.INT4_MAX_KERNEL_ROWS for m in rows):
        raise AssertionError(f"{label}: B8 launches {launches['int4_matmul']}, rows {rows}")
    products = sum(n for m, n in rows.items() if m > 0)  # an empty product launches nothing
    if launches["int4_matmul"] != products:  # one launch per product, its splits folded in it
        raise AssertionError(f"{label}: {launches['int4_matmul']} B8 launches for {products} "
                             "products")
    _check_dequant(label, long_buckets)
    if not all(torch.isfinite(logits[r.uid]).all() for r in reqs):
        raise AssertionError(f"{label}: prefill logits not finite")
    d = [(logits[r.uid] - b).abs().max().item() for r, b in zip(reqs, bf16_logits)]
    print(f"{label}: prefill logits vs the bf16 run, max|diff| per request (a finding, not a "
          f"gate: int4 rounding of random weights): {[round(x, 4) for x in d]}", flush=True)
    engine._state = None

    # the same model and requests on B8's plain version (a module global
    # read at each call), and the first differences judged on that path
    prev = b8.use_plain(True)
    try:
        plain, _, _, _ = serve.build_engine(cfg, model=model)  # quantized: passes through
        preqs, pwall, plaunches, _ = _serve(plain, jobs)
        plain._state = None
        if plaunches["int4_matmul"] != 0:
            raise AssertionError(f"B8 launched on its plain version's run: {plaunches}")
        ties = first_difference(model, f"{label} vs plain B8", [r.tokens for r in reqs],
                                [r.tokens for r in preqs], prompts)
    finally:
        b8.use_plain(prev)
    print(f"{label} vs the same model on B8's plain version ({pwall:.3f} s): streams agree up "
          f"to first differences at near-ties {ties} (tie margin {TIE_MARGIN})", flush=True)
    decode_window(engine, "int4 weights, bf16 cache", profile=True, ranges=("int4_matmul",))

    scfg = Config(dict(cfg, speculative_k=4, prefill_chunk=512))
    spec, _, _, _ = serve.build_engine(scfg, model=model)
    sjobs = [(ids, n, pix, list(ids[-spec.R:]) if i % 2 == 0 else None, None)
             for i, (ids, n, pix) in enumerate(specs)]
    _serve(spec, warm, counted=False)
    quantize.INT4_DEQUANT_CALLS.clear()
    with b8_rows() as srows:
        sreqs, swall, slaunches, speak = _serve(spec, sjobs)
    slabel = "int4 path (ii) with speculation (K=4) + chunked prefill (512)"
    _report(slabel, spec, sreqs, swall, slaunches, speak)
    print(f"{slabel}: B8 launches {slaunches['int4_matmul']}, rows per product "
          f"{dict(sorted(srows.items()))}", flush=True)
    verify_rows = spec.B * (spec.K + 1)
    if slaunches["int4_matmul"] == 0 or not {verify_rows, 512} <= set(srows):
        raise AssertionError(f"{slabel}: B8 must run at M = {verify_rows} (verify) and 512 "
                             f"(chunks): {slaunches['int4_matmul']} launches, rows {srows}")
    sproducts = sum(n for m, n in srows.items() if m > 0)
    if slaunches["int4_matmul"] != sproducts:
        raise AssertionError(f"{slabel}: {slaunches['int4_matmul']} B8 launches for {sproducts} "
                             "products")
    _check_dequant(slabel, set())
    if spec.stats()["prefill_chunks"] == 0:
        raise AssertionError(f"{slabel}: no prompt went through chunked prefill")
    ties = first_difference(model, slabel, [r.tokens for r in sreqs], [r.tokens for r in reqs],
                            prompts)
    print(f"{slabel} vs (i): streams agree up to first differences at near-ties {ties} (tie "
          f"margin {TIE_MARGIN})", flush=True)
    decode_window(spec, "int4 weights, speculation K=4")
    return launches["int4_matmul"], slaunches["int4_matmul"], dict(rows)


# ------------------------------------------------------------- phase 3d/3e
# paged runs: pages of 128 columns; (i) a pool of 25 pages (24 usable; the
# largest request of (i) needs 12) with budgets PAGED_EXTRA tokens longer
# than the dense run's, so that slots outgrow the pages reserved at
# admission and the pool must preempt; paged60: the pool at 60% of the
# dense layout's 8 x 16 pages, as the JAX package's serving benchmark runs it
PAGE = 128
TIGHT_POOL = 25
PAGED_EXTRA = 96
PAGED60_POOL = int(0.6 * 8 * (2048 // PAGE)) + 1


def _paged_report(label, engine, reqs, wall, launches, peak, preempt0=0):
    _report(label, engine, reqs, wall, launches, peak)
    st = engine.stats()
    pool_gib = sum(t.numel() * t.element_size() for t in engine._state["cache"].values()) / 2**30
    print(f"{label}: pool {st['pool_pages']} usable pages of {PAGE} columns ({pool_gib:.2f} GiB "
          f"with the trash page and int8 scales), peak pages in use {st['pool_pages_peak']}, "
          f"preemptions {st['preemptions'] - preempt0}, block-table uploads "
          f"{st['table_uploads']}", flush=True)


def _check_paged_launches(label, launches, want, zero):
    if any(launches[n] == 0 for n in want) or any(launches[n] != 0 for n in zero):
        raise AssertionError(f"{label}: {want} must launch and {zero} must not: {launches}")


def run_paged_path(model, specs, processor, dense, spec_dense, base=SERVE_ARGS):
    """bf16 serving on a paged cache: (i) plain decode on a tight pool
    (admission queues, a slot is preempted), against the dense bf16 run's
    streams; (ii) paged60 with speculation, chunked prefill and the system
    prompt, against the dense speculative run's.  Each with a decode
    window under the profiler."""
    cfg = serve.load_config(base + ["quantize_base=false", f"page_size={PAGE}",
                                    f"kv_pool_pages={TIGHT_POOL}"])
    engine, _, _, _ = serve.build_engine(cfg, model=model)
    jobs = [(ids, n + PAGED_EXTRA, pix, None, None) for ids, n, pix in specs]
    _serve(engine, [(ids, 2, pix, None, None) for ids, _, pix in (specs[0], specs[-2])],
           counted=False)  # warm-up
    p0 = engine.stats()["preemptions"]
    reqs, wall, launches, peak = _serve(engine, jobs)
    label = f"paged bf16 (i), {TIGHT_POOL}-page pool, budgets +{PAGED_EXTRA}"
    _paged_report(label, engine, reqs, wall, launches, peak, p0)
    _check_paged_launches(label, launches, ("paged_decode", "flash_fwd"),
                          ("flash_decode", "chunk_decode"))
    counts = {"paged_decode": launches["paged_decode"]}
    if engine.stats()["preemptions"] - p0 < 1:
        raise AssertionError(f"{label}: the pool preempted no slot")
    prompts = [(ids, pix) for ids, _, pix in specs]
    ties = first_difference(model, label, [r.tokens[:n] for r, (_, n, _) in zip(reqs, specs)],
                            dense, prompts)
    print(f"{label} vs the dense bf16 run (its first tokens of each stream): streams agree up "
          f"to first differences at near-ties {ties} (tie margin {TIE_MARGIN})", flush=True)
    decode_window(engine, f"paged bf16, page {PAGE}, {TIGHT_POOL}-page pool", profile=True)
    del engine
    torch.cuda.empty_cache()

    cfg = serve.load_config(base + ["quantize_base=false", "speculative_k=4",
                                    "prefill_chunk=512", f"page_size={PAGE}",
                                    f"kv_pool_pages={PAGED60_POOL}"])
    engine, _, _, _ = serve.build_engine(cfg, model=model)
    jobs, full = spec_jobs(engine, specs, processor)
    _serve(engine, jobs[:2], counted=False)  # warm-up
    p0 = engine.stats()["preemptions"]
    reqs, wall, launches, peak = _serve(engine, jobs)
    label = "paged60 bf16 (ii), speculation K=4 + chunked prefill 512 + system prompt"
    _paged_report(label, engine, reqs, wall, launches, peak, p0)
    _check_paged_launches(label, launches, ("paged_chunk", "flash_fwd"),
                          ("flash_decode", "chunk_decode"))
    if engine.stats()["prefill_chunks"] == 0:
        raise AssertionError(f"{label}: no prompt went through chunked prefill")
    ties = first_difference(model, label, [r.tokens for r in reqs], spec_dense,
                            [(ids, pix) for ids, _, pix, *_ in full])
    print(f"{label} vs the dense speculative run: streams agree up to first differences at "
          f"near-ties {ties} (tie margin {TIE_MARGIN})", flush=True)
    counts["paged_chunk"] = launches["paged_chunk"]
    decode_window(engine, "paged60 bf16, speculation K=4", profile=True)
    return counts


def run_paged_int8_path(model, specs, dense8, spec8, base=SERVE_ARGS):
    """The quantized model with the int8 cache on a paged60 pool, plain and
    with speculation (K 4), against the dense int8 runs' streams."""
    cfg = serve.load_config(base + ["quantize_base=true", "kv_cache_dtype=int8",
                                    f"page_size={PAGE}", f"kv_pool_pages={PAGED60_POOL}"])
    jobs = [(ids, n, pix, None, None) for ids, n, pix in specs]
    prompts = [(ids, pix) for ids, _, pix in specs]
    out = {}
    for label, extra, want, zero, ref in (
            ("paged60 int8 (quantize_base=true, kv_cache_dtype=int8)", {},
             ("paged_decode_q8",), ("flash_decode_q8", "flash_decode", "chunk_decode_q8"),
             dense8),
            ("paged60 int8 with speculation (K=4)", {"speculative_k": 4},
             ("paged_chunk_q8",), ("flash_decode_q8", "chunk_decode_q8"), spec8)):
        engine, _, _, _ = serve.build_engine(Config(dict(cfg, **extra)), model=model)
        _serve(engine, [(ids, 2, pix, None, None) for ids, _, pix in (specs[0], specs[-2])],
               counted=False)  # warm-up
        reqs, wall, launches, peak = _serve(engine, jobs)
        _paged_report(label, engine, reqs, wall, launches, peak)
        _check_paged_launches(label, launches, want, zero)
        ties = first_difference(model, label, [r.tokens for r in reqs], ref, prompts)
        print(f"{label} vs the dense int8 run: streams agree up to first differences at "
              f"near-ties {ties} (tie margin {TIE_MARGIN})", flush=True)
        engine._state = None
        out[want[0]] = launches[want[0]]
        del engine
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 4
def _cos(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return (torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-30)).item()


def run_forget_path(model, timed_steps=4):
    """Forget steps on ``model`` (LLaVA-1.5-7B from the seed at full depth
    when None; quantized here) through the port's bench set-up, then 4b, the
    dots remat policies; returns the launch counts of the timed steps and
    4b's numbers."""
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
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"flash_fwd": timed_steps * 2 * (dec.num_layers + vis.num_layers),
                   "flash_bwd_dq": timed_steps * 2 * dec.num_layers,
                   "flash_bwd_dkv": timed_steps * 2 * dec.num_layers})
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
    dots = _dots_policies(grad_of, b.make_step)

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
    return launches, dots


def _dots_policies(grad_of, make_step):
    """4b: the same micro-batch and state under ``remat_policy`` null,
    ``dots`` and ``dots_no_batch``: each dots policy's loss within
    ``STEP_LOSS_TOL`` of null's and every LoRA gradient leaf at cosine
    ``STEP_GRAD_COS`` or more (the values are the same up to the order of
    the W8A8 rescales; only memory changes); each policy's peak and wall
    time of one gradient printed."""
    ref, numbers = None, {}
    for policy in (None, "dots", "dots_no_batch"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (loss, m), g = grad_of(make_step(remat_policy=policy))
        torch.cuda.synchronize()
        numbers[str(policy)] = dict(ms=round((time.perf_counter() - t0) * 1e3, 1),
                                    peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
                                    loss=round(float(loss), 5))
        if ref is None:
            ref = (float(loss), g)
            continue
        cos = _grad_cosines(g, ref[1])  # the a leaves: 0 while b is 0
        worst = min(cos, key=cos.get)
        numbers[policy]["min_cos"] = round(cos[worst], 5)
        if abs(float(loss) - ref[0]) > STEP_LOSS_TOL or cos[worst] < STEP_GRAD_COS:
            raise AssertionError(f"4b remat_policy {policy}: loss {float(loss)} against null's "
                                 f"{ref[0]}, cosine {cos[worst]} at {worst}")
        del g
    print(f"4b remat policies at this operating point, one micro-batch's gradient each (ms, "
          f"peak GiB, loss, min LoRA-gradient cosine against null): {json.dumps(numbers)} "
          f"(tol {STEP_LOSS_TOL}, {STEP_GRAD_COS})", flush=True)
    return numbers


# Phase 3 serves LLaVA-1.5-7B at full width with its decoder cut to
# LLAVA_SERVE_DEPTH of its 32 layers, so that the script with this slice's
# training sub-phases stays within its time limit; phase 4's forget step
# runs at full depth on a model of its own
LLAVA_SERVE_DEPTH = 16


# ------------------------------------------------------------- phases 5-7
# Phases 5-7 drive LLaVA-1.5-7B through the CLIs at full width with its
# decoder cut to LLAVA_CLI_DEPTH of its 32 layers (the vision tower whole),
# so that the whole script, phases 8 and 9 at full depth included, stays
# within its time limit
LLAVA_CLI_DEPTH = 8


@contextlib.contextmanager
def cut_depth(family, layers):
    """While active, the registry's ``family`` has ``layers`` decoder layers
    (every CLI reads the registry when it builds its model)."""
    from multimodal_unlearning_tpu_torch.config import registry

    # through Config's accessors: each wraps a nested dict once and stores the
    # wrapper back, and a dict taken from under it would be replaced by a copy
    # at the first access inside this block
    arch = registry.PRESETS[family]["arch"]
    dec = arch if isinstance(arch["decoder"], str) else arch["decoder"]  # a text family's arch
    full = dec["num_layers"]
    dec["num_layers"] = layers
    try:
        yield full
    finally:
        dec["num_layers"] = full


# ------------------------------------------------------------- phase 5
# the forget CLI as a user runs it: LLaVA-1.5-7B at full width (decoder cut
# to LLAVA_CLI_DEPTH layers) from the seed, synthetic CLEAR data (16 forget rows, half with a 336-px image),
# bench.py's operating point (int8 base, W8A8 + int8 dx, LoRA r 8, remat
# save_attn), 4 steps an epoch for 1.5 epochs (a train-state save at step 4),
# then the merged model saved in bf16 and served again from the saved files
FORGET_CLI_ARGS = [
    "model_family=llava", "model_path=null",
    "forget_data_path=synthetic:n_persons=20,qa_per_person=4",
    "retain_data_path=synthetic:n_persons=20,qa_per_person=4",
    "forget_split=forget10+tofu", "retain_split=retain90+tofu",
    "forget_loss=grad_diff_forget_ce_retain_ce", "LoRA.r=8", "LoRA.alpha=32",
    "quantize_base=true", "int8_compute=true", "int8_bwd=true", "remat=true",
    "remat_policy=save_attn", "batch_size=2", "gradient_accumulation_steps=2",
    "num_epochs=1.5", "merge_dtype=bfloat16", "save_model=true", "+save_adapters=true",
]


def _timed(owner, name, seconds):
    """Wrap ``owner.name`` so that each call adds its wall time to
    ``seconds[name]``; returns the original."""
    fn = getattr(owner, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    setattr(owner, name, wrapper)
    return fn


def run_forget_cli_path(specs, args=FORGET_CLI_ARGS, serve_base=SERVE_ARGS, picks=(0, 3, 8, 9)):
    """``cli.mm_forget.main`` on the card from config file to saved model,
    then ``cli.serve.build_engine(model_path=...)`` on what it saved, serving
    four of phase 3's requests (``picks``).  Returns the launch counts of the
    forget run and of the served requests."""
    import resource
    import shutil
    import tempfile

    import safetensors
    import yaml
    from safetensors import safe_open

    from multimodal_unlearning_tpu_torch.cli import mm_forget
    from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
    from multimodal_unlearning_tpu_torch.models import hf_bridge, llava, lora
    from multimodal_unlearning_tpu_torch.utils import native

    save_dir = tempfile.mkdtemp(prefix="forget_cli_")
    seconds: dict = {}
    load_peak: dict = {}
    load = serve.init_or_load_params

    def load_and_peak(*a, **kw):
        out = load(*a, **kw)
        torch.cuda.synchronize()
        load_peak["bytes"] = torch.cuda.max_memory_allocated()
        return out

    saved = [(common, "save_model", _timed(common, "save_model", seconds)),
             (lora, "merge_model", _timed(lora, "merge_model", seconds)),
             (serve, "init_or_load_params", load)]
    serve.init_or_load_params = load_and_peak
    try:
        print(f"forget CLI: native host library live: {native.available()}; safetensors "
              f"{safetensors.__version__}, PyYAML {yaml.__version__}; free disk at "
              f"{save_dir}: {shutil.disk_usage(save_dir).free / 2**30:.1f} GiB", flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        history = mm_forget.main(args + [f"save_dir={save_dir}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in history]
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"forget CLI: non-finite losses {losses}")
        if losses[0] == losses[-1]:
            raise AssertionError(f"forget CLI: the loss did not move: {losses}")
        arg = lambda key: next(a.split("=", 1)[1] for a in args if a.startswith(key + "="))
        mcfg = common.build_model_config(get_model_identifiers(arg("model_family")))
        steps = len(history)
        dec, vis = mcfg.decoder, mcfg.vision
        accum = int(arg("gradient_accumulation_steps"))
        # per step and micro-batch: two splits, each through the ViT (pixel
        # rows of zeros for text samples) and the decoder; B1 forward only
        # (save_attn keeps o and lse), B2 and B3 once per decoder layer
        expect = dict.fromkeys(kernels.LAUNCHES, 0)
        expect.update({"flash_fwd": steps * accum * 2 * (dec.num_layers + vis.num_layers),
                       "flash_bwd_dq": steps * accum * 2 * dec.num_layers,
                       "flash_bwd_dkv": steps * accum * 2 * dec.num_layers})
        if launches != expect:
            raise AssertionError(f"forget CLI launches {launches}, expected {expect}")
        path = f"{save_dir}/model.safetensors"
        meta = llava.Llava(mcfg, device="meta", dtype=torch.bfloat16)
        names = set(hf_bridge.llava_to_hf(common.model_tree(meta), vis.patch_size))
        with safe_open(path, framework="pt") as f:
            got = set(f.keys())
            dtypes = {f.get_tensor(k).dtype for k in got}
        if got != names or dtypes != {torch.bfloat16}:
            raise AssertionError(f"saved model: {len(got ^ names)} names differ from "
                                 f"llava_to_hf's, dtypes {dtypes}")
        size = os.path.getsize(path)
        print(f"forget CLI: {steps} steps, losses {[round(x, 4) for x in losses]}; "
              f"{wall:.1f} s in main() (init, quantize, steps, merge, save); merge "
              f"{seconds['merge_model']:.1f} s, save {seconds['save_model']:.1f} s of "
              f"{size / 1e9:.2f} GB ({size / 1e9 / seconds['save_model']:.2f} GB/s), "
              f"{len(got)} tensors, bf16; max_memory_allocated {peak:.2f} GiB; launches "
              f"{launches} ({launches['flash_fwd'] // steps} B1, "
              f"{launches['flash_bwd_dq'] // steps} B2, {launches['flash_bwd_dkv'] // steps} "
              f"B3 per step); host peak RSS so far "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB", flush=True)
        del meta
        torch.cuda.empty_cache()

        # served again from the saved files; the load alone may hold the
        # weights once, plus one tensor in flight
        logits = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine, _, _, _ = serve.build_engine(
            serve.load_config(serve_base + ["quantize_base=false", f"model_path={save_dir}"]),
            on_prefill=lambda r, last: logits.__setitem__(r.uid, last.float().cpu()))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        held = load_peak["bytes"] - before
        print(f"reload: build_engine(model_path=...) {load_s:.1f} s "
              f"({size / 1e9 / load_s:.2f} GB/s); the load's device peak above what was "
              f"allocated before it {held / 2**30:.2f} GiB for a {size / 2**30:.2f} GiB file",
              flush=True)
        if held > size + 2**29:
            raise AssertionError(f"reload held {held / 2**30:.2f} GiB on the card for a "
                                 f"{size / 2**30:.2f} GiB checkpoint: a second copy")
        chosen = [specs[i] for i in picks]
        reqs, swall, slaunch, speak = _serve(engine, [(ids, n, pix, None, None)
                                                      for ids, n, pix in chosen])
        for name in ("flash_fwd", "flash_decode"):
            if slaunch[name] == 0:
                raise AssertionError(f"reloaded model: kernel {name} never launched")
        engine._state = None
        plain = prefill_logits_of(engine, engine.params, "plain", engine.compute_dtype, chosen)
        diffs = [(logits[r.uid] - p).abs().max().item() for r, p in zip(reqs, plain)]
        if max(diffs) > LOGIT_TOL or not all(torch.isfinite(logits[r.uid]).all() for r in reqs):
            raise AssertionError(f"reloaded model: prefill logits kernel-plain {diffs} "
                                 f"(tol {LOGIT_TOL})")
        _report("reloaded model, served", engine, reqs, swall, slaunch, speak)
        print(f"reloaded model: prefill logits kernel-plain max|diff| "
              f"{[round(x, 4) for x in diffs]} (tol {LOGIT_TOL})", flush=True)
        del engine
        return launches, slaunch
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        shutil.rmtree(save_dir, ignore_errors=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 6
# CLEAR's recipe through the CLIs a user calls, LLaVA-1.5-7B at full width
# (decoder cut to LLAVA_CLI_DEPTH layers) from seed 42: finetune (LoRA r 8 over the bf16 base, merged bf16
# save), then forget from that checkpoint at LoRA.r=0 (the model's own
# parameters in place, the vision tower frozen) with NPO, adamw_q8 and a bf16
# teacher, then one step of each other loss on what that run leaves on the card
RECIPE_DATA = "synthetic:n_persons=20,qa_per_person=4"
FINETUNE_CLI_ARGS = [
    "model_family=llava", "+model_path=null", f"data_path={RECIPE_DATA}", "split=full+tofu",
    "LoRA.r=8", "LoRA.alpha=32", "batch_size=2", "gradient_accumulation_steps=1",
    "remat=true", "remat_policy=save_attn", "merge_dtype=bfloat16",
    "num_epochs=0.04",  # 160 rows, 2 a step: 3 steps, no train-state save
]
R0_FORGET_CLI_ARGS = [
    "model_family=llava", f"forget_data_path={RECIPE_DATA}", f"retain_data_path={RECIPE_DATA}",
    "forget_split=forget10+tofu", "retain_split=retain90+tofu", "LoRA.r=0", "forget_loss=npo",
    "optimizer=adamw_q8", "quantize_teacher=false", "batch_size=2",
    "gradient_accumulation_steps=1", "remat=true", "remat_policy=save_attn",
    "save_model=false",
    # bf16 weights of std ~0.016 sit 6e-5 apart: the warmup's second step at
    # the config's lr (1e-5 / 8) would round away on ~99% of the entries
    "lr=1e-4",
    "num_epochs=0.4",  # 16 forget rows, 2 a step: 3 steps, no train-state save
]
OTHER_LOSSES = ("scrub", "KL", "llmu", "rmu", "dpo", "sku", "idk", "eco_ft")
# peak device memory per sub-phase (GiB) at LLAVA_CLI_DEPTH (8) decoder
# layers: 6a the bf16 model, f32 adapters and activations (read 5.76 on an
# H100 80GB HBM3 at 700 W); 6b the student, a bf16 teacher, gradients,
# adamw_q8's moments and activations (read 21.22); 6c a loss's gradients and
# activations on 6b's resident state (SKU: five student forwards), or the
# student, its gradients, the initial copy and plain AdamW's bf16 moments
# once the teacher and the int8 state are gone (read 21.32); 6d the model
# with its ViT, their gradients, AdamW's moments and the check's two
# gradient trees (read 24.15).  Each bound is its reading with ~15% room.  At 32 layers 6b read 57.54: that r=0 fits
# one card at full depth is shown by r0_memory.py, not here
PEAK_BOUND_GIB = {"6a finetune": 6.6, "6b forget r0": 24.4, "6c losses": 24.5,
                  "6d finetune r0, trainable ViT": 27.8}


def _splits(loss: str, batch: dict) -> tuple[int, int, int]:
    """(student forwards, teacher forwards, student backwards) of one step of
    ``loss`` on ``batch``: which splits ``train/losses.py`` runs through the
    student and the teacher (SKU: its K random sub-batches too)."""
    k = batch["random"]["input_ids"].shape[1] if "random" in batch else 0
    if loss.startswith("grad_diff"):  # forget and retain splits, a teacher for each KL part
        return 2, loss.count("KL"), 2
    table = {"retain_ft": (1, 0), "grad_ascent": (1, 0), "npo": (1, 1), "scrub": (2, 2),
             "kl": (2, 1), "llmu": (3, 1), "rmu": (2, 1), "dpo": (2, 2), "sku": (k + 2, 1),
             "idk": (2, 0), "eco_ft": (2, 0)}
    s, t = table[loss.lower()]
    # DPO's loss as the reference leaves it (no dpo_fix) is -mean of the idk
    # log-probs: the forget split's student forward takes no gradient
    return s, t, 1 if loss.lower() == "dpo" else s


def vision_launches(vis) -> int:
    """B1 launches of one image forward of a vision tower: one a layer
    (LLaVA's ViT), one a block (Qwen2-VL's tower; Qwen2.5-VL's windowed
    blocks fold their windows into one launch); none without a tower (a
    text model, ``vis`` None)."""
    if vis is None:
        return 0
    return vis.num_layers if hasattr(vis, "num_layers") else vis.depth


def tower_backward_blocks(vis) -> int:
    """The vision-tower blocks a trainable tower's backward runs B2 and B3
    in: every Qwen2-VL block (the merger reads the last), LLaVA's below
    ``vision_feature_layer`` (the blocks at and above it feed nothing)."""
    if hasattr(vis, "depth"):
        return vis.depth
    return vis.num_layers + 1 + VISION_FEATURE_LAYER


VISION_FEATURE_LAYER = -2  # LLaVA-1.5's (configs/model_config.yaml)


def _expected_launches(loss, batch, dec, vis, steps=1, tower=False):
    """B1 in every decoder and ViT layer of every forward (save_attn keeps o
    and lse: no second forward in the backward pass); B2 and B3 in every
    decoder layer the student's backward reaches -- RMU reads layer 7's
    output, so its backward stops there -- and, with a trainable ``tower``,
    in each tower block that backward reaches."""
    from multimodal_unlearning_tpu_torch.train.losses import RMU_LAYER

    s, t, b = _splits(loss, batch)
    bwd_layers = RMU_LAYER + 1 if loss.lower() == "rmu" else dec.num_layers
    bwd_layers += tower_backward_blocks(vis) if tower else 0
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    expect.update({"flash_fwd": steps * (s + t) * (dec.num_layers + vision_launches(vis)),
                   "flash_bwd_dq": steps * b * bwd_layers,
                   "flash_bwd_dkv": steps * b * bwd_layers})
    return expect


@contextlib.contextmanager
def bwd_launches_by_head_dim():
    """While active, counts the B2 and B3 launches by head dim:
    {(kernel, D): launches} (a tower's D 80 or 64 beside the decoder's 128),
    read off ``kernels.LAUNCHES`` around each wrapper call."""
    from multimodal_unlearning_tpu_torch.ops import attention

    seen = collections.Counter()
    saved = {n: getattr(attention, n) for n in ("flash_bwd_dq", "flash_bwd_dkv")}

    def counted(name, fn):
        def wrapper(q, *a, **kw):
            before = kernels.LAUNCHES[name]
            out = fn(q, *a, **kw)
            seen[(name, q.shape[-1])] += kernels.LAUNCHES[name] - before
            return out
        return wrapper

    for name, fn in saved.items():
        setattr(attention, name, counted(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(attention, name, fn)


class _CliRecorder:
    """While active, records what a CLI run builds and does: the arguments
    of ``make_apply_fn`` and ``make_train_step``, every step's metrics
    (floats), wall time and tokens (every split, as the loop counts them),
    and ``train_loop``'s frozen tree, teacher and final state.
    ``before_loop(recorder, state)``, if given, runs when ``train_loop``
    is called, before the first step; ``after_loop(recorder)`` when it
    returns, before the CLI merges and saves."""

    def __init__(self, cli, after_loop=None, before_loop=None):
        from multimodal_unlearning_tpu_torch.cli import mm_forget
        from multimodal_unlearning_tpu_torch.train import trainer

        self.cli, self.mm_forget, self.trainer = cli, mm_forget, trainer
        self.steps, self.loop, self.apply_kw, self.step_args = [], {}, None, None
        self.after_loop, self.before_loop = after_loop, before_loop

    def __enter__(self):
        rec = self
        # every training CLI runs its loop through cli.common.run_train_loop
        make_step, make_apply, loop = (self.trainer.make_train_step,
                                       self.mm_forget.make_apply_fn, common.train_loop)
        self._saved = [(self.trainer, "make_train_step", make_step),
                       (self.mm_forget, "make_apply_fn", make_apply),
                       (self.cli, "make_apply_fn", getattr(self.cli, "make_apply_fn")),
                       (common, "train_loop", loop)]

        def apply_wrapper(*a, **kw):
            rec.apply_kw = (a, kw)
            return make_apply(*a, **kw)

        def step_wrapper(*a, **kw):
            rec.step_args = (a, kw)
            step = make_step(*a, **kw)

            def timed(state, frozen, teacher, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, frozen, teacher, batch)
                metrics = {k: float(v) for k, v in m.items()}
                rec.steps.append(dict(metrics, wall=time.perf_counter() - t0,
                                      tokens=sum(int(p["input_ids"].numel())
                                                 for p in batch.values())))
                return state, m

            timed.grad_fn = step.grad_fn
            return timed

        def loop_wrapper(**kw):
            rec.loop.update(frozen=kw["frozen"], teacher=kw["teacher_params"])
            if rec.before_loop is not None:
                rec.before_loop(rec, kw["state"])
            state, history = loop(**kw)
            rec.loop["state"] = state
            if rec.after_loop is not None:
                rec.after_loop(rec)
            return state, history

        self.trainer.make_train_step = step_wrapper
        self.mm_forget.make_apply_fn = apply_wrapper
        self.cli.make_apply_fn = apply_wrapper
        common.train_loop = loop_wrapper
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _check_steps(label, steps):
    for i, m in enumerate(steps):
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])) or m["skipped_nonfinite"]:
            raise AssertionError(f"{label} step {i + 1}: non-finite or skipped: {m}")


def _report_steps(label, steps, launches, peak, bounds=PEAK_BOUND_GIB):
    per = [f"{m['wall'] * 1e3:.0f} ms ({1 / m['wall']:.3f} steps/s, "
           f"{m['tokens'] / m['wall']:.0f} tok/s)" for m in steps]
    n = len(steps)
    print(f"{label}: {n} steps: {'; '.join(per)}; losses "
          f"{[round(m['loss'], 5) for m in steps]}, grad norms "
          f"{[round(m['grad_norm'], 4) for m in steps]}; launches per step "
          f"{ {k: v // n for k, v in launches.items() if v} }; max_memory_allocated "
          f"{peak:.2f} GiB (bound {bounds[label]})", flush=True)
    if peak > bounds[label]:
        raise AssertionError(f"{label}: peak device memory {peak:.2f} GiB above the bound "
                             f"{bounds[label]} GiB")


def _measured(fn):
    """(result, peak GiB, launches) of ``fn()`` with fresh counts and peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30, dict(kernels.LAUNCHES)


def _arg(args, key, default=None):
    return next((a.split("=", 1)[1] for a in args if a.lstrip("+").startswith(key + "=")),
                default)


def _loss_batch(loss, processor, dev, max_length=2048, data=RECIPE_DATA):
    """The first batch the forget CLI would draw for ``loss`` (its splits:
    idk for DPO and LLMU, SKU's random K), on the device."""
    from functools import partial

    from multimodal_unlearning_tpu_torch.data import DataLoader, MMMixedForgetDataset
    from multimodal_unlearning_tpu_torch.train.loop import to_device

    ds = MMMixedForgetDataset(forget_data_path=data, retain_data_path=data,
                              retain_split="retain90+tofu", forget_split="forget10+tofu",
                              forget_loss=loss, seed=42)
    loader = DataLoader(ds, 2, partial(processor.collate_forget, max_length=max_length),
                        shuffle=True, seed=42)
    return to_device(next(iter(loader)), dev)


def _finetune_batch(processor, dev, data, rows, max_length=2048):
    """The first micro-batch of ``rows`` the finetune CLI would draw from
    ``data`` (split full+tofu), on the device."""
    from multimodal_unlearning_tpu_torch.data import DataLoader, MMMixedDataset
    from multimodal_unlearning_tpu_torch.train.loop import to_device

    loader = DataLoader(MMMixedDataset(data, "full+tofu", seed=42), rows,
                        lambda b: {"retain": processor.collate(b, max_length)}, shuffle=True,
                        seed=42)
    return to_device(next(iter(loader)), dev)


def _grad_cosines(g1, g2):
    """{leaf path: cosine} of two gradient trees; a leaf whose gradient is
    zero on both sides (a block no loss reaches) counts as 1."""
    out = {}
    for (p, a), (_, b) in zip(tree_leaves_with_path(g1), tree_leaves_with_path(g2)):
        both_zero = not a.any() and not b.any()
        out["/".join(p)] = 1.0 if both_zero else _cos(a, b)
    return out


# a tower leaf of this many entries or more must move in a run: a step of
# lr ~1e-6 moves a bf16 weight only where |w| < ~3e-4, ~1% of the entries
# of N(0, 0.02) leaves, so a leaf as small as LLaVA's class_embed (1,024)
# may keep every entry
TOWER_MOVED_MIN = 4096


def _tower_cli_run(label, cli, argv, batch_of, bounds):
    """``cli.main(argv)`` at ``LoRA.r=0`` with ``freeze_vision_module=false``:
    the vision tower trains.  Checked: every step finite (the loss moving
    over more than one); the tower's leaves moved from their values at the
    loop's start (those of ``TOWER_MOVED_MIN`` entries or more but the norm
    scales, which a step of ~1e-6 cannot move in bf16) -- LLaVA's blocks at
    and above ``vision_feature_layer``
    and ``post_ln`` equal to them bit for bit instead (no gradient, no
    decay); every launch as the structure gives, B2 and B3 at the tower's
    head dim (80, or LLaVA's 64) once per block the backward reaches, per
    backward pass; at the loop's end the kernel route's gradient of
    ``batch_of()`` against plain attention's on the CLI's state (loss within
    ``STEP_LOSS_TOL``, cosine ``STEP_GRAD_COS`` on every leaf, the tower's
    included); the peak under ``bounds[label]``.  Returns (launches, B2/B3
    launches by head dim)."""
    from multimodal_unlearning_tpu_torch.cli import mm_forget
    from multimodal_unlearning_tpu_torch.train import trainer

    start, got = {}, {}

    def before(rec, state):
        start.update({p: x.detach().clone()
                      for p, x in tree_leaves_with_path(state.trainable["vision_tower"])})

    def after(rec):
        torch.cuda.synchronize()
        got.update(launches=dict(kernels.LAUNCHES), by_d=dict(by_d), steps=list(rec.steps),
                   peak=torch.cuda.max_memory_allocated() / 2**30)
        state, frozen, teacher = rec.loop["state"], rec.loop["frozen"], rec.loop["teacher"]
        (apply_fn, tx), step_kw = rec.step_args[0][:2], rec.step_args[1]
        mcfg = rec.apply_kw[0][1]
        # the CLI's own settings, before the checks below build steps of their own
        kw = rec.apply_kw[1]
        got.update(mcfg=mcfg, loss=step_kw["loss_type"], accum=step_kw["grad_accum"],
                   refwd=kw["remat"] and kw["remat_policy"] not in ("save_attn", "save_attn_ffn"))
        cut = tower_backward_blocks(mcfg.vision)
        if getattr(mcfg, "vision_feature_layer", VISION_FEATURE_LAYER) != VISION_FEATURE_LAYER:
            raise AssertionError(f"{label}: vision_feature_layer {mcfg.vision_feature_layer}")
        moved, still = 0, []
        for p, x in tree_leaves_with_path(state.trainable["vision_tower"]):
            x0, key = start[p], "/".join(p)
            if hasattr(mcfg.vision, "num_layers") and p[0] == "layers":  # LLaVA's ViT
                if not torch.equal(x[cut:], x0[cut:]):
                    raise AssertionError(f"{label}: {key} moved above vision_feature_layer")
                x, x0 = x[:cut], x0[:cut]
            elif p[0] == "post_ln":
                if not torch.equal(x, x0):
                    raise AssertionError(f"{label}: {key} (feeds no loss) moved")
                continue
            if not torch.equal(x, x0):
                moved += 1
            elif p[-1] != "scale" and x.numel() >= TOWER_MOVED_MIN:
                still.append(key)
        if still:
            raise AssertionError(f"{label}: tower leaves still at their loaded values: {still}")
        batch = batch_of()
        plain_fn = mm_forget.make_apply_fn(*rec.apply_kw[0],
                                           **dict(rec.apply_kw[1], attn_impl="plain"))
        grad_of = lambda fn: trainer.make_train_step(  # noqa: E731
            fn, tx, **dict(step_kw, grad_accum=1)).grad_fn(state.trainable, frozen, teacher,
                                                           batch)
        (lk, _), gk = grad_of(apply_fn)
        (lp, _), gp = grad_of(plain_fn)
        cos = _grad_cosines(gk, gp)
        if hasattr(mcfg.vision, "num_layers"):
            # CLIP's key bias adds q.b to every score of a row, which the
            # softmax cancels: its gradient is 0 but for rounding, on both
            # routes, and has no direction to compare
            cos.pop("vision_tower/layers/k_bias")
        tower_cos = {k: v for k, v in cos.items() if k.startswith("vision_tower")}
        worst = min(cos, key=cos.get)
        print(f"{label}: {moved} of {len(start)} tower leaves moved from their loaded "
              f"values; first batch, "
              f"kernels vs plain attention: loss {float(lk):.5f} vs {float(lp):.5f} (tol "
              f"{STEP_LOSS_TOL}); gradient cosine min {cos[worst]:.5f} at {worst}, tower min "
              f"{min(tower_cos.values()):.5f} over {len(tower_cos)} leaves, median "
              f"{statistics.median(cos.values()):.5f} over {len(cos)} (tol {STEP_GRAD_COS})",
              flush=True)
        if abs(float(lk) - float(lp)) > STEP_LOSS_TOL or cos[worst] < STEP_GRAD_COS:
            raise AssertionError(f"{label}: kernels vs plain attention: loss {float(lk)} vs "
                                 f"{float(lp)}, cosine {cos[worst]} at {worst}")

    with bwd_launches_by_head_dim() as by_d:
        with _CliRecorder(cli, after_loop=after, before_loop=before) as rec:
            t0 = time.perf_counter()
            _measured(lambda: cli.main(argv))
            wall = time.perf_counter() - t0
    steps, mcfg = got["steps"], got["mcfg"]
    _check_steps(label, steps)
    losses = [m["loss"] for m in steps]
    if len(steps) > 1 and len(set(losses)) < 2:
        raise AssertionError(f"{label}: the loss did not move: {losses}")
    accum = got["accum"]
    passes = len(steps) * accum * _splits(got["loss"], {})[2]
    want = _expected_launches(got["loss"], {}, mcfg.decoder, mcfg.vision,
                              steps=len(steps) * accum, tower=True)
    if got["refwd"]:  # remat without save_attn: each decoder layer's B1 runs again
        want["flash_fwd"] += passes * mcfg.decoder.num_layers
    _check_launches(label, got["launches"], want)
    d = mcfg.vision.head_dim if hasattr(mcfg.vision, "head_dim") else (
        mcfg.vision.hidden_size // mcfg.vision.num_heads)
    tower = tower_backward_blocks(mcfg.vision)
    want_d = collections.Counter()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        want_d[(name, d)] += passes * tower
        want_d[(name, mcfg.decoder.head_dim)] += passes * mcfg.decoder.num_layers
    if got["by_d"] != want_d:
        raise AssertionError(f"{label}: B2/B3 by head dim {got['by_d']}, expected {want_d} "
                             f"({passes} backward passes x {tower} tower blocks at D {d})")
    print(f"{label}: main() {wall:.1f} s; B2/B3 by head dim {got['by_d']} ({passes} backward "
          f"passes x {tower} tower blocks at D {d})", flush=True)
    _report_steps(label, steps, got["launches"], got["peak"], bounds)
    return got["launches"], {f"{n} D{dim}": v for (n, dim), v in got["by_d"].items()}


def run_recipe_path(ft_dir, finetune_args=FINETUNE_CLI_ARGS, forget_args=R0_FORGET_CLI_ARGS,
                    device="cuda"):
    """6a ``cli.mm_finetune.main`` saving into ``ft_dir`` (the caller's
    directory: phase 7 evaluates what is saved there, and the caller removes
    it), 6b ``cli.mm_forget.main`` at LoRA.r=0 on what 6a saved, 6c one step
    of each other loss on 6b's student and teacher.  Returns the launch
    counts of each sub-phase."""
    import dataclasses
    import shutil
    import tempfile

    from multimodal_unlearning_tpu_torch.cli import mm_finetune, mm_forget
    from multimodal_unlearning_tpu_torch.models import llava
    from multimodal_unlearning_tpu_torch.train import losses as L
    from multimodal_unlearning_tpu_torch.train import optim, trainer
    from multimodal_unlearning_tpu_torch.utils.pytree import param_tree

    dev = torch.device(device)
    fg_dir = tempfile.mkdtemp(prefix="recipe_forget_")
    out = {}
    try:
        # 6a: finetune, LoRA r 8 over the bf16 base, merged and saved in bf16
        with _CliRecorder(mm_finetune) as rec:
            t0 = time.perf_counter()
            history, peak, launches = _measured(
                lambda: mm_finetune.main(finetune_args + [f"save_dir={ft_dir}"]))
            wall = time.perf_counter() - t0
        mcfg = rec.apply_kw[0][1]
        dec, vis = mcfg.decoder, mcfg.vision
        _check_steps("6a finetune", rec.steps)
        want = _expected_launches("retain_ft", {}, dec, vis, steps=len(rec.steps))
        if launches != want:
            raise AssertionError(f"6a finetune launches {launches}, expected {want}")
        size = os.path.getsize(f"{ft_dir}/model.safetensors")
        print(f"6a finetune: main() {wall:.1f} s (init, steps, merge, save of "
              f"{size / 1e9:.2f} GB)", flush=True)
        _report_steps("6a finetune", rec.steps, launches, peak)
        out["finetune"] = launches
        del rec, history
        gc.collect()
        torch.cuda.empty_cache()

        # 6b: forget from 6a's checkpoint, LoRA.r=0, NPO, adamw_q8, bf16 teacher
        rec = _CliRecorder(mm_forget)
        with rec:
            t0 = time.perf_counter()
            history, peak, launches = _measured(lambda: mm_forget.main(
                forget_args + [f"model_path={ft_dir}", f"save_dir={fg_dir}"]))
            wall = time.perf_counter() - t0
        state, frozen, teacher = rec.loop["state"], rec.loop["frozen"], rec.loop["teacher"]
        (apply_fn, tx), step_kw = rec.step_args[0][:2], rec.step_args[1]
        _check_steps("6b forget r0", rec.steps)
        losses = [m["loss"] for m in rec.steps]
        if len(set(losses)) < 2:
            raise AssertionError(f"6b: NPO's loss did not move: {losses}")
        processor = common.build_processor(serve.get_model_identifiers(
            _arg(forget_args, "model_family")))
        max_length = int(_arg(forget_args, "max_length", 2048))
        npo_batch = _loss_batch("npo", processor, dev, max_length)
        want = _expected_launches("npo", npo_batch, dec, vis, steps=len(rec.steps))
        if launches != want:
            raise AssertionError(f"6b forget launches {launches}, expected {want}")
        # the teacher is the model as loaded: the trainable leaves moved away
        # from it, the frozen vision tower did not move at all
        tparams = param_tree(teacher)

        def at(tree, path):
            for key in path:
                tree = tree[key]
            return tree

        with torch.no_grad():
            moved = math.sqrt(sum(float((p.float() - at(tparams, path).float()).pow(2).sum())
                                  for path, p in tree_leaves_with_path(state.trainable)))
            same = all(torch.equal(p, at(tparams, path))
                       for path, p in tree_leaves_with_path(frozen))
        n_vis = len(tree_leaves_with_path(frozen))
        if not moved > 0 or not same or not n_vis:
            raise AssertionError(f"6b: trainable change norm {moved}, vision tower unchanged "
                                 f"{same} ({n_vis} leaves)")
        print(f"6b forget r0: main() {wall:.1f} s (load, teacher copy, steps); trainable "
              f"change norm {moved:.4e}; the {n_vis} vision-tower leaves equal to the loaded "
              f"ones bit for bit", flush=True)
        _report_steps("6b forget r0", rec.steps, launches, peak)
        out["forget_r0"] = launches
        npo_ms = statistics.median(m["wall"] for m in rec.steps[1:] or rec.steps) * 1e3

        # 6c.1: the kernel path against plain attention on NPO's first batch
        plain_kw = dict(rec.apply_kw[1], attn_impl="plain", remat_policy=None)
        plain_fn = mm_forget.make_apply_fn(*rec.apply_kw[0], **plain_kw)
        del rec
        grad_of = lambda fn: trainer.make_train_step(fn, tx, **step_kw).grad_fn(
            state.trainable, frozen, teacher, npo_batch)
        torch.cuda.reset_peak_memory_stats()
        (lk, _), gk = grad_of(apply_fn)
        # the kernel path's gradients wait on the host: two 12.6 GiB trees
        # beside 6b's 57 GiB would leave the card ~4 GiB
        gk = [(p, g.to("cpu")) for p, g in tree_leaves_with_path(gk)]
        (lp, _), gp = grad_of(plain_fn)
        cos = {"/".join(p): _cos(g.to(dev), w) for (p, g), (_, w) in
               zip(gk, tree_leaves_with_path(gp))}
        del gk
        worst = min(cos, key=cos.get)
        print(f"6c kernel vs plain attention, NPO's first batch: loss {float(lk):.5f} vs "
              f"{float(lp):.5f} (tol {STEP_LOSS_TOL}); gradient cosine min {cos[worst]:.5f} at "
              f"{worst}, median {statistics.median(cos.values()):.5f} over {len(cos)} leaves "
              f"(tol {STEP_GRAD_COS})", flush=True)
        if abs(float(lk) - float(lp)) > STEP_LOSS_TOL or cos[worst] < STEP_GRAD_COS:
            raise AssertionError(f"6c: kernel vs plain attention: loss {float(lk)} vs "
                                 f"{float(lp)}, cosine {cos[worst]} at {worst}")
        gate_peak = torch.cuda.max_memory_allocated() / 2**30
        # adamw_q8 alone: one update over the 6.76 B trainable entries with
        # ok false (the same work, nothing written)
        never = torch.zeros((), dtype=torch.bool, device=dev)
        q8_ms = []
        for _ in range(2):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            tx.step_(gp, state.opt_state, state.trainable, ok=never)
            e1.record()
            torch.cuda.synchronize()
            q8_ms.append(e0.elapsed_time(e1))
        del gp
        # the teacher's forward on the same batch, alone
        with torch.no_grad():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            apply_fn(teacher, npo_batch["forget"])
            e0.record()
            apply_fn(teacher, npo_batch["forget"])
            e1.record()
            torch.cuda.synchronize()
            teacher_ms = e0.elapsed_time(e1)
        print(f"6c: adamw_q8 update {q8_ms[-1]:.1f} ms of device time (first call "
              f"{q8_ms[0]:.1f}) = {q8_ms[-1] / npo_ms:.3f} of a 6b step ({npo_ms:.0f} ms); the "
              f"teacher's forward {teacher_ms:.1f} ms = {teacher_ms / npo_ms:.3f} of it; peak "
              f"{gate_peak:.2f} GiB through the two gradients", flush=True)

        # 6c.2: one step of each other loss, with its own splits, on 6b's
        # student, teacher and adamw_q8 state
        per_loss, total = {}, dict.fromkeys(kernels.LAUNCHES, 0)
        peak_c = gate_peak
        for loss in OTHER_LOSSES:
            batch = _loss_batch(loss, processor, dev, max_length)
            st = state
            if loss == "rmu":
                st = dataclasses.replace(state, control_vec=L.make_control_vec(
                    torch.Generator(device=dev).manual_seed(42), 2, dec.hidden_size))
            step = trainer.make_train_step(apply_fn, tx, **dict(step_kw, loss_type=loss))
            t0 = time.perf_counter()
            (st, m), peak, launches = _measured(lambda: step(st, frozen, teacher, batch))
            ms = (time.perf_counter() - t0) * 1e3
            state = dataclasses.replace(st, control_vec=None)
            m = {k: float(v) for k, v in m.items()}
            _check_steps(f"6c {loss}", [m])
            want = _expected_launches(loss, batch, dec, vis)
            if launches != want:
                raise AssertionError(f"6c {loss} launches {launches}, expected {want}")
            per_loss[loss] = dict(ms=round(ms, 1), loss=round(m["loss"], 5),
                                  grad_norm=round(m["grad_norm"], 4), peak_gib=round(peak, 2),
                                  launches={k: v for k, v in launches.items() if v})
            peak_c = max(peak_c, peak)
            for k, v in launches.items():
                total[k] += v
            del batch, step, st
        # grad_ascent with L1 from the initial model and plain AdamW (bf16
        # moments, 25.2 GiB): the q8 state and the teacher go first
        trainable = state.trainable
        del state, teacher, tparams
        gc.collect()
        torch.cuda.empty_cache()
        adamw = optim.make_optimizer(
            "adamw", 1e-5, weight_decay=0.01, warmup_steps=8, total_steps=3, max_grad_norm=1.0,
            reachable_mask=lambda p: llava.reachable_mask(p, mcfg))
        st = trainer.create_train_state(trainable, adamw, keep_init=True)
        batch = _loss_batch("grad_ascent", processor, dev, max_length)
        step = trainer.make_train_step(apply_fn, adamw, loss_type="grad_ascent",
                                       l1_lambda=1e-4, l_norm_from="init")
        t0 = time.perf_counter()
        (st, m), peak, launches = _measured(lambda: step(st, frozen, None, batch))
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in m.items()}
        _check_steps("6c grad_ascent+l1", [m])
        want = _expected_launches("grad_ascent", batch, dec, vis)
        if launches != want:
            raise AssertionError(f"6c grad_ascent launches {launches}, expected {want}")
        per_loss["grad_ascent+l1_init+adamw"] = dict(
            ms=round(ms, 1), loss=round(m["loss"], 5), grad_norm=round(m["grad_norm"], 4),
            peak_gib=round(peak, 2), launches={k: v for k, v in launches.items() if v})
        peak_c = max(peak_c, peak)
        for k, v in launches.items():
            total[k] += v
        print(f"6c losses, one step each on 6b's student: {json.dumps(per_loss)}; peak "
              f"{peak_c:.2f} GiB (bound {PEAK_BOUND_GIB['6c losses']})", flush=True)
        if peak_c > PEAK_BOUND_GIB["6c losses"]:
            raise AssertionError(f"6c: peak {peak_c:.2f} GiB above the bound")
        out["losses"] = total
        del st, step, batch, trainable, frozen, apply_fn, tx
        gc.collect()
        torch.cuda.empty_cache()

        # 6d: r=0 finetune steps from 6a's checkpoint with the ViT trained: two,
        # since the warmup's first step runs at lr 0 (lr 1e-4, as 6b, so that a
        # bf16 weight can move in the second)
        out["tower"], _ = _tower_cli_run(
            "6d finetune r0, trainable ViT", mm_finetune,
            [a for a in finetune_args if not a.startswith("+model_path")] + [
                f"+model_path={ft_dir}", "LoRA.r=0", "freeze_vision_module=false",
                "+save_model=false", "lr=1e-4", "num_epochs=0.03",  # 160 rows, 2 a step: 2 steps
                f"save_dir={fg_dir}"],
            lambda: _finetune_batch(processor, dev, RECIPE_DATA, 2, max_length),
            PEAK_BOUND_GIB)
        return out
    finally:
        shutil.rmtree(fg_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 7
# CLEAR's evaluation through the CLIs on phase 6a's checkpoint: configs/mm/
# eval.yaml as it ships (bf16, the plain greedy route, 300 new tokens, batch
# 8, all six tasks) but for the family, the data and ds_size 8, so that each
# task is one batch of 8 rows.  "synthetic:n_persons=20" is RECIPE_DATA (4 QA
# a person by default) written without a comma, so that the list override
# parses as six entries.
EVAL_DATA = "synthetic:n_persons=20"
EVAL_CLI_ARGS = ["model_family=llava", "ds_size=8", f"data_path=[{','.join([EVAL_DATA] * 6)}]"]
SPEC_EVAL_ARGS = ["engine_generate=true", "speculative_k=4"]
# 7d: greedy_generate's own speculative route, on the first task
GREEDY_SPEC_EVAL_ARGS = ["speculative_k=4", "eval_task_ids=[0]"]
EVAL_RUNS = {"7a eval": [], "7b eval, engine + speculation": SPEC_EVAL_ARGS,
             "7d eval, greedy speculation": GREEDY_SPEC_EVAL_ARGS}
EVAL_KEYS = {"average_perturb_loss", "avg_paraphrased_loss", "truth_ratio", "paraphrased_loss",
             "perturb_loss", "num_token_paraphrased", "num_token_perturb", "avg_gt_loss",
             "gt_loss", "num_token_gt", "generated_text", "rouge1_recall", "rougeL_recall"}
# 7a's and 7b's teacher-forced numbers come from the same code on the same
# batches, and the kernels and cuBLAS are deterministic at a fixed shape, so
# they are expected equal bit for bit; 1e-5 relative leaves room only for a
# library that picks another algorithm when the engine's cache changes the
# free memory, which moves the last bits and nothing more
EVAL_TF_TOL = 1e-5


class _EvalRecorder:
    """While active, records what ``cli.mm_eval.run`` (or, with ``text``,
    ``cli.nlp_eval.run``) does: the model it loads, the tokens a stream may
    end at (eos, pad), and per task its wall time, its teacher-forced
    forwards (count and seconds) and its generation (seconds, decode
    forwards, each row's token stream and prompt; the engine's counters
    under ``engine_generate``)."""

    def __init__(self, sync, max_new, text=False):
        from multimodal_unlearning_tpu_torch.cli import mm_eval, nlp_eval
        from multimodal_unlearning_tpu_torch.evaluation import evaluator

        self.cli, self.evaluator, self.sync = nlp_eval if text else mm_eval, evaluator, sync
        # the evaluator's per-task entry point and its engine drain
        self.names = ("nlp_get_all_evals", "_nlp_pregenerate") if text else (
            "get_all_evals", "_pregenerate")
        self.model, self.tasks, self.max_new, self.ends = None, [], max_new, ()

    def __enter__(self):
        rec, ev, sync = self, self.evaluator, self.sync
        load, get_all, losses = (common.init_or_load_params, getattr(ev, self.names[0]),
                                 ev._model_losses)
        greedy, pregen = self.cli.greedy_generate, getattr(ev, self.names[1])
        self._saved = [(common, "init_or_load_params", load), (ev, self.names[0], get_all),
                       (ev, "_model_losses", losses), (self.cli, "greedy_generate", greedy),
                       (ev, self.names[1], pregen)]

        def load_wrapper(*a, **kw):
            out = load(*a, **kw)
            rec.model = out[2]
            return out

        def get_all_wrapper(task, *a, **kw):
            cur = dict(task=task, tf_forwards=0, tf_s=0.0, gen_s=0.0, forwards=0, prefills=0,
                       streams=[], prompts=[], engine=None)
            rec.tasks.append(cur)
            sync()
            t0 = time.perf_counter()
            logs = get_all(task, *a, **kw)
            sync()
            cur["wall"] = time.perf_counter() - t0
            return logs

        def losses_wrapper(apply_fn, batch):
            sync()
            t0 = time.perf_counter()
            out = losses(apply_fn, batch)  # numpy: waits for the forward
            rec.tasks[-1]["tf_s"] += time.perf_counter() - t0
            rec.tasks[-1]["tf_forwards"] += 1
            return out

        def greedy_wrapper(model, mcfg, ids, mask, **kw):
            sync()
            t0 = time.perf_counter()
            tokens, stats = greedy(model, mcfg, ids, mask, return_stats=True, **kw)
            rows = tokens.cpu().numpy()
            cur = rec.tasks[-1]
            cur["gen_s"] += time.perf_counter() - t0
            cur["forwards"] += stats["forwards"]
            cur["spec"] = bool(kw.get("speculate_k"))
            cur["prefills"] += 1
            pad = kw["pad_token_id"]
            rec.ends = (kw["eos_token_id"], pad)
            for r in range(len(rows)):
                row = rows[r].tolist()
                while row and row[-1] == pad:  # a finished row emits pad
                    row.pop()
                cur["streams"].append(row)
                cur["prompts"].append((np.asarray(ids)[r][np.asarray(mask)[r] > 0].tolist(),
                                       None))
            return tokens

        def pregen_wrapper(engine, *a, **kw):
            reqs, drain = [], engine.drain

            def drain_wrapper(requests):
                reqs.extend(requests)
                return drain(requests)

            s0 = engine.stats()
            rec.ends = (engine.eos, engine.pad_id)
            engine.drain = drain_wrapper
            sync()
            t0 = time.perf_counter()
            try:
                texts = pregen(engine, *a, **kw)
            finally:
                engine.drain = drain
            sync()
            s1 = engine.stats()
            cur = rec.tasks[-1]
            cur["gen_s"] += time.perf_counter() - t0
            cur["engine"] = {k: s1[k] - s0[k] for k in ("dispatches", "prefills", "live_rounds",
                                                       "emitted")}
            cur["forwards"] += cur["engine"]["dispatches"] * engine.chunk
            cur["prefills"] += cur["engine"]["prefills"]
            cur["streams"] += [list(r.tokens) for r in reqs]
            cur["prompts"] += [(list(r.prompt_ids), r.pixel_values) for r in reqs]
            return texts

        common.init_or_load_params = load_wrapper
        setattr(ev, self.names[0], get_all_wrapper)
        ev._model_losses = losses_wrapper
        self.cli.greedy_generate = greedy_wrapper
        setattr(ev, self.names[1], pregen_wrapper)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _check_eval_files(label, save_dir, agg, rows, tasks):
    """Every task's JSON holds the schema's keys (``normalized_gt_loss``
    where the task's name lacks ``eval_log``), one entry per row under each,
    finite numbers; the aggregate holds the same logs, ``tasks`` of them."""
    on_disk = json.loads(open(os.path.join(save_dir, "eval_log_aggregated.json")).read())
    if list(on_disk) != list(agg) or len(agg) != tasks:
        raise AssertionError(f"{label}: aggregate holds {list(on_disk)}")
    for name in agg:
        log = json.loads(open(os.path.join(save_dir, name)).read())
        want = EVAL_KEYS | ({"normalized_gt_loss"} if "eval_log" not in name else set())
        if set(log) != want or log != on_disk[name]:
            raise AssertionError(f"{label} {name}: keys {sorted(log)}, expected {sorted(want)}")
        for key, per_row in log.items():
            if len(per_row) != rows:
                raise AssertionError(f"{label} {name}: {key} has {len(per_row)} rows, not {rows}")
            if key == "generated_text":
                continue
            vals = np.asarray(list(per_row.values()), dtype=np.float64)
            if not np.isfinite(vals).all():
                raise AssertionError(f"{label} {name}: {key} holds non-finite values")


def _eval_launches(rec, dec, vis, speculative: bool) -> dict:
    """B1 in every decoder and ViT layer of each teacher-forced forward (the
    eval rows carry pixels) and in every decoder layer of each prefill (the
    questions are re-tokenized without their images); one B4 per decoder
    layer and decode step, or one B5 per decoder layer and verify round."""
    expect = dict.fromkeys(kernels.LAUNCHES, 0)
    tf = sum(t["tf_forwards"] for t in rec.tasks)
    pre = sum(t["prefills"] for t in rec.tasks)
    fwd = sum(t["forwards"] for t in rec.tasks)
    expect["flash_fwd"] = tf * (dec.num_layers + vision_launches(vis)) + pre * dec.num_layers
    expect["chunk_decode" if speculative else "flash_decode"] = fwd * dec.num_layers
    return expect


def _report_eval(label, rec, wall, peak):
    n_tok = n_fwd = 0
    for t in rec.tasks:
        toks = sum(len(s) for s in t["streams"])
        n_tok, n_fwd = n_tok + toks, n_fwd + t["forwards"]
        extra = ""
        # greedy_generate's speculative route: the tokens after each row's
        # first (the prefill's) per row and forward; the forwards include the
        # rounds run before the host saw that every row had finished
        if t.get("spec"):
            rows = len(t["streams"])
            extra = (f"; tokens per row and verify forward "
                     f"{(toks - rows) / max(t['forwards'] * rows, 1):.3f}")
        if t["engine"] is not None:
            e = t["engine"]
            extra = (f"; {e['dispatches']} dispatches, tokens per verify round "
                     f"{e['emitted'] / max(e['live_rounds'], 1):.3f}")
        print(f"{label} {t['task']}: {t['wall']:.2f} s = teacher-forced {t['tf_s']:.2f} s "
              f"({t['tf_forwards']} forwards) + generation {t['gen_s']:.2f} s ({len(t['streams'])} "
              f"rows, {toks} tokens, {toks / t['gen_s']:.1f} tok/s, {t['forwards']} decode "
              f"forwards, {t['gen_s'] / max(t['forwards'], 1) * 1e3:.2f} ms each{extra})",
              flush=True)
    gen_s = sum(t["gen_s"] for t in rec.tasks)
    print(f"{label}: main() {wall:.1f} s; {len(rec.tasks)} tasks in "
          f"{sum(t['wall'] for t in rec.tasks):.1f} s; generated {n_tok} tokens in {gen_s:.1f} s "
          f"= {n_tok / gen_s:.1f} tok/s, {gen_s / max(n_fwd, 1) * 1e3:.2f} ms per decode forward "
          f"({n_fwd}); max_memory_allocated {peak:.2f} GiB", flush=True)
    return dict(wall_s=round(wall, 2), gen_s=round(gen_s, 2), tokens=n_tok,
                tok_s=round(n_tok / gen_s, 2), forwards=n_fwd,
                ms_per_forward=round(gen_s / max(n_fwd, 1) * 1e3, 3), peak_gib=round(peak, 2))


def hold_streams(model, label, streams, prompts, max_new, ends, dtype=torch.bfloat16,
                 extras=None, logprobs=None):
    """Every token of every stream against one teacher-forced forward of
    ``model`` over the stream's prompt and the stream (with the stream's
    ``extras`` model arguments: its LoRA adapter): each token must be the
    argmax after what precedes it, or within TIE_MARGIN of it, and so must
    the better of ``ends`` (the eos, or the pad a greedy row emits) where a
    stream shorter than ``max_new`` stopped.  With ``logprobs`` (one list
    per stream), each must be within LOGIT_TOL of that forward's
    ``log_softmax`` at its token.  Returns (largest gap, tokens checked,
    tokens that were not the argmax, the largest logprob difference: 0.0
    without ``logprobs``)."""
    dev = next(model.parameters()).device
    worst, n, off, lp_worst = 0.0, 0, 0, 0.0
    extras = extras or [{}] * len(streams)
    for i, (s, (ids, pix), kw) in enumerate(zip(streams, prompts, extras)):
        seq = torch.tensor([list(ids) + list(s)], device=dev)
        if pix is not None:  # a text model takes no pixel argument
            kw = dict(kw, pixel_values=torch.from_numpy(np.asarray(pix)[None]).to(dev, dtype))
        with torch.inference_mode():
            logits = model(seq, compute_dtype=dtype, positions=_tf_positions(model, ids, len(s)),
                           **kw)["logits"][0].float()
        lg = logits[len(ids) - 1:]  # lg[j] predicts token j of the stream
        if logprobs is not None:
            tok = torch.tensor(s, dtype=torch.long, device=dev)
            want = torch.log_softmax(lg[:len(s)], dim=-1)[torch.arange(len(s), device=dev), tok]
            got = torch.tensor(logprobs[i], dtype=torch.float32, device=dev)
            if got.shape != want.shape:
                raise AssertionError(f"{label}: stream {i} has {len(s)} tokens and "
                                     f"{got.numel()} logprobs")
            d = float((got - want).abs().max()) if len(s) else 0.0
            if d > LOGIT_TOL:
                raise AssertionError(f"{label}: stream {i}'s logprobs lie {d:.4f} from the "
                                     f"teacher-forced log_softmax (tol {LOGIT_TOL})")
            lp_worst = max(lp_worst, d)
        top = lg.max(dim=-1).values
        gaps = top[:len(s)] - lg[torch.arange(len(s), device=dev),
                                  torch.tensor(s, dtype=torch.long, device=dev)]
        if len(s) < max_new:  # the row stopped: at the best of its end tokens
            end = [e for e in ends if e is not None and e >= 0]
            gaps = torch.cat([gaps, (top[len(s)] - lg[len(s), end].max())[None]])
        j = int(torch.argmax(gaps))
        gap = float(gaps[j])
        if gap > TIE_MARGIN:
            raise AssertionError(f"{label}: stream {i} token {j} of {len(s)} lies {gap:.4f} below "
                                 f"the teacher-forced argmax (tie margin {TIE_MARGIN})")
        worst, n, off = max(worst, gap), n + len(gaps), off + int((gaps > 0).sum())
    return worst, n, off, lp_worst


def _eval_run(label, argv, sync, tasks):
    """One ``cli.mm_eval.main`` run under the recorder, its files and its
    launches checked.  Returns (aggregate, save dir, recorder, numbers)."""
    from multimodal_unlearning_tpu_torch.cli import mm_eval
    from multimodal_unlearning_tpu_torch.config import load_config
    from multimodal_unlearning_tpu_torch.config.registry import config_dir

    cfg = load_config(config_dir() / "mm", "eval", argv)
    rows = int(cfg.ds_size)
    with _EvalRecorder(sync, int(cfg.generation.max_new_tokens)) as rec:
        t0 = time.perf_counter()
        agg, peak, launches = _measured(lambda: mm_eval.main(argv))
        wall = time.perf_counter() - t0
    mcfg = rec.model.cfg
    _check_eval_files(label, cfg.save_dir, agg, rows, tasks)
    print(f"{label}: {len(agg)} tasks of {rows} rows each "
          f"({', '.join(t['task'] for t in rec.tasks)})", flush=True)
    want = _eval_launches(rec, mcfg.decoder, mcfg.vision, speculative=bool(cfg.speculative_k))
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    return agg, cfg.save_dir, rec, dict(_report_eval(label, rec, wall, peak),
                                        launches={k: v for k, v in launches.items() if v})


def run_eval_path(ft_dir, args=EVAL_CLI_ARGS, runs=EVAL_RUNS, sync=torch.cuda.synchronize):
    """7a ``cli.mm_eval.main`` on ``ft_dir`` as eval.yaml ships it; 7b the
    same with the serving engine and speculation (drafts from the
    ground-truth answers); 7c ``cli.mm_calculate_metrics.main`` on the two
    aggregates; 7d the first task on greedy_generate's speculative route.
    Then every stream of 7a, 7b and 7d against teacher-forced forwards of
    7d's model.  Returns the launch counts and numbers of 7a, 7b and 7d."""
    from multimodal_unlearning_tpu_torch.cli import mm_calculate_metrics

    (la, xa), (lb, xb), (ld, xd) = runs.items()
    out = {}

    def run(label, extra, subdir, tasks):
        argv = args + [f"model_path={ft_dir}"] + extra + (
            [f"save_dir={os.path.join(ft_dir, subdir)}"] if subdir else [])
        agg, save_dir, rec, out[label] = _eval_run(label, argv, sync, tasks)
        return agg, save_dir, rec

    agg_a, dir_a, rec_a = run(la, xa, None, 6)  # eval.yaml's own ${model_path}/eval_results/
    rec_a.model = None
    gc.collect()
    torch.cuda.empty_cache()
    agg_b, dir_b, rec_b = run(lb, xb, "eval_spec", 6)
    rec_b.model = None
    gc.collect()
    torch.cuda.empty_cache()
    # the same teacher-forced numbers
    worst = 0.0
    for name in agg_a:
        for key in ("avg_gt_loss", "gt_loss", "paraphrased_loss", "perturb_loss", "truth_ratio"):
            a = np.asarray(list(agg_a[name][key].values()), np.float64)
            b = np.asarray(list(agg_b[name][key].values()), np.float64)
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-30))))
    print(f"7a vs 7b teacher-forced losses and ratios: max relative difference {worst:.3e} "
          f"({'bit for bit equal' if worst == 0 else 'not bit for bit'}; tol {EVAL_TF_TOL})",
          flush=True)
    if worst > EVAL_TF_TOL:
        raise AssertionError(f"7a and 7b teacher-forced numbers differ by {worst:.3e}")

    # 7c: the metrics CLI, 7a's aggregate as the checkpoint, 7b's as retain
    metrics_file = os.path.join(ft_dir, "metrics.json")
    res = mm_calculate_metrics.main([f"ckpt_result={dir_a}/eval_log_aggregated.json",
                                     f"retain_result={dir_b}/eval_log_aggregated.json",
                                     f"save_file={metrics_file}"])
    from multimodal_unlearning_tpu_torch.evaluation.metrics import FILE_TO_TASK

    want_keys = (["method", "submitted_by"]
                 + [f"{m} {FILE_TO_TASK[n]}" for n in agg_a for m in ("Prob.", "ROUGE",
                                                                      "Truth Ratio")]
                 + ["Model Utility", "KS test p-value", "JS metric"])
    saved = json.loads(open(metrics_file).read())
    nums = [v for k, v in saved.items() if k not in ("method", "submitted_by")]
    if list(res) != want_keys or list(saved) != want_keys or not np.isfinite(nums).all():
        raise AssertionError(f"7c metrics: {saved}")
    print(f"7c mm_calculate_metrics: {json.dumps(saved)}", flush=True)

    # 7d: greedy_generate's speculative route on the first task; its model
    # serves the stream checks
    _, _, rec_d = run(ld, xd, "eval_greedy_spec", 1)
    model = rec_d.model
    want = [s for t in rec_a.tasks for s in t["streams"]]
    prompts = [p for t in rec_a.tasks for p in t["prompts"]]
    for label, rec in ((lb, rec_b), (ld, rec_d)):
        got = [s for t in rec.tasks for s in t["streams"]]
        if [p for t in rec.tasks for p in t["prompts"]] != prompts[:len(got)]:
            raise AssertionError(f"{label} and 7a generated from different prompts")
        # equal to 7a's up to a first difference at a near-tie
        ties = first_difference(model, f"{label} vs 7a streams", got, want, prompts)
        same = sum(g == w for g, w in zip(got, want))
        print(f"{label[:2]} vs 7a: {same} of {len(got)} streams identical; first differences "
              f"at near-ties (row, token, top-2 gap): {ties}", flush=True)
    # every token of every stream against a teacher-forced forward
    for label, rec in ((la, rec_a), (lb, rec_b), (ld, rec_d)):
        t0 = time.perf_counter()
        gap, n, off, _ = hold_streams(model, label, [s for t in rec.tasks for s in t["streams"]],
                                   [p for t in rec.tasks for p in t["prompts"]], rec.max_new,
                                   rec.ends)
        out[label]["teacher_forced"] = dict(tokens=n, not_argmax=off, max_gap=round(gap, 4))
        print(f"{label[:2]} streams vs teacher-forced forwards: {n} tokens, {off} not the argmax, "
              f"largest gap {gap:.4f} (tie margin {TIE_MARGIN}; "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
    del model, rec_d.model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 8
# Qwen2-VL, the default family of every shipped mm config: configs/mm/
# {finetune,forget,eval}.yaml run as they ship (qwen-vl2-2b in bf16 from seed
# 42: finetune LoRA r 8 with the merger's adapters, batch 4, accumulation 2;
# forget at LoRA.r=0 with grad_diff_forget_ce_retain_ce, batch 2,
# accumulation 4, AdamW at lr 1e-5; eval as phase 7 runs it) but for the
# data, the step counts, ds_size and save_dir; then serve.yaml as it ships
# (the int8 W8A16 decoder) on what 8b saved, and the int8 cache dense, paged
# on a pool that forces growth, and paged with speculation; then
# Qwen2.5-VL-3B (qwen-vl-3b, the windowed tower) from its seed in bf16.
QWEN_DATA = "synthetic:n_persons=40,qa_per_person=4"
QWEN_FINETUNE_ARGS = [f"data_path={QWEN_DATA}",
                      "num_epochs=0.075"]  # 320 rows, 8 a step: 3 steps, no state save
QWEN_FORGET_ARGS = [f"forget_data_path={QWEN_DATA}", f"retain_data_path={QWEN_DATA}",
                    "num_epochs=0.75"]  # 32 forget rows, 8 a step: 3 steps, no state save
QWEN_EVAL_ARGS = ["model_family=qwen-vl2-2b", "ds_size=8",
                  f"data_path=[{','.join([EVAL_DATA] * 6)}]"]
# 8a: the bf16 model (4.9 GB), f32 adapters, activations of 4 rows (read
# 13.97 on an H100 80GB HBM3 at 700 W); 8b: the model, its bf16 gradients,
# the f32 accumulator, AdamW's bf16 moments (~24 GB) and activations of 2
# rows (read 26.69); 8g the same with the tower trained, its activations
# kept, and the check's two gradient trees (read 39.68); 8h the int4 base,
# f32 adapters and activations of 2 rows (read 9.82); 8i Qwen2.5-VL-3B's 3.8 B
# parameters, their f32 sums over accumulation 2, AdamW's moments and the
# check's two gradient trees (read 51.38); each with ~15% room
QWEN_PEAK_BOUND_GIB = {"8a finetune": 24.0, "8b forget r0": 40.0,
                       "8g forget r0, trainable tower": 45.6,
                       "8h forget, QLoRA r 8 over an int4 base": 11.3,
                       "8i finetune qwen-vl-3b, trainable tower": 59.1}
# the QLoRA step's adapter gradients over the int4 base against those over
# its dequantized bf16 copy: the same weights, rounded at other places
QLORA_GRAD_COS = 0.99
QWEN_TIGHT_POOL = 17  # pages of 128: six requests that grow to 3-4 pages each
QWEN_NEW = 160  # tokens a served request asks for: past its first pages


class _ForwardCounts:
    """While active, counts the serving engine's forwards by kind: prompt
    forwards (``prefill``; those with an image also as ``image``), one-token
    decode steps (``decode``) and chunk passes (``chunk``: verify rounds,
    prefill chunks and prefix suffixes); the kernels' launches follow from
    them (``expected``)."""

    def __enter__(self):
        counts = self.counts = collections.Counter()
        self._orig = orig = ServingEngine._forward

        def forward(engine, ids, **kw):
            if kw.get("chunk_decode"):
                counts["chunk"] += 1
            elif ids.shape[1] == 1:
                counts["decode"] += 1
            else:
                counts["prefill"] += 1
            counts["image"] += kw.get("pixel_values") is not None
            return orig(engine, ids, **kw)

        ServingEngine._forward = forward
        return self

    def __exit__(self, *exc):
        ServingEngine._forward = self._orig

    def expected(self, mcfg, decode_kernel, chunk_kernel=None):
        L = mcfg.decoder.num_layers
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want["flash_fwd"] = self.counts["prefill"] * L + self.counts["image"] * vision_launches(
            mcfg.vision)
        want[decode_kernel] += self.counts["decode"] * L
        if chunk_kernel:
            want[chunk_kernel] += self.counts["chunk"] * L
        return want


def _qwen_requests(processor, n, seed):
    """``n`` requests as cli/serve.py forms them: every other one with an
    image (uint8, 200x300: resized to the tower's 336 px), questions of
    mixed length.  (ids, max_new, patches or None, image or None)."""
    rng = np.random.default_rng(seed)
    words = "who is shown here and what is the name of the person in this photo".split()
    out = []
    for i in range(n):
        img = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8) if i % 2 == 0 else None
        q = " ".join(rng.choice(words, size=6 + 9 * i)) + "?"
        ids = processor._encode_expand(processor.format(q, None, img is not None))
        pix = None if img is None else serve.load_image(img, processor)
        out.append((ids, QWEN_NEW, pix, img, q))
    return out


def _check_launches(label, launches, want):
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")


def _cli_serve(argv):
    """``cli.serve.main(argv)`` with its engine, its requests, wall s, peak
    GiB, launches and forward counts kept: (rows, engine, requests, wall,
    peak, launches, forward counts)."""
    seen = {}
    build, submit = serve.build_engine, ServingEngine.submit

    def build_wrapper(*a, **kw):
        out = build(*a, **kw)
        seen["engine"] = out[0]
        return out

    def submit_wrapper(engine, *a, **kw):
        req = submit(engine, *a, **kw)
        seen.setdefault("reqs", []).append(req)
        return req

    serve.build_engine, ServingEngine.submit = build_wrapper, submit_wrapper
    try:
        with _ForwardCounts() as fc:
            t0 = time.perf_counter()
            results, peak, launches = _measured(lambda: serve.main(argv))
            wall = time.perf_counter() - t0
    finally:
        serve.build_engine, ServingEngine.submit = build, submit
    return results, seen["engine"], seen["reqs"], wall, peak, launches, fc


def _qwen_serve(ckpt_dir, tmp, serve_base=()):
    """8d: cli/serve.py's ``main`` on configs/mm/serve.yaml as it ships with
    model_family=qwen-vl2-2b and ``model_path`` (the int8 W8A16 decoder,
    the bf16 cache), every stream held against teacher-forced forwards;
    then on the same quantized model the int8 cache dense (B4q), paged on
    a tight pool (B6q; growth and preemption asserted) and paged with
    speculation (B7q), the last two held against the dense int8 run.
    Returns ({run: launches}, the model)."""
    from PIL import Image

    model_cfg = serve.get_model_identifiers("qwen-vl2-2b")
    processor = common.build_processor(model_cfg)
    specs = _qwen_requests(processor, 6, 8)
    req_file, out_file = os.path.join(tmp, "requests.jsonl"), os.path.join(tmp, "out.jsonl")
    with open(req_file, "w") as f:
        for i, (_, n, _, img, q) in enumerate(specs):
            path = None
            if img is not None:
                path = os.path.join(tmp, f"image{i}.png")
                Image.fromarray(img).save(path)
            f.write(json.dumps({"question": q, "image": path, "max_new_tokens": n}) + "\n")
    base = ["model_family=qwen-vl2-2b", f"model_path={ckpt_dir}", f"requests={req_file}",
            f"save_file={out_file}", *serve_base]
    results, engine, reqs, wall, peak, launches, fc = _cli_serve(base)
    model, mcfg = engine.params, engine.model_cfg
    label = "8d serve.yaml as it ships (int8 W8A16, bf16 cache)"
    if not isinstance(model.language_model.layers.q_proj, quantize.QTensor):
        raise AssertionError(f"{label}: the decoder is not int8")
    _check_launches(label, launches, fc.expected(mcfg, "flash_decode"))
    for r, res in zip(reqs, results):
        if not r.done or res["tokens"] != len(r.tokens) or not (
                len(r.tokens) == QWEN_NEW or r.finish_reason == "eos"):
            raise AssertionError(f"{label}: request {r.uid} ended with {len(r.tokens)} tokens "
                                 f"({r.finish_reason!r})")
    prompts = [(ids, pix) for ids, _, pix, *_ in specs]
    if [list(r.prompt_ids) for r in reqs] != [p[0] for p in prompts] or any(
            (r.pixel_values is None) != (p[1] is None) or (
                p[1] is not None and not np.array_equal(r.pixel_values, p[1]))
            for r, p in zip(reqs, prompts)):
        raise AssertionError(f"{label}: the CLI formed other prompts or patches than expected")
    gap, n, off, _ = hold_streams(model, label, [r.tokens for r in reqs], prompts, QWEN_NEW,
                               (engine.eos, engine.pad_id), engine.compute_dtype)
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"{label}: main() {wall:.1f} s (load, quantize, serve); {len(reqs)} requests, {n_tok} "
          f"tokens; forwards {dict(fc.counts)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; streams vs teacher-forced forwards: "
          f"{n} tokens, {off} not the argmax, largest gap {gap:.4f} (tie margin {TIE_MARGIN}); "
          f"max_memory_allocated {peak:.2f} GiB", flush=True)
    out = {"d_shipped": launches}
    engine._state = None
    del engine
    cfg = serve.load_config(base + ["kv_cache_dtype=int8"])
    jobs = [(ids, n, pix, None, None) for ids, n, pix, *_ in specs]
    ref = None
    for key, extra, dkern, ckern in (
            ("d_int8_cache", {}, "flash_decode_q8", None),
            ("d_int8_paged", {"page_size": 128, "kv_pool_pages": QWEN_TIGHT_POOL},
             "paged_decode_q8", None),
            ("d_int8_paged_spec", {"page_size": 128, "kv_pool_pages": QWEN_TIGHT_POOL,
                                    "speculative_k": 4}, "paged_decode_q8", "paged_chunk_q8")):
        engine, _, _, _ = serve.build_engine(Config(dict(cfg, **extra)), model=model)
        with _ForwardCounts() as fc:
            reqs, wall, launches, peak = _serve(engine, jobs)
        label = f"8d {key} ({', '.join(f'{k}={v}' for k, v in extra.items()) or 'dense'})"
        _check_launches(label, launches, fc.expected(mcfg, dkern, ckern))
        if launches[ckern or dkern] == 0:
            raise AssertionError(f"{label}: {ckern or dkern} never launched")
        st = engine.stats()
        if key == "d_int8_paged" and st["preemptions"] < 1:
            raise AssertionError(f"{label}: the pool preempted no slot")
        _report(label, engine, reqs, wall, launches, peak)
        if ref is None:
            ref = [r.tokens for r in reqs]
        else:
            ties = first_difference(model, label, [r.tokens for r in reqs], ref, prompts,
                                    engine.compute_dtype)
            print(f"{label} vs the dense int8-cache run: streams agree up to first differences "
                  f"at near-ties {ties}; pool peak {st.get('pool_pages_peak')} pages, "
                  f"{st.get('preemptions')} preemptions (tie margin {TIE_MARGIN})", flush=True)
        out[key] = launches
        engine._state = None
        del engine
        torch.cuda.empty_cache()
    return out, model


QWEN_ADAPTERS = [None, "ft", "rnd", "rnd", "ft", None]  # request i's adapter (even i: an image)
QWEN_8F_RUNS = ("8f_mixed", "8f_only_base", "8f_only_ft", "8f_only_rnd", "8f_int8_prefix",
                "8f_int8_paged_prefix", "8f_int8_paged_spec_prefix", "8f_sampled",
                "8f_sampled_reversed", "8f_generate")
# "rnd"'s b: each product a ~ N(0, 1/in) gives ~N(0, 1) entries, so its
# delta (scale 4, r 8) moves a projection's output by ~0.2 of its own spread
RND_B_STD = 0.02
SAMPLED = dict(temperature=0.7, top_k=50, top_p=0.9)
SAMPLE_SEEDS = [1000 + i for i in range(6)]


def _adapter_kw(adapters, name):
    """A teacher-forced forward's arguments for adapter ``name`` (none for
    the base model)."""
    if name is None:
        return {}
    tree, scale = adapters[name]
    return {"lora": tree, "lora_scale": scale}


def hold_sampled(model, label, streams, prompts, seeds, max_new, ends, dtype=torch.bfloat16,
                 **sample):
    """Every token of every sampled stream against one teacher-forced
    forward of ``model`` over the stream's prompt and the stream, with the
    sampler's own noise: token j of the stream seeded s must be the argmax
    of the scaled logits plus ``gumbel(fold_in(key(s), j))`` over the top-k /
    top-p support, or within TIE_MARGIN of it, and so must the better of
    ``ends`` where a stream shorter than ``max_new`` stopped.  bf16 noise
    moves the support's edge too: a token whose scaled logit lies within
    TIE_MARGIN of the lowest one kept counts as inside, and the argmax it is
    held against is taken over the tokens that lie TIE_MARGIN or more above
    that edge.  Returns (largest gap, tokens checked, tokens that were not
    the perturbed argmax)."""
    from multimodal_unlearning_tpu_torch.evaluation import sampling

    dev = next(model.parameters()).device
    worst, n_all, off = 0.0, 0, 0
    for i, (s, (ids, pix), seed) in enumerate(zip(streams, prompts, seeds)):
        seq = torch.tensor([list(ids) + list(s)], device=dev)
        pv = None if pix is None else torch.from_numpy(np.asarray(pix)[None]).to(dev, dtype)
        with torch.inference_mode():
            logits = model(seq, pixel_values=pv, compute_dtype=dtype,
                           positions=_tf_positions(model, ids, len(s)))["logits"][0].float()
            n = len(s) + (len(s) < max_new)  # the stop's position too
            lg = logits[len(ids) - 1:len(ids) - 1 + n]
            key = sampling.row_keys(torch.full((1,), seed, device=dev))
            keys = sampling.fold_in(key.expand(n, 2), torch.arange(n, device=dev))
            scaled = sampling.process_logits(lg, sample["temperature"])
            masked = sampling.process_logits(lg, **sample)
            edge = torch.where(torch.isfinite(masked), scaled, float("inf")).amin(
                dim=-1, keepdim=True)
            z = scaled + sampling.gumbel(keys, lg.shape[-1])
            top = torch.where(scaled >= torch.minimum(edge + TIE_MARGIN, scaled.amax(
                dim=-1, keepdim=True)), z, float("-inf")).amax(dim=-1)
            z = torch.where(scaled >= edge - TIE_MARGIN, z, float("-inf"))
            tok = torch.tensor(s, dtype=torch.long, device=dev)
            gaps = top[:len(s)] - z[torch.arange(len(s), device=dev), tok]
            if len(s) < max_new:
                end = [e for e in ends if e is not None and e >= 0]
                gaps = torch.cat([gaps, (top[len(s)] - z[len(s), end].max())[None]])
        j = int(torch.argmax(gaps))
        gap = float(gaps[j])
        if not gap <= TIE_MARGIN:
            raise AssertionError(f"{label}: sampled stream {i} (seed {seed}) token {j} of "
                                 f"{len(s)} lies {gap:.4f} below the perturbed teacher-forced "
                                 f"argmax (tie margin {TIE_MARGIN})")
        worst, n_all, off = max(worst, gap), n_all + n, off + int((gaps > 0).sum())
    return worst, n_all, off


def _diverged(a, b) -> int:
    return sum(x != y for x, y in zip(a, b))


STEP_COST_CHUNK = 4  # decode steps a profiled dispatch holds: the profiler's
# processing of a 16-step chunk (~40,000 device kernels) took ~30 s a case


def _step_costs(model, cfg, dirs, ids):
    """Decode-step costs of one steady chunk with every slot live: the base
    model greedy, one adapter live on every slot, two adapters live, and the
    base model sampled.  Returns {case: (ms per step unprofiled, device
    kernels per step, device ms per step)}; the bank's and the sampler's
    shares are the differences from the base case."""
    out = {}
    for key, extra, names in (
            ("base", dict(adapters=None), [None]),
            ("one_adapter", dict(adapters=dirs), ["ft"]),
            ("two_adapters", dict(adapters=dirs), ["ft", "rnd"]),
            ("sampled", dict(adapters=None, **SAMPLED), [None])):
        engine, *_ = serve.build_engine(Config(dict(cfg, logprobs=False, chunk=STEP_COST_CHUNK,
                                                    **extra)), model=model)
        budget = 1 + 6 * engine.chunk
        reqs = [engine.submit(ids, budget, adapter=names[b % len(names)])
                for b in range(engine.B)]
        engine.step()  # prefills every slot and dispatches the first chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            engine.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (4 * engine.chunk)
        _, dev_ms, n_kernels, _ = profiled(engine.step)
        engine.run()
        if not all(r.done and (len(r.tokens) == budget or r.finish_reason == "eos")
                   for r in reqs):
            raise AssertionError(f"8f step costs ({key}): a request ended early")
        out[key] = (round(step_ms, 3), n_kernels / engine.chunk, round(dev_ms / engine.chunk, 4))
        engine._state = None
    base = out["base"]
    print(f"8f decode step costs, {len(ids)}-token prompts, all slots live (ms unprofiled, "
          f"device kernels, device ms per step): {out}; the bank adds "
          f"{out['one_adapter'][1] - base[1]:.1f} (one adapter) / "
          f"{out['two_adapters'][1] - base[1]:.1f} (two) kernels and "
          f"{out['two_adapters'][2] - base[2]:.4f} device ms a step; the sampler adds "
          f"{out['sampled'][1] - base[1]:.1f} kernels and {out['sampled'][2] - base[2]:.4f} "
          f"device ms a step", flush=True)
    return out


def _qwen_adapters(fg_dir, ft_dir, model, tmp, serve_base=()):
    """8f: the rest of configs/mm/serve.yaml on Qwen2-VL-2B.  8b's checkpoint
    quantized through ``cli.quantize_model.main``; adapters "ft" (8a's,
    saved as trained) and "rnd" (decoder and merger, r 8, alpha 32, random
    ``b``); ``cli.serve.main`` on the quantized checkpoint with both and
    ``logprobs=true``, six requests (three with the image) on the base, "ft"
    and "rnd": (a) each stream equals, up to a first near-tie, its stream from
    an engine that holds only its adapter, and each adapter changes some
    stream; (b) every token is held against a teacher-forced forward with its
    adapter, and every logprob within LOGIT_TOL of that forward's
    log_softmax; (c) the same mix on an int8 cache with a system prompt
    registered per adapter, dense (B4q, B5q), paged (B6q, B7q) and paged with
    K 4 (B7q), held the same way; (d) sampled (temperature 0.7, top-k 50,
    top-p 0.9, the bf16 cache) in two submission orders and through
    ``greedy_generate(do_sample=True)``, every token held against the
    sampler's own noise on teacher-forced logits.  Then the decode step's
    cost with 0, 1 and 2 adapters live and sampled.  ``model``: 8d's int8
    model, for the adapters' shapes.  Returns each run's launches and, under
    "8f_numbers", what it printed."""
    from multimodal_unlearning_tpu_torch.cli import quantize_model
    from multimodal_unlearning_tpu_torch.evaluation.generate import greedy_generate, pad_prompts
    from multimodal_unlearning_tpu_torch.models import lora as tlora
    from multimodal_unlearning_tpu_torch.train.checkpoints import load_adapter, save_adapter
    from multimodal_unlearning_tpu_torch.utils.pytree import tree_map_with_path

    t_start = time.perf_counter()
    out, numbers, laps = {}, {}, {}

    def lap(name):  # seconds since the last lap
        laps[name] = round(time.perf_counter() - t_start - sum(laps.values()), 1)

    dev = next(model.parameters()).device
    q_dir = os.path.join(tmp, "int8")
    # configs/quantize.yaml has no device key: the serve overrides' device
    # is added (+device=), the others set
    sizes = quantize_model.main(["model_family=qwen-vl2-2b", f"model_path={fg_dir}",
                                 f"save_dir={q_dir}", "bits=int8",
                                 *(("+" if a.startswith("device=") else "") + a
                                   for a in serve_base)])
    lap("quantize")
    numbers["quantized_gib"] = round(sizes["quant_bytes"] / 2**30, 3)
    gen = torch.Generator(device=dev).manual_seed(13)
    rnd = tlora.init_model_lora(model, 8, gen)
    rnd = tree_map_with_path(lambda p, x: (torch.randn(x.shape, generator=gen, device=dev)
                                           * RND_B_STD if p[-1] == "b" else x).detach(), rnd)
    dirs = {"ft": ft_dir, "rnd": os.path.join(tmp, "adapter_rnd")}
    save_adapter(dirs["rnd"], rnd, 32 / 8)
    del rnd
    adapters = {n: load_adapter(d, device=dev) for n, d in dirs.items()}

    model_cfg = serve.get_model_identifiers("qwen-vl2-2b")
    processor = common.build_processor(model_cfg)
    specs = _qwen_requests(processor, 6, 8)
    req_file, out_file = os.path.join(tmp, "requests_8f.jsonl"), os.path.join(tmp, "out_8f.jsonl")
    with open(req_file, "w") as f:
        for i, ((_, n, _, img, q), name) in enumerate(zip(specs, QWEN_ADAPTERS)):
            path = None
            if img is not None:
                from PIL import Image

                path = os.path.join(tmp, f"image8f_{i}.png")
                Image.fromarray(img).save(path)
            f.write(json.dumps({"question": q, "image": path, "max_new_tokens": n,
                                "adapter": name}) + "\n")
    base = ["model_family=qwen-vl2-2b", f"model_path={q_dir}", f"requests={req_file}",
            f"save_file={out_file}", "logprobs=true",
            f"adapters={{ft: {dirs['ft']}, rnd: {dirs['rnd']}}}", *serve_base]
    rows, engine, reqs, wall, peak, launches, fc = _cli_serve(base)
    label = "8f mixed adapters (serve CLI on the quantized checkpoint, logprobs)"
    model, mcfg, dtype = engine.params, engine.model_cfg, engine.compute_dtype
    ends = (engine.eos, engine.pad_id)
    if not isinstance(model.language_model.layers.q_proj, quantize.QTensor):
        raise AssertionError(f"{label}: the checkpoint did not load as int8")
    _check_launches(label, launches, fc.expected(mcfg, "flash_decode"))
    for r, row, name in zip(reqs, rows, QWEN_ADAPTERS):
        if not r.done or not (len(r.tokens) == QWEN_NEW or r.finish_reason == "eos") or len(
                row["logprobs"]) != len(r.tokens) or r.lora_id != engine._adapter_ids[name]:
            raise AssertionError(f"{label}: request {r.uid} ({name}) ended with "
                                 f"{len(r.tokens)} tokens, {len(row['logprobs'])} logprobs")
    prompts = [(ids, pix) for ids, _, pix, *_ in specs]
    extras = [_adapter_kw(adapters, n) for n in QWEN_ADAPTERS]
    streams = [r.tokens for r in reqs]
    gap, n, off, lp_gap = hold_streams(model, label, streams, prompts, QWEN_NEW, ends, dtype,
                                       extras=extras, logprobs=[r.logprobs for r in reqs])
    _report(label, engine, reqs, wall, launches, peak)
    print(f"{label}: streams vs teacher-forced forwards with their adapters: {n} tokens, {off} "
          f"not the argmax, largest gap {gap:.4f}; logprobs vs its log_softmax: largest "
          f"difference {lp_gap:.4f} (tol {LOGIT_TOL})", flush=True)
    numbers["mixed"] = dict(wall_s=round(wall, 2), max_gap=round(gap, 4),
                            max_logprob_diff=round(lp_gap, 4))
    out["8f_mixed"] = launches
    lap("mixed")
    cfg = serve.load_config(base)
    engine._state = None
    del engine

    # (a) engines that hold one adapter each, all six requests on it
    jobs = [(ids, n, pix, None, None) for ids, n, pix, *_ in specs]
    ref = {}
    for name in (None, "ft", "rnd"):
        eng, *_ = serve.build_engine(Config(dict(
            cfg, logprobs=False, adapters=None if name is None else {name: dirs[name]})),
            model=model)
        with _ForwardCounts() as fc:
            r_n, wall_n, launches_n, peak_n = _serve(eng, jobs, extra=[{"adapter": name}] * 6)
        key = f"8f_only_{name or 'base'}"
        _check_launches(key, launches_n, fc.expected(mcfg, "flash_decode"))
        ref[name] = [r.tokens for r in r_n]
        out[key] = launches_n
        eng._state = None
        del eng
    ties = first_difference(model, "8f (a)", streams,
                            [ref[name][i] for i, name in enumerate(QWEN_ADAPTERS)], prompts,
                            dtype, extras=extras)
    changed = {name: _diverged(ref[name], ref[None]) for name in ("ft", "rnd")}
    if not all(changed.values()):
        raise AssertionError(f"8f (a): an adapter changed no stream of the six: {changed}")
    print(f"8f (a) mixed vs single-adapter engines: streams agree up to first differences at "
          f"near-ties {ties}; streams each adapter changes (of 6, vs the base engine) "
          f"{changed}", flush=True)
    numbers["a"] = dict(near_ties=ties, changed=changed)
    lap("single_adapter_engines")

    # (c) an int8 cache and a system prompt registered per adapter
    system = processor.tokenizer.encode(SYSTEM_PROMPT, add_special_tokens=True)
    full = [(ids if pix is not None else list(system) + list(ids), pix) for ids, pix in prompts]
    for key, extra, dkern, ckern in (
            ("8f_int8_prefix", {}, "flash_decode_q8", "chunk_decode_q8"),
            ("8f_int8_paged_prefix", {"page_size": 128}, "paged_decode_q8", "paged_chunk_q8"),
            ("8f_int8_paged_spec_prefix", {"page_size": 128, "speculative_k": 4},
             "paged_decode_q8", "paged_chunk_q8")):
        eng, *_ = serve.build_engine(Config(dict(cfg, kv_cache_dtype="int8", **extra)),
                                     model=model)
        with _ForwardCounts() as fc:
            kernels.reset_launch_counts()
            pre = {name: eng.register_prefix(system, adapter=name) for name in (None, "ft", "rnd")}
            r_c, wall_c, launches_c, peak_c = _serve(
                eng, [(ids, n, pix, None, None if pix is not None else pre[name])
                      for (ids, n, pix, *_), name in zip(jobs, QWEN_ADAPTERS)],
                counted=False, extra=[{"adapter": name} for name in QWEN_ADAPTERS])
        _check_launches(key, launches_c, fc.expected(mcfg, dkern, ckern))
        want = [ckern] if eng.K else [dkern, ckern]
        if not all(launches_c[k] for k in want):
            raise AssertionError(f"{key}: {want} did not all launch: {launches_c}")
        g_c, n_c, off_c, lp_c = hold_streams(model, key, [r.tokens for r in r_c], full, QWEN_NEW,
                                             ends, dtype, extras=extras,
                                             logprobs=[r.logprobs for r in r_c])
        _report(key, eng, r_c, wall_c, launches_c, peak_c)
        print(f"{key}: streams vs teacher-forced forwards over system prompt + question with "
              f"their adapters: {n_c} tokens, {off_c} not the argmax, largest gap {g_c:.4f}; "
              f"logprobs largest difference {lp_c:.4f}; streams differing from the mixed "
              f"run's {_diverged([r.tokens for r in r_c], streams)} of 6", flush=True)
        numbers[key] = dict(max_gap=round(g_c, 4), max_logprob_diff=round(lp_c, 4),
                            tokens_per_round=round(eng.stats()["tokens_per_round"], 3))
        out[key] = launches_c
        eng._state = None
        del eng
        torch.cuda.empty_cache()
        lap(key[3:])

    # (d) sampled, bf16 cache, base model: two submission orders, then
    # greedy_generate(do_sample=True) on the same prompts and seeds
    sampled = {}
    cfg_s = Config(dict(cfg, logprobs=False, adapters=None, **SAMPLED))
    for key, order in (("8f_sampled", list(range(6))), ("8f_sampled_reversed",
                                                        list(range(5, -1, -1)))):
        eng, *_ = serve.build_engine(cfg_s, model=model)
        with _ForwardCounts() as fc:
            r_s, wall_s, launches_s, _ = _serve(eng, [jobs[i] for i in order],
                                                extra=[{"sample_seed": SAMPLE_SEEDS[i]}
                                                       for i in order])
        _check_launches(key, launches_s, fc.expected(mcfg, "flash_decode"))
        got = [None] * 6
        for r, i in zip(r_s, order):
            got[i] = r.tokens
        sampled[key] = got
        out[key] = launches_s
        eng._state = None
        del eng
    pad = processor.tokenizer.pad_token_id
    ids_b, mask_b = pad_prompts([list(ids) for ids, _ in prompts], pad)
    pix0 = next(pix for _, pix in prompts if pix is not None)
    pix_b = np.stack([pix0 * 0 if pix is None else pix for _, pix in prompts])
    with torch.inference_mode():
        (toks, stats), peak_g, launches_g = _measured(lambda: greedy_generate(
            model, mcfg, ids_b, mask_b, max_new_tokens=QWEN_NEW, pad_token_id=pad,
            eos_token_id=processor.tokenizer.eos_token_id, pixel_values=pix_b, is_vlm=True,
            cache_dtype=dtype, compute_dtype=dtype, do_sample=True, sample_seeds=SAMPLE_SEEDS,
            return_stats=True, **SAMPLED))
    L = mcfg.decoder.num_layers
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want["flash_fwd"] = L + vision_launches(mcfg.vision)
    want["flash_decode"] = stats["forwards"] * L
    _check_launches("8f_generate", launches_g, want)
    out["8f_generate"] = launches_g
    gen_streams = []
    for row in toks.tolist():
        cut = next((t for t, x in enumerate(row) if x == pad), len(row))
        gen_streams.append(row[:cut])
    sampled["8f_generate"] = gen_streams
    held = {}
    for key, st in sampled.items():
        held[key] = hold_sampled(model, key, st, prompts, SAMPLE_SEEDS, QWEN_NEW,
                                 (processor.tokenizer.eos_token_id, pad), dtype,
                                 **SAMPLED)
    div = {"reversed": _diverged(sampled["8f_sampled"], sampled["8f_sampled_reversed"]),
           "generate": _diverged(sampled["8f_sampled"], sampled["8f_generate"])}
    print(f"8f (d) sampled {SAMPLED}: every token vs the perturbed teacher-forced argmax "
          f"(largest gap, tokens, not the argmax) {held}; streams diverging from the first "
          f"order's (of 6): {div}", flush=True)
    numbers["d"] = dict(held={k: (round(v[0], 4), v[1], v[2]) for k, v in held.items()},
                        diverged=div)
    lap("sampled")

    text_ids = prompts[1][0]
    numbers["step_costs"] = _step_costs(model, cfg, dirs, text_ids)
    lap("step_costs")
    numbers["seconds"] = round(time.perf_counter() - t_start, 1)
    numbers["laps"] = laps
    print(f"8f: {numbers['seconds']} s in all ({laps})", flush=True)
    out["8f_numbers"] = numbers
    return out


def _qwen25_serve(serve_base=()):
    """8e: Qwen2.5-VL-3B (the windowed tower; 16 q-heads on 2 kv-heads)
    from its seed in bf16 through build_engine: prefill logits of the
    kernels against plain attention, then four requests with images served
    to their budgets, streams held against teacher-forced forwards."""
    logits = {}
    cfg = serve.load_config(["model_family=qwen-vl-3b", "quantize_base=false", "seed=0",
                             *serve_base])
    engine, processor, _, mcfg = serve.build_engine(
        cfg, on_prefill=lambda r, last: logits.__setitem__(r.uid, last.float().cpu()))
    specs = [s for s in _qwen_requests(processor, 8, 9) if s[2] is not None][:4]
    jobs = [(ids, n, pix, None, None) for ids, n, pix, *_ in specs]
    with _ForwardCounts() as fc:
        reqs, wall, launches, peak = _serve(engine, jobs)
    label = "8e qwen-vl-3b (bf16, windowed tower)"
    _check_launches(label, launches, fc.expected(mcfg, "flash_decode"))
    _report(label, engine, reqs, wall, launches, peak)
    model = engine.params
    plain = prefill_logits_of(engine, model, "plain", engine.compute_dtype,
                              [(ids, n, pix) for ids, n, pix, *_ in specs])
    d = [(logits[r.uid] - p).abs().max().item() for r, p in zip(reqs, plain)]
    if max(d) > LOGIT_TOL or not all(torch.isfinite(logits[r.uid]).all() for r in reqs):
        raise AssertionError(f"{label}: prefill logits vs plain attention {d} (tol {LOGIT_TOL})")
    prompts = [(ids, pix) for ids, _, pix, *_ in specs]
    gap, n, off, _ = hold_streams(model, label, [r.tokens for r in reqs], prompts, QWEN_NEW,
                               (engine.eos, engine.pad_id), engine.compute_dtype)
    print(f"{label}: prefill logits vs plain attention max|diff| {[round(x, 4) for x in d]} "
          f"(tol {LOGIT_TOL}); streams vs teacher-forced forwards: {n} tokens, {off} not the "
          f"argmax, largest gap {gap:.4f}; B1 launches per image forward "
          f"{vision_launches(mcfg.vision)} (windowed blocks "
          f"{mcfg.vision.depth - len(mcfg.vision.fullatt_block_indexes)}, full "
          f"{len(mcfg.vision.fullatt_block_indexes)})", flush=True)
    engine._state = None
    return launches


def run_qwen_path(sync=torch.cuda.synchronize, finetune_args=QWEN_FINETUNE_ARGS,
                  forget_args=QWEN_FORGET_ARGS, eval_args=QWEN_EVAL_ARGS, serve_base=()):
    """8a finetune, 8b forget, 8c evaluate, 8d serve Qwen2-VL-2B through
    the CLIs, 8f quantize and serve it with adapters, logprobs and
    sampling; 8e serve Qwen2.5-VL-3B.  Returns each sub-phase's launches
    (and 8c's and 8f's numbers under "8c_numbers" and "8f_numbers")."""
    import shutil
    import tempfile

    from multimodal_unlearning_tpu_torch.cli import mm_calculate_metrics, mm_finetune, mm_forget
    from multimodal_unlearning_tpu_torch.train.checkpoints import save_adapter

    tmp = tempfile.mkdtemp(prefix="qwen_")
    ft_dir, fg_dir = os.path.join(tmp, "finetune"), os.path.join(tmp, "forget")
    ft_adapter = os.path.join(tmp, "adapter_ft")
    out = {}
    try:
        # 8a: finetune.yaml as it ships, LoRA r 8 (the merger's adapters too)
        with _CliRecorder(mm_finetune) as rec:
            t0 = time.perf_counter()
            _, peak, launches = _measured(lambda: mm_finetune.main(
                finetune_args + [f"save_dir={ft_dir}"]))
            wall = time.perf_counter() - t0
        mcfg, cfg = rec.apply_kw[0][1], rec.step_args[1]
        accum = cfg["grad_accum"]
        _check_steps("8a finetune", rec.steps)
        if accum != 2 or rec.apply_kw[1]["lora_cfg"] != 32 / 8:
            raise AssertionError(f"8a: not finetune.yaml's LoRA r 8 / accumulation 2: {cfg}")
        adapters = rec.loop["state"].trainable
        if set(adapters["projector"]) != {"fc1", "fc2"}:
            raise AssertionError("8a: no adapters on the merger")
        # 8f serves them as adapter "ft", as trained (alpha / r = 4)
        save_adapter(ft_adapter, adapters, rec.apply_kw[1]["lora_cfg"])
        _check_launches("8a finetune", launches, _expected_launches(
            "retain_ft", {}, mcfg.decoder, mcfg.vision, steps=len(rec.steps) * accum))
        print(f"8a finetune: main() {wall:.1f} s (init, steps, merge, save of "
              f"{os.path.getsize(f'{ft_dir}/model.safetensors') / 1e9:.2f} GB)", flush=True)
        _report_steps("8a finetune", rec.steps, launches, peak, QWEN_PEAK_BOUND_GIB)
        out["8a"] = launches
        del rec, adapters
        gc.collect()
        torch.cuda.empty_cache()

        # 8b: forget.yaml as it ships from 8a's checkpoint: LoRA.r=0, accumulation 4
        with _CliRecorder(mm_forget) as rec:
            t0 = time.perf_counter()
            _, peak, launches = _measured(lambda: mm_forget.main(
                forget_args + [f"model_path={ft_dir}", f"save_dir={fg_dir}"]))
            wall = time.perf_counter() - t0
        accum, loss = rec.step_args[1]["grad_accum"], rec.step_args[1]["loss_type"]
        _check_steps("8b forget r0", rec.steps)
        losses = [m["loss"] for m in rec.steps]
        if accum != 4 or loss != "grad_diff_forget_ce_retain_ce" or rec.apply_kw[1][
                "lora_cfg"] != 0.0 or len(set(losses)) < 2:
            raise AssertionError(f"8b: not forget.yaml's run (accumulation {accum}, {loss}) or "
                                 f"the loss did not move: {losses}")
        _check_launches("8b forget r0", launches, _expected_launches(
            loss, {}, mcfg.decoder, mcfg.vision, steps=len(rec.steps) * accum))
        print(f"8b forget r0 (configs/mm/forget.yaml as it ships: LoRA.r=0, batch 2 x "
              f"accumulation 4, {loss}, AdamW): main() {wall:.1f} s (load, steps, save); peak "
              f"device memory {peak:.2f} GiB", flush=True)
        _report_steps("8b forget r0", rec.steps, launches, peak, QWEN_PEAK_BOUND_GIB)
        out["8b"] = launches
        del rec
        gc.collect()
        torch.cuda.empty_cache()

        # 8g: forget.yaml as it ships from 8a's checkpoint with the tower trained
        processor = common.build_processor(serve.get_model_identifiers("qwen-vl2-2b"))
        out["8g"], out["8g_by_d"] = _tower_cli_run(
            "8g forget r0, trainable tower", mm_forget,
            forget_args + [f"model_path={ft_dir}", "freeze_vision_module=false",
                           "save_model=false", f"save_dir={os.path.join(tmp, 'tower')}"],
            lambda: _loss_batch(loss, processor, "cuda", data=QWEN_DATA), QWEN_PEAK_BOUND_GIB)
        gc.collect()
        torch.cuda.empty_cache()
        # 8h: forget.yaml with LoRA r 8 over a grouped-int4 base (QLoRA), merged,
        # reloaded and served
        out["8h"] = _qwen_qlora_int4(ft_dir, tmp, forget_args, processor)
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(ft_dir, ignore_errors=True)

        # 8c: eval.yaml on 8b's checkpoint, then the metrics CLI
        argv = eval_args + [f"model_path={fg_dir}", f"processor_path={fg_dir}",
                                 f"save_dir={os.path.join(tmp, 'eval')}"]
        agg, save_dir, rec, numbers = _eval_run("8c eval", argv, sync, 6)
        res = mm_calculate_metrics.main([f"ckpt_result={save_dir}/eval_log_aggregated.json",
                                         f"retain_result={save_dir}/eval_log_aggregated.json",
                                         f"save_file={os.path.join(tmp, 'metrics.json')}"])
        nums = [v for k, v in res.items() if k not in ("method", "submitted_by")]
        if not np.isfinite(nums).all():
            raise AssertionError(f"8c metrics: {res}")
        gap, n, off, _ = hold_streams(rec.model, "8c eval",
                                   [s for t in rec.tasks for s in t["streams"]],
                                   [p for t in rec.tasks for p in t["prompts"]], rec.max_new,
                                   rec.ends, next(rec.model.parameters()).dtype)
        print(f"8c streams vs teacher-forced forwards: {n} tokens, {off} not the argmax, largest "
              f"gap {gap:.4f}; metrics {json.dumps(res)}", flush=True)
        numbers["teacher_forced"] = dict(tokens=n, not_argmax=off, max_gap=round(gap, 4))
        out["8c"] = numbers["launches"]
        out["8c_numbers"] = numbers
        rec.model = None
        del rec
        gc.collect()
        torch.cuda.empty_cache()

        # 8d: serving what 8b saved
        served, model = _qwen_serve(fg_dir, tmp, serve_base)
        out.update({f"8{k}": v for k, v in served.items()})
        # 8f: 8b's checkpoint quantized, served with adapters, logprobs, sampling
        out.update(_qwen_adapters(fg_dir, ft_adapter, model, tmp, serve_base))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 8e: Qwen2.5-VL-3B
    out["8e"] = _qwen25_serve(serve_base)
    gc.collect()
    torch.cuda.empty_cache()
    # 8i: finetune.yaml steps of Qwen2.5-VL-3B with its windowed tower trained:
    # two, since the warmup's first step runs at lr 0
    tmp = tempfile.mkdtemp(prefix="qwen25_")
    try:
        processor = common.build_processor(serve.get_model_identifiers("qwen-vl-3b"))
        out["8i"], out["8i_by_d"] = _tower_cli_run(
            "8i finetune qwen-vl-3b, trainable tower", mm_finetune,
            ["model_family=qwen-vl-3b", "+model_path=null", f"data_path={QWEN_DATA}",
             "LoRA.r=0", "freeze_vision_module=false", "+save_model=false",
             "num_epochs=0.055", f"save_dir={tmp}"],  # 320 rows, 8 a step: 2 steps
            lambda: _finetune_batch(processor, "cuda", QWEN_DATA, 4), QWEN_PEAK_BOUND_GIB)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _dequantized(model):
    """A copy of ``model`` whose grouped-int4 leaves are bf16 weights with
    the values they stand for: the QLoRA step's dense reference."""
    import copy

    from torch import nn

    out = copy.deepcopy(model)
    for mod in list(out.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, quantize.QTensor4):
                delattr(mod, name)
                mod.register_parameter(name, nn.Parameter(
                    quantize.dequantize_leaf(child, torch.bfloat16), requires_grad=False))
    return out


def _qwen_qlora_int4(ft_dir, tmp, forget_args, processor, family="qwen-vl2-2b",
                     serve_extra=()):
    """8h: ``cli.mm_forget.main`` on forget.yaml from 8a's checkpoint with
    ``LoRA.r=8 quantize_base=int4`` (QLoRA), three steps, merged in bf16 and
    saved.  Before the first step: the first batch's loss and adapter
    gradients over the int4 base against the same over its dequantized bf16
    copy (loss within ``STEP_LOSS_TOL``, cosine ``QLORA_GRAD_COS`` on every
    adapter leaf).  The rows of every int4 product and the route each took
    (B8 up to ``INT4_MAX_KERNEL_ROWS``, the dequant route above; every
    backward through one dequantizes) are printed.  Then ``build_engine``
    reloads the merged checkpoint and serves four tokens of an image
    request.  Returns the launches of the CLI run."""
    from multimodal_unlearning_tpu_torch.cli import mm_forget
    from multimodal_unlearning_tpu_torch.train import trainer

    label = "8h forget, QLoRA r 8 over an int4 base"
    save_dir = os.path.join(tmp, "qlora")

    cli_kw = {}

    def before(rec, state):
        frozen = rec.loop["frozen"]
        n4 = sum(isinstance(m, quantize.QTensor4) for m in frozen.modules())
        if not n4:
            raise AssertionError(f"{label}: no int4 leaf in the base")
        (apply_fn, tx), step_kw = rec.step_args[0][:2], rec.step_args[1]
        # the CLI's own settings, before the check builds steps of its own
        cli_kw.update(accum=step_kw["grad_accum"], loss=step_kw["loss_type"],
                      scale=rec.apply_kw[1]["lora_cfg"], mcfg=rec.apply_kw[0][1])
        batch = _loss_batch(step_kw["loss_type"], processor, next(frozen.parameters()).device,
                            data=QWEN_DATA)
        grad_of = lambda base: trainer.make_train_step(  # noqa: E731
            apply_fn, tx, **dict(step_kw, grad_accum=1)).grad_fn(state.trainable, base, None,
                                                                 batch)
        (l4, _), g4 = grad_of(frozen)
        dense = _dequantized(frozen)
        (lb, _), gb = grad_of(dense)
        del dense
        cos = _grad_cosines(g4, gb)
        worst = min(cos, key=cos.get)
        print(f"{label}: {n4} int4 leaves; first batch over the int4 base vs its dequantized "
              f"bf16 copy: loss {float(l4):.5f} vs {float(lb):.5f} (tol {STEP_LOSS_TOL}); "
              f"adapter gradient cosine min {cos[worst]:.5f} at {worst}, median "
              f"{statistics.median(cos.values()):.5f} over {len(cos)} leaves (tol "
              f"{QLORA_GRAD_COS})", flush=True)
        if abs(float(l4) - float(lb)) > STEP_LOSS_TOL or cos[worst] < QLORA_GRAD_COS:
            raise AssertionError(f"{label}: int4 vs bf16 base: loss {float(l4)} vs {float(lb)}, "
                                 f"cosine {cos[worst]} at {worst}")
        quantize.INT4_DEQUANT_CALLS.clear()
        b8.INT4_BWD_CALLS.clear()
        rows.clear()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()

    quantize.INT4_DEQUANT_CALLS.clear()
    b8.INT4_BWD_CALLS.clear()
    with b8_rows() as rows, _CliRecorder(
            mm_forget, before_loop=before) as rec:
        t0 = time.perf_counter()
        _measured(lambda: mm_forget.main(forget_args + [
            f"model_path={ft_dir}", "LoRA.r=8", "quantize_base=int4", "merge_dtype=bfloat16",
            f"save_dir={save_dir}"]))
        wall = time.perf_counter() - t0
    # counts and peak from the loop's start (``before`` reset them) to the save
    launches, peak = dict(kernels.LAUNCHES), torch.cuda.max_memory_allocated() / 2**30
    _check_steps(label, rec.steps)
    losses = [m["loss"] for m in rec.steps]
    accum, loss, mcfg = cli_kw["accum"], cli_kw["loss"], cli_kw["mcfg"]
    if len(rec.steps) != 3 or len(set(losses)) < 2 or cli_kw["scale"] != 32 / 8:
        raise AssertionError(f"{label}: {len(rec.steps)} steps, losses {losses}")
    # B8 launches once per forward product it takes (the backward dequantizes)
    want = dict(_expected_launches(loss, {}, mcfg.decoder, mcfg.vision,
                                   steps=len(rec.steps) * accum), int4_matmul=sum(rows.values()))
    _check_launches(label, launches, want)
    dq_rows = sorted({m for m, _, _ in quantize.INT4_DEQUANT_CALLS})
    bwd_rows = sorted({m for m, _, _ in b8.INT4_BWD_CALLS})
    if any(m <= quantize.INT4_MAX_KERNEL_ROWS for m in dq_rows) or any(
            m > quantize.INT4_MAX_KERNEL_ROWS for m in rows) or not b8.INT4_BWD_CALLS:
        raise AssertionError(f"{label}: routes: B8 rows {dict(rows)}, dequant rows {dq_rows}, "
                             f"backward rows {bwd_rows}")
    n_t = os.path.getsize(os.path.join(save_dir, "model.safetensors"))
    print(f"{label}: main() {wall:.1f} s (load, quantize, the check, steps, merge, save of "
          f"{n_t / 1e9:.2f} GB); rows per int4 product: B8 {dict(sorted(rows.items()))} "
          f"(forward, up to {quantize.INT4_MAX_KERNEL_ROWS} rows), dequant + matmul forward "
          f"{dq_rows} ({sum(quantize.INT4_DEQUANT_CALLS.values())} calls), dequant + matmul "
          f"backward {bwd_rows} ({sum(b8.INT4_BWD_CALLS.values())} calls)", flush=True)
    _report_steps(label, rec.steps, launches, peak, QWEN_PEAK_BOUND_GIB)
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    # the merged checkpoint reloaded and served: four tokens of an image request
    cfg = serve.load_config([f"model_family={family}", f"model_path={save_dir}",
                             "quantize_base=false", *serve_extra])
    engine, proc, _, _ = serve.build_engine(cfg)
    ids, _, pix, _, _ = _qwen_requests(proc, 1, 11)[0]
    kernels.reset_launch_counts()
    req = engine.submit(ids, 4, pixel_values=pix)
    engine.run()
    torch.cuda.synchronize()
    served = dict(kernels.LAUNCHES)
    if len(req.tokens) != 4 or not served["flash_fwd"] or not served["flash_decode"]:
        raise AssertionError(f"{label}: reload served {req.tokens} ({req.finish_reason}), "
                             f"launches {served}")
    print(f"{label}: the merged checkpoint reloaded and served 4 tokens {req.tokens}; "
          f"launches {({k: v for k, v in served.items() if v})}", flush=True)
    engine._state = None
    del engine
    return launches


# ------------------------------------------------------------- phase 9
# CLEAR's text-only stack (TOFU unlearning) through the CLIs a user calls:
# configs/nlp/{finetune,forget,eval_everything,aggregate_eval_stat}.yaml on
# Llama-2-7B (llama2-7b) at full width and depth from seed 42, bf16, on
# synthetic TOFU-style rows instead of locuslab/TOFU (256 text rows, so that
# the shipped 128-row finetune batch gives two steps an epoch); then the
# results CLIs over what the runs wrote.  "synthetic:n_persons=64" (4 QA a
# person) has no comma, so that eval's list override parses as four entries.
NLP_DATA = "synthetic:n_persons=64"
# finetune.yaml as shipped but for the data and one epoch: its 128 rows of
# 500 tokens as 16 accumulated micro-batches of 8 (128 rows at once would need
# ~285 GB of activations), merged and saved in bf16
NLP_FINETUNE_ARGS = [f"data_path={NLP_DATA}", "batch_size=8", "gradient_accumulation_steps=16",
                     "merge_dtype=bfloat16", "num_epochs=1"]
# forget.yaml as shipped (RMU, LoRA r 8, batch 4, accumulation 2, AdamW at lr
# 1e-5) but for the data and one epoch: 25 forget rows, 8 a step: 3 steps
NLP_FORGET_ARGS = [f"data_path={NLP_DATA}", "merge_dtype=bfloat16", "num_epochs=1"]
# 9c: one step of each projection method from 9b's checkpoint as forget.yaml
# ships them (8 rows of 500 tokens a step: 25 // 8 = 3 steps an epoch, one
# taken), no save.  grad_proj_l2 takes its Hessian-vector products a layer at
# a time (``train/grad_proj._hvp_``): whole second-order graphs of 500 tokens
# took the card past its 80 GB even at one row
NLP_PROJ_ARGS = {"grad_proj": ["num_epochs=0.33"], "grad_proj_l2": ["num_epochs=0.33"]}
NLP_EVAL_ARGS = ["ds_size=8", f"data_path=[{','.join([NLP_DATA] * 4)}]"]
NLP_EVAL_RUNS = {"9d eval": [], "9e eval, engine + speculation": ["engine_generate=true",
                                                                   "speculative_k=4"]}
# one step each on 9b's student at its loop's end (idk: its concatenated
# forward as retain_ft; grad_ascent: L1 of the adapters, l_norm_from auto)
NLP_OTHER_LOSSES = ("idk", "dpo", "npo", "grad_ascent")
# peak device memory per run (GiB): each bound is its reading on an H100 80GB
# HBM3 at 700 W with ~15% room (9a 38.49: the bf16 weights, 12.55 GiB, and 8
# rows of activations of 500 tokens; 9b 27.77; 9c's other losses 38.44, idk's
# 8 concatenated rows; grad_proj 64.37: the weights, two gradient trees and
# 8 rows; grad_proj_l2: its first-order passes are grad_proj's, and its
# products a layer at a time hold the weights, g_pos and v and one layer's
# graphs)
NLP_PEAK_BOUND_GIB = {"9a finetune": 45.0, "9b forget rmu": 34.0, "9c losses": 45.0,
                      "9c grad_proj": 75.0, "9c grad_proj_l2": 75.0}


def _nlp_batch(loss, tok, tags, dev, rows=4, max_length=500):
    """The first micro-batch the nlp forget CLI draws for ``loss`` (DPO's
    triplets; idk's rows concatenated), on the device."""
    from multimodal_unlearning_tpu_torch.data import DataLoader
    from multimodal_unlearning_tpu_torch.data import nlp as nlp_data
    from multimodal_unlearning_tpu_torch.train.loop import to_device

    kw = dict(max_length=max_length, split="forget10", seed=42)
    ds = (nlp_data.TextForgetDatasetDPOQA(NLP_DATA, tok, tags, **kw) if loss == "dpo" else
          nlp_data.TextForgetDatasetQA(NLP_DATA, tok, tags, loss_type=loss, **kw))
    batch = next(iter(DataLoader(ds, rows, nlp_data.text_collator, shuffle=True, seed=42)))
    if loss == "idk":
        batch = {"retain": {k: np.concatenate([batch["idk"][k], batch["retain"][k]])
                            for k in batch["idk"]}}
    return to_device(batch, dev)


def _check_saved_llama(label, path, mcfg):
    """``model.safetensors`` holds exactly ``llama_to_hf``'s names, in bf16
    (read from the header: no tensor loaded)."""
    from safetensors import safe_open

    from multimodal_unlearning_tpu_torch.models import hf_bridge, llama

    meta = llama.Llama(mcfg, device="meta", dtype=torch.bfloat16)
    names = set(hf_bridge.llama_to_hf(common.model_tree(meta)))
    with safe_open(path, framework="pt") as f:
        got = set(f.keys())
        dtypes = {f.get_slice(k).get_dtype() for k in got}
    if got != names or dtypes != {"BF16"}:
        raise AssertionError(f"{label}: {len(got ^ names)} names differ from llama_to_hf's, "
                             f"dtypes {dtypes}")
    return len(got), os.path.getsize(path)


class _ProjRecorder:
    """While active, records each ``train.grad_proj`` step of a CLI run:
    its metrics (floats), wall time and tokens, and the arguments of the
    CLI's ``make_apply_fn``."""

    def __init__(self, sync):
        from multimodal_unlearning_tpu_torch.cli import nlp_forget
        from multimodal_unlearning_tpu_torch.train import grad_proj

        self.cli, self.gp, self.sync = nlp_forget, grad_proj, sync
        self.steps, self.apply_kw = [], None

    def __enter__(self):
        rec, make, make_apply = self, self.gp.make_grad_proj_step, self.cli.make_apply_fn
        self._saved = [(self.gp, "make_grad_proj_step", make),
                       (self.cli, "make_apply_fn", make_apply)]

        def apply_wrapper(*a, **kw):
            rec.apply_kw = (a, kw)
            return make_apply(*a, **kw)

        def make_wrapper(*a, **kw):
            step = make(*a, **kw)

            def timed(trainable, opt_state, frozen, batch):
                rec.sync()
                t0 = time.perf_counter()
                out = step(trainable, opt_state, frozen, batch)
                m = {k: float(v) for k, v in out[2].items()}
                rec.steps.append(dict(m, wall=time.perf_counter() - t0, tokens=sum(
                    int(p["input_ids"].numel()) for p in batch.values())))
                return out
            return timed

        self.gp.make_grad_proj_step = make_wrapper
        self.cli.make_apply_fn = apply_wrapper
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _nlp_other_losses(rec, processor, tags, dec, sync):
    """9c.1 and 9c.2, at the end of 9b's loop (its student, the frozen base
    that is also RMU's teacher, its AdamW state): RMU's first batch on the
    kernels and on plain attention, then one step of each other loss."""
    from multimodal_unlearning_tpu_torch.cli import nlp_forget
    from multimodal_unlearning_tpu_torch.config import load_config
    from multimodal_unlearning_tpu_torch.config.registry import config_dir
    from multimodal_unlearning_tpu_torch.train import trainer

    dev = next(rec.loop["frozen"].parameters()).device
    sync()
    # 9b's own steps, their launches and their peak
    rec.loop_steps, rec.loop_launches = list(rec.steps), dict(kernels.LAUNCHES)
    rec.loop_peak = torch.cuda.max_memory_allocated() / 2**30
    state, frozen, teacher = rec.loop["state"], rec.loop["frozen"], rec.loop["teacher"]
    (apply_fn, tx), step_kw = rec.step_args[0][:2], rec.step_args[1]
    tok = processor.tokenizer
    b_max = max(float(b.detach().abs().max())
                for p, b in tree_leaves_with_path(state.trainable) if p[-1] == "b")
    if not b_max > 0:
        raise AssertionError(f"9b: the LoRA b leaves are all zero after the steps ({b_max})")
    # 9c.1: RMU's first batch on the kernels and on plain attention
    batch = _nlp_batch("rmu", tok, tags, dev)
    plain_fn = nlp_forget.make_apply_fn(*rec.apply_kw[0], **dict(rec.apply_kw[1],
                                                                 attn_impl="plain"))
    grad_of = lambda fn: trainer.make_train_step(  # noqa: E731
        fn, tx, **dict(step_kw, grad_accum=1)).grad_fn(state.trainable, frozen, teacher, batch,
                                                       state.control_vec)
    (lk, _), gk = grad_of(apply_fn)
    (lp, _), gp = grad_of(plain_fn)
    cos = {"/".join(p): _cos(g, w) for (p, g), (_, w) in zip(tree_leaves_with_path(gk),
                                                            tree_leaves_with_path(gp))}
    worst = min(cos, key=cos.get)
    print(f"9c RMU's first batch, kernels vs plain attention: loss {float(lk):.5f} vs "
          f"{float(lp):.5f} (tol {STEP_LOSS_TOL}); LoRA gradient cosine min {cos[worst]:.5f} "
          f"at {worst}, median {statistics.median(cos.values()):.5f} over {len(cos)} leaves "
          f"(tol {STEP_GRAD_COS}); max |b| after 9b's steps {b_max:.3e}", flush=True)
    if abs(float(lk) - float(lp)) > STEP_LOSS_TOL or cos[worst] < STEP_GRAD_COS:
        raise AssertionError(f"9c: kernels vs plain attention: loss {float(lk)} vs {float(lp)}, "
                             f"cosine {cos[worst]} at {worst}")
    del gk, gp
    # 9c.2: one step of each other loss with its own splits, its keywords as
    # the CLI makes them from forget.yaml (grad_ascent with L1: l_norm_from
    # auto, under LoRA the raw adapters)
    per_loss, total, peak_c = {}, dict.fromkeys(kernels.LAUNCHES, 0), 0.0
    for loss in NLP_OTHER_LOSSES:
        batch = _nlp_batch(loss, tok, tags, dev)
        over = [f"forget_loss={loss}"] + (["l1_lambda=1e-4"] if loss == "grad_ascent" else [])
        cfg = load_config(config_dir() / "nlp", "forget", NLP_FORGET_ARGS + over)
        kw = {**step_kw, **nlp_forget.step_kwargs(cfg, use_lora=True), "grad_accum": 1}
        if loss == "grad_ascent" and (kw["l_norm_from"], kw["l1_lambda"]) != ("zero", 1e-4):
            raise AssertionError(f"9c grad_ascent: l_norm_from auto gave {kw['l_norm_from']}")
        step = trainer.make_train_step(apply_fn, tx, **kw)
        t0 = time.perf_counter()
        (_, m), peak, launches = _measured(lambda: step(state, frozen, teacher, batch))
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in m.items()}
        _check_steps(f"9c {loss}", [m])
        want = _expected_launches(kw["loss_type"], batch, dec, None)
        if launches != want:
            raise AssertionError(f"9c {loss} launches {launches}, expected {want}")
        per_loss[loss] = dict(ms=round(ms, 1), loss=round(m["loss"], 5),
                              grad_norm=round(m["grad_norm"], 4), peak_gib=round(peak, 2),
                              rows=int(next(iter(batch.values()))["input_ids"].shape[0]),
                              launches={k: v for k, v in launches.items() if v})
        peak_c = max(peak_c, peak)
        for k, v in launches.items():
            total[k] += v
        del batch, step
    print(f"9c losses, one step each on 9b's student: {json.dumps(per_loss)}; peak "
          f"{peak_c:.2f} GiB (bound {NLP_PEAK_BOUND_GIB['9c losses']})", flush=True)
    if peak_c > NLP_PEAK_BOUND_GIB["9c losses"]:
        raise AssertionError(f"9c losses: peak {peak_c:.2f} GiB above the bound")
    rec.other_launches = total
    sync()


def _nlp_proj_run(label, argv, dec, sync):
    """One projection method through ``cli.nlp_forget.main``; checks its
    steps and launches.  Returns its launches."""
    from multimodal_unlearning_tpu_torch.cli import nlp_forget

    method = _arg(argv, "forget_loss")
    with _ProjRecorder(sync) as rec:
        t0 = time.perf_counter()
        history, peak, launches = _measured(lambda: nlp_forget.main(argv))
        wall = time.perf_counter() - t0
    attn = rec.apply_kw[1]["attn_impl"]
    for m in rec.steps:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label}: non-finite step {m}")
    if [h["step"] for h in history] != list(range(1, len(rec.steps) + 1)) or not rec.steps:
        raise AssertionError(f"{label}: history {history}, {len(rec.steps)} steps")
    n = len(rec.steps)
    # two forwards with their backwards, two after the update (grad_proj_l2's
    # products a layer at a time run the plain attention)
    want = dict(dict.fromkeys(kernels.LAUNCHES, 0), flash_fwd=4 * n * dec.num_layers,
                flash_bwd_dq=2 * n * dec.num_layers, flash_bwd_dkv=2 * n * dec.num_layers)
    if attn != "auto" or launches != want:
        raise AssertionError(f"{label}: attention {attn}, launches {launches}, expected {want}")
    per = [f"{m['wall'] * 1e3:.0f} ms ({m['tokens'] / m['wall']:.0f} tok/s), neg "
           f"{m['neg_loss']:.5f} pos {m['pos_loss']:.5f}" for m in rec.steps]
    print(f"{label}: main() {wall:.1f} s (load, steps); attention {attn}; {n} step(s): "
          f"{'; '.join(per)}; launches {({k: v for k, v in launches.items() if v})}; "
          f"max_memory_allocated {peak:.2f} GiB (bound {NLP_PEAK_BOUND_GIB[label]})", flush=True)
    if peak > NLP_PEAK_BOUND_GIB[label]:
        raise AssertionError(f"{label}: peak {peak:.2f} GiB above the bound")
    return launches


def _nlp_eval_run(label, argv, sync):
    """One ``cli.nlp_eval.main`` run under the recorder: its files, its
    launches and every token of its streams against teacher-forced
    forwards of the model it loaded.  Returns (aggregate, save dir,
    numbers)."""
    from multimodal_unlearning_tpu_torch.cli import nlp_eval
    from multimodal_unlearning_tpu_torch.config import load_config
    from multimodal_unlearning_tpu_torch.config.registry import config_dir

    cfg = load_config(config_dir() / "nlp", "eval_everything", argv)
    rows = int(cfg.ds_size)
    with _EvalRecorder(sync, int(cfg.generation.max_new_tokens), text=True) as rec:
        t0 = time.perf_counter()
        agg, peak, launches = _measured(lambda: nlp_eval.main(argv))
        wall = time.perf_counter() - t0
    _check_eval_files(label, cfg.save_dir, agg, rows, 4)
    want = _eval_launches(rec, rec.model.cfg, None, speculative=bool(cfg.speculative_k))
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    numbers = dict(_report_eval(label, rec, wall, peak),
                   launches={k: v for k, v in launches.items() if v})
    t0 = time.perf_counter()
    gap, n, off, _ = hold_streams(rec.model, label,
                                  [s for t in rec.tasks for s in t["streams"]],
                                  [p for t in rec.tasks for p in t["prompts"]], rec.max_new,
                                  rec.ends)
    numbers["teacher_forced"] = dict(tokens=n, not_argmax=off, max_gap=round(gap, 4))
    print(f"{label[:2]} streams vs teacher-forced forwards: {n} tokens, {off} not the argmax, "
          f"largest gap {gap:.4f} (tie margin {TIE_MARGIN}; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    rec.model = None
    gc.collect()
    torch.cuda.empty_cache()
    return agg, cfg.save_dir, numbers


def run_nlp_path(mm_results=None, sync=torch.cuda.synchronize, finetune_args=NLP_FINETUNE_ARGS,
                 forget_args=NLP_FORGET_ARGS, proj_args=NLP_PROJ_ARGS, eval_args=NLP_EVAL_ARGS,
                 then=None):
    """9a ``cli.nlp_finetune.main`` (finetune.yaml), 9b ``cli.nlp_forget.main``
    (forget.yaml, RMU) from 9a's checkpoint with 9c's checks at its loop's
    end (kernels vs plain attention, one step of each other loss), 9c the
    projection methods from 9b's checkpoint, 9d ``cli.nlp_eval.main``
    (eval_everything.yaml) on 9b's checkpoint and 9e on 9a's with the engine
    and K 4 (the retain model's stand-in), 9f ``cli.nlp_aggregate.main``,
    9g the results CLIs (``build_tables`` over ``mm_results``, phase 7's
    aggregates, when given).  ``then(ft_dir)``, if given, runs last, while
    9a's checkpoint exists (phase 10); its result is under "then".  Returns
    each sub-phase's launch counts and the evaluations' numbers."""
    import csv
    import io
    import shutil
    import tempfile

    from multimodal_unlearning_tpu_torch.cli import (
        build_tables, inspect_runs, nlp_aggregate, nlp_finetune, nlp_forget, push_model)
    from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
    from multimodal_unlearning_tpu_torch.evaluation.metrics import METRIC_NAMES, TOFU_TASK_DICT
    from multimodal_unlearning_tpu_torch.models import lora

    model_cfg = get_model_identifiers("llama2-7b")
    mcfg = common.build_model_config(model_cfg)
    processor = common.build_processor(model_cfg)
    tags = nlp_finetune.text_tags(model_cfg)
    root = tempfile.mkdtemp(prefix="nlp_runs_")
    ft_dir = os.path.join(root, "ft_full")
    fg_dir = os.path.join(root, "RMU_beta1.0_lr1e-05_5_L10.0_L00.0")
    seconds: dict = {}
    saved = [(owner, name, _timed(owner, name, seconds)) for owner, name in (
        (common, "save_model"), (lora, "merge_model"), (common, "init_or_load_params"))]
    out, numbers, phase_s = {}, {}, {}
    try:
        # 9a: finetune.yaml, LoRA r 8 over the random bf16 base, merged in bf16
        seconds.clear()
        with _CliRecorder(nlp_finetune) as rec:
            t0 = time.perf_counter()
            _, peak, launches = _measured(lambda: nlp_finetune.main(
                finetune_args + [f"save_dir={ft_dir}"]))
            phase_s["9a"] = wall = time.perf_counter() - t0
        accum = int(_arg(finetune_args, "gradient_accumulation_steps"))
        _check_steps("9a finetune", rec.steps)
        losses = [m["loss"] for m in rec.steps]
        if len(rec.steps) != 2 or len(set(losses)) < 2:
            raise AssertionError(f"9a: {len(rec.steps)} steps, losses {losses}")
        want = _expected_launches("retain_ft", {}, mcfg, None, steps=len(rec.steps) * accum)
        if launches != want:
            raise AssertionError(f"9a finetune launches {launches}, expected {want}")
        n_t, size = _check_saved_llama("9a", os.path.join(ft_dir, "model.safetensors"), mcfg)
        print(f"9a finetune: main() {wall:.1f} s = init {seconds['init_or_load_params']:.1f} s + "
              f"steps + merge {seconds['merge_model']:.1f} s + save {seconds['save_model']:.1f} s "
              f"({size / 1e9:.2f} GB, {n_t} tensors, bf16: "
              f"{size / 1e9 / seconds['save_model']:.2f} GB/s)", flush=True)
        _report_steps("9a finetune", rec.steps, launches, peak, NLP_PEAK_BOUND_GIB)
        out["9a"] = launches
        del rec
        gc.collect()
        torch.cuda.empty_cache()

        # 9b: forget.yaml as shipped (RMU) from 9a's checkpoint; 9c's checks at
        # its loop's end, on its student
        seconds.clear()
        rec = _CliRecorder(nlp_forget, after_loop=lambda r: _nlp_other_losses(
            r, processor, tags, mcfg, sync))
        with rec:
            t0 = time.perf_counter()
            _measured(lambda: nlp_forget.main(
                forget_args + [f"model_path={ft_dir}", f"save_dir={fg_dir}"]))
            phase_s["9b+9c.1-2"] = wall = time.perf_counter() - t0
        launches, peak, steps = rec.loop_launches, rec.loop_peak, rec.loop_steps
        _check_steps("9b forget rmu", steps)
        losses = [m["loss"] for m in steps]
        if len(steps) != 3 or len(set(losses)) < 2:
            raise AssertionError(f"9b: {len(steps)} steps, losses {losses}")
        accum = int(_arg(forget_args, "gradient_accumulation_steps", 2))
        want = _expected_launches("rmu", {}, mcfg, None, steps=len(steps) * accum)
        if launches != want:
            raise AssertionError(f"9b forget launches {launches}, expected {want}")
        n_t, size = _check_saved_llama("9b", os.path.join(fg_dir, "model.safetensors"), mcfg)
        print(f"9b forget: main() {wall:.1f} s = load {seconds['init_or_load_params']:.1f} s + "
              f"steps + 9c's checks + merge {seconds['merge_model']:.1f} s + save "
              f"{seconds['save_model']:.1f} s ({size / 1e9:.2f} GB: "
              f"{size / 1e9 / seconds['save_model']:.2f} GB/s)", flush=True)
        _report_steps("9b forget rmu", steps, launches, peak, NLP_PEAK_BOUND_GIB)
        out["9b"], out["9c_losses"] = launches, rec.other_launches
        del rec
        gc.collect()
        torch.cuda.empty_cache()

        # 9c: the projection methods from 9b's checkpoint, full parameters
        for method, extra in proj_args.items():
            label = f"9c {method}"
            t0 = time.perf_counter()
            out[f"9c_{method}"] = _nlp_proj_run(label, forget_args + extra + [
                f"forget_loss={method}", f"model_path={fg_dir}", "save_model=false",
                f"save_dir={os.path.join(root, method)}"], mcfg, sync)
            phase_s[label[:2] + " " + method] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()

        # 9d / 9e: eval_everything.yaml on 9b's checkpoint (plain greedy) and on
        # 9a's (the engine with K 4): each into its ${model_path}/eval_results/
        aggs = {}
        for (label, extra), ckpt in zip(NLP_EVAL_RUNS.items(), (fg_dir, ft_dir)):
            t0 = time.perf_counter()
            aggs[label], _, numbers[label] = _nlp_eval_run(
                label, eval_args + [f"model_path={ckpt}"] + extra, sync)
            phase_s[label[:2]] = time.perf_counter() - t0
            out[label[:2]] = numbers[label]["launches"]

        # 9f: aggregate_eval_stat.yaml, 9d's aggregate as the checkpoint, 9e's
        # as the retain model's
        t0 = time.perf_counter()
        csv_path = os.path.join(root, "aggr_result.csv")
        row = nlp_aggregate.main([
            f"ckpt_result={fg_dir}/eval_results/eval_log_aggregated.json",
            f"retain_result={ft_dir}/eval_results/eval_log_aggregated.json",
            f"save_file={csv_path}", "method_name=RMU"])
        with open(csv_path) as f:
            header, values = list(csv.reader(f))
        want_cols = ([f"{m} {t}" for t in TOFU_TASK_DICT.values() for m in METRIC_NAMES]
                     + ["Model Utility", "Forget Quality", "Method", "Submitted By"])
        nums = [float(v) for v in values[:-2]]
        if header != want_cols or list(row) != want_cols or not np.isfinite(nums).all():
            raise AssertionError(f"9f aggregate: {header} / {values}")
        print(f"9f nlp_aggregate: {dict(zip(header, values))}", flush=True)

        # 9g: the results CLIs over the runs' directories
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            sweep = inspect_runs.sweep_summary(root)
            inspect_runs.main(["gens", f"a={fg_dir}", f"b={ft_dir}", "n=2"])
        gens = buf.getvalue()
        rmu_row = next((r for r in sweep if r["run"].startswith("RMU")), {})
        if (len(sweep) != 2 or rmu_row.get("lr") != "1e-05"
                or not all(np.isfinite(v) for r in sweep for k, v in r.items()
                           if k.endswith(("loss", "rougeL")))
                or gens.count("=== ") != 4):
            raise AssertionError(f"9g inspect_runs: sweep {sweep}, gens {gens[:400]!r}")
        print(f"9g inspect_runs sweep: {json.dumps(sweep)}; gens: {gens.count(' a: ')} pairs "
              f"over 4 tasks", flush=True)
        if mm_results is not None:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                table = build_tables.main([f"base_model={mm_results}/base",
                                           f"gold_model={mm_results}/gold",
                                           f"out={mm_results}/tables"])
            tex = buf.getvalue()
            methods = [m.replace("\\rowcolor{papergray} ", "") for m in table["Method"]]
            if methods != ["Gold", "Base"] or "\\begin{tabular}" not in tex or not \
                    os.path.exists(f"{mm_results}/tables/mm_results.json"):
                raise AssertionError(f"9g build_tables: {tex}")
            print(f"9g build_tables over phase 7's two aggregates:\n{tex}", flush=True)
        else:
            print("9g build_tables: no phase 7 aggregates in this run (--nlp-only)", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            push_model.main([ft_dir, "local/llama2-7b-ft"])
            try:
                push_model.main([root, "local/none"])
                code = 0
            except SystemExit as e:
                code = e.code
        if code != 1 or "Would push" not in buf.getvalue():
            raise AssertionError(f"9g push_model: exit {code}, {buf.getvalue()!r}")
        print(f"9g push_model: {buf.getvalue().strip()}", flush=True)
        phase_s["9f-9g"] = time.perf_counter() - t0
        print(f"phase 9 seconds by sub-phase: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}",
              flush=True)
        out["numbers"] = numbers
        if then is not None:
            out["then"] = then(ft_dir)
        return out
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 10
# CLEAR's unlearning methods and the sweep: 10a SalUn (salun.yaml as it ships,
# then Llama-2-7B at full width cut to SALUN_DEPTH layers: ten masks of a
# whole 7B model would be ~270 GB on disk), 10b ECO on 9a's checkpoint in f32
# (eco_llama2-7b.yaml as it ships but for the data), 10c eco_ft forgetting
# from 10b's prompts, 10d the sweep orchestrator on tiny-llama-test
SALUN_DEPTH = 2
SALUN_7B_ARGS = ["model_family=llama2-7b", "dtype=bfloat16", "batch_size=4", "max_length=128"]
ECO_ARGS = [f"data_path={NLP_DATA}"]
# the learned detectors train on the host (``cli.eco_train_classifiers`` as it
# ships: 400 epochs) in a subprocess of their own while 10a runs on the card,
# on this many of the host's cores
DETECTOR_THREADS = 4
# forget.yaml as it ships (LoRA r 8, batch 4, accumulation 2) with eco_ft: 25
# rows, 8 a step, 0.7 epochs: 2 steps (the warmup's first runs at lr 0)
ECO_FT_ARGS = [f"data_path={NLP_DATA}", "forget_loss=eco_ft", "num_epochs=0.7",
               "save_model=false"]
SWEEP_DATA = "synthetic:n_persons=8"
# tiny-llama-test has 256 positions: 128-token rows, 4 new tokens
SWEEP_ARGS = ["stack=nlp", "losses=[grad_ascent]", "model_family=tiny-llama-test",
              "batch_size=2", "max_length=128", "gradient_accumulation_steps=1",
              "num_epochs=1", f"forget.data_path={SWEEP_DATA}",
              f"data_path=[{','.join([SWEEP_DATA] * 4)}]", "ds_size=2",
              "generation.max_new_tokens=4"]
# peak device memory (GiB): its reading on an H100 80GB HBM3 at 700 W with ~15%
# room (10c: 37.59, the bf16 weights and 8 rows of 500 tokens, two splits)
METHODS_PEAK_BOUND_GIB = {"10c forget eco_ft": 43.5}


def _ram_dir(names):
    """A new directory under the temporary directory whose files ``names``
    are links to anonymous memory files of this process (``memfd_create``):
    what is written there stays in RAM, out of every file system, and is
    freed when the process ends, however it ends.  A machine may cap what a
    run writes to its disk (45 GiB, freed or not, on the H100 machine that
    ran this script), and phases 5-9 write ~40 GB of checkpoints: 10a's
    masks (26.7 GB) go to memory.  Returns (directory, memory files' fds)."""
    import tempfile

    d = tempfile.mkdtemp(prefix="salun_")
    fds = [os.memfd_create(n) for n in names]
    for n, fd in zip(names, fds):
        os.symlink(f"/proc/{os.getpid()}/fd/{fd}", os.path.join(d, n))
    return d, fds


def _mask_template(family):
    """{path: shape} of the family's parameter tree (a meta-device model)."""
    from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
    from multimodal_unlearning_tpu_torch.models import llama

    mcfg = common.build_model_config(get_model_identifiers(family))
    meta = llama.Llama(mcfg, device="meta")
    return {"/".join(p): tuple(x.shape) for p, x in tree_leaves_with_path(common.model_tree(meta))}


def _npz_member(zf, key):
    """One array of an uncompressed ``.npz``, read whole (its CRC checked by
    ``zipfile``) and viewed in place past its ``.npy`` header."""
    import io

    with zf.open(key + ".npy") as f:
        buf = f.read()
    bio = io.BytesIO(buf)
    version = np.lib.format.read_magic(bio)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(bio)
    if fortran:
        raise AssertionError(f"{key}: a Fortran-ordered array")
    return np.frombuffer(buf, dtype=dtype, offset=bio.tell()).reshape(shape)


def _check_mask_files(label, d, template):
    """The ten ``with_{t}.npz``: exactly the template's paths and shapes in
    float32, ``int(t * n)`` entries kept per tensor (per layer of a stacked
    leaf), each threshold's mask inside the next one's, t = 1.0 all ones;
    read a leaf at a time from the ten files at once (one thread each).
    Returns (seconds, GB read)."""
    import zipfile
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_unlearning_tpu_torch.methods import salun

    t0 = time.perf_counter()
    if sorted(os.listdir(d)) != sorted(f"with_{t}.npz" for t in salun.THRESHOLDS):
        raise AssertionError(f"{label}: files {sorted(os.listdir(d))}")
    files = {t: zipfile.ZipFile(os.path.join(d, f"with_{t}.npz")) for t in salun.THRESHOLDS}
    for t, zf in files.items():
        if sorted(zf.namelist()) != sorted(k + ".npy" for k in template):
            raise AssertionError(f"{label} t={t}: members {sorted(zf.namelist())}")
    nbytes = 0
    with ThreadPoolExecutor(max_workers=len(files)) as pool:
        for key, shape in template.items():
            masks = list(pool.map(lambda zf: _npz_member(zf, key), files.values()))
            prev = None
            for t, m in zip(files, masks):
                nbytes += m.nbytes
                x = torch.from_numpy(m)
                rows = x.reshape(x.shape[0], -1) if key.startswith("layers/") and x.ndim >= 2 \
                    else x.reshape(1, -1)
                kept = (rows != 0).sum(dim=1)
                if m.shape != shape or m.dtype != np.float32 or \
                        not bool((kept == salun.kept(t, rows.shape[1])).all()):
                    raise AssertionError(f"{label} t={t} {key}: shape {m.shape} (want {shape}), "
                                         f"{m.dtype}, kept {kept[:4].tolist()} per row")
                if prev is not None and not bool((prev <= x).all()):
                    raise AssertionError(f"{label} {key}: the mask at t={t} does not hold the "
                                         "previous threshold's")
                if t == 1.0 and not bool((x == 1).all()):
                    raise AssertionError(f"{label} {key}: the t=1.0 mask is not all ones")
                prev = x
            del masks, prev
    for zf in files.values():
        zf.close()
    return time.perf_counter() - t0, nbytes / 1e9


def _salun_run(label, argv, template, kernel_layers, sync):
    """One ``cli.salun_generate.main`` run: the saliency finite, B1-B3
    launched once a batch in each of ``kernel_layers`` layers (0: the
    family's plain attention, no launch), the files checked.  Returns
    (launches, numbers)."""
    import shutil

    from multimodal_unlearning_tpu_torch.cli import salun_generate
    from multimodal_unlearning_tpu_torch.methods import salun

    d, fds = _ram_dir([f"with_{t}.npz" for t in salun.THRESHOLDS])
    seen = {"batches": 0}
    acc, save = salun.accumulate_saliency, salun.save_saliency_masks

    def accumulate(grad_fn, params, batches):
        def counted(p, b):
            seen["batches"] += 1
            return grad_fn(p, b)
        sal = acc(counted, params, batches)
        leaves = [x for _, x in tree_leaves_with_path(sal)]
        seen["finite"] = all(bool(torch.isfinite(x).all()) for x in leaves)
        seen["entries"] = sum(x.numel() for x in leaves)
        sync()
        seen["grads_s"] = time.perf_counter() - t0
        return sal

    def timed_save(*a, **kw):
        t1 = time.perf_counter()
        out = save(*a, **kw)
        seen["save_s"] = time.perf_counter() - t1
        return out

    salun.accumulate_saliency, salun.save_saliency_masks = accumulate, timed_save
    try:
        t0 = time.perf_counter()
        _, peak, launches = _measured(lambda: salun_generate.main(argv + [f"save_dir={d}"]))
        wall = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e9
        check_s, read_gb = _check_mask_files(label, d, template)
    finally:
        salun.accumulate_saliency, salun.save_saliency_masks = acc, save
        shutil.rmtree(d, ignore_errors=True)
        for fd in fds:
            os.close(fd)
    n = seen["batches"] * kernel_layers
    want = dict(dict.fromkeys(kernels.LAUNCHES, 0), flash_fwd=n, flash_bwd_dq=n,
                flash_bwd_dkv=n)
    if not seen["finite"] or launches != want or not seen["batches"]:
        raise AssertionError(f"{label}: saliency finite {seen['finite']}, {seen['batches']} "
                             f"batches, launches {launches}, expected {want}")
    numbers = dict(main_s=round(wall, 1), grads_s=round(seen["grads_s"], 1),
                   rank_and_write_s=round(seen["save_s"], 1), files_gb=round(size, 2),
                   write_gb_s=round(size / seen["save_s"], 2), check_s=round(check_s, 1),
                   read_gb=round(read_gb, 2), batches=seen["batches"],
                   entries=seen["entries"], peak_gib=round(peak, 2),
                   launches={k: v for k, v in launches.items() if v})
    print(f"{label}: {json.dumps(numbers)}", flush=True)
    return launches, numbers


class _EcoRecorder:
    """While active, records the attacked model (``AttackedModel``'s last
    instance) and each ``generate`` call: its ids, mask, prompts, gate
    prompts, corrupted embeddings and tokens."""

    def __enter__(self):
        from multimodal_unlearning_tpu_torch.methods.eco import attacked_model as am

        rec, self.am, self.calls, self.eco = self, am, [], None
        embeds, generate = am.AttackedModel.corrupted_embeds, am.AttackedModel.generate
        self._saved = [("corrupted_embeds", embeds), ("generate", generate)]

        def embeds_w(eco, input_ids, prompts, gate_prompts=None):
            out = embeds(eco, input_ids, prompts, gate_prompts)
            if rec.calls and "embeds" not in rec.calls[-1]:
                rec.calls[-1]["embeds"] = out
            return out

        def generate_w(eco, input_ids, attention_mask, *, max_new_tokens, prompts=None,
                       gate_prompts=None, **kw):
            rec.eco = eco
            rec.calls.append(dict(ids=np.asarray(input_ids), mask=np.asarray(attention_mask),
                                  prompts=prompts, gate=gate_prompts))
            out = generate(eco, input_ids, attention_mask, max_new_tokens=max_new_tokens,
                           prompts=prompts, gate_prompts=gate_prompts, **kw)
            rec.calls[-1]["tokens"] = out
            return out

        am.AttackedModel.corrupted_embeds = embeds_w
        am.AttackedModel.generate = generate_w
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved:
            setattr(self.am.AttackedModel, name, fn)


def _eco_streams(label, eco, calls, names, max_new, exact=True):
    """Each gated prompt's flagged tokens are exactly its entity's (with
    ``exact``; else they are counted); every generated token is within
    TIE_MARGIN of the argmax of one teacher-forced forward over the
    corrupted prompt embeddings and the tokens before it (up to a row's
    first eos).  Returns (gated rows, rows that flag exactly their entity,
    tokens, largest gap)."""
    from multimodal_unlearning_tpu_torch.models.llama import positions_from_mask

    tok, model, dev = eco.tokenizer, eco.model, eco.device
    gated, on_entity, n, worst = 0, 0, 0, 0.0
    for call in calls:
        ids, mask, toks = call["ids"], call["mask"], call["tokens"]
        S = ids.shape[1]
        gate = eco.prompt_classifier.predict(call["gate"], threshold=eco.threshold)
        pat = eco._pattern(call["prompts"], S, call["gate"])
        for r, g in enumerate(gate):
            if not g:
                continue
            gated += 1
            flagged = tok.decode(ids[r][pat[r] == 1])
            on_entity += flagged == names[call["gate"][r]]
            if exact and flagged != names[call["gate"][r]]:
                raise AssertionError(f"{label}: prompt {call['prompts'][r]!r} flags "
                                     f"{flagged!r}, not its entity {names[call['gate'][r]]!r}")
        gen = torch.from_numpy(toks).to(dev)
        full = torch.cat([torch.from_numpy(mask).to(dev),
                          torch.ones_like(gen, dtype=torch.int32)], dim=1)
        emb = torch.cat([call["embeds"], model.embed_tokens[gen[:, :-1]].float()], dim=1)
        with torch.inference_mode():
            lg = model.forward(inputs_embeds=emb, attention_mask=full[:, :-1],
                               positions=positions_from_mask(full[:, :-1]),
                               compute_dtype=torch.float32)["logits"][:, S - 1:].float()
        for r in range(gen.shape[0]):
            row = gen[r].tolist()
            end = row.index(tok.eos_token_id) + 1 if tok.eos_token_id in row else max_new
            gaps = lg[r, :end].max(dim=-1).values - lg[r, torch.arange(end, device=dev),
                                                        gen[r, :end]]
            gap = float(gaps.max())
            if gap > TIE_MARGIN:
                raise AssertionError(f"{label}: row {r} token {int(gaps.argmax())} lies {gap:.4f} "
                                     f"below the teacher-forced argmax (tie margin {TIE_MARGIN})")
            worst, n = max(worst, gap), n + end
    return gated, on_entity, n, worst


def _eco_ungated(label, eco, names):
    """A gated forget prompt beside a retain prompt the gate passes: the
    ungated row's logits equal the clean forward's bit for bit, the flagged
    row's differ; the kernels' logits within ECO_LOGIT_TOL of f32 plain
    attention's.  Returns (flagged row's largest change, kernel vs plain)."""
    from multimodal_unlearning_tpu_torch.cli.nlp_finetune import text_tags
    from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
    from multimodal_unlearning_tpu_torch.data.nlp import resolve_text_rows
    from multimodal_unlearning_tpu_torch.evaluation.generate import pad_prompts
    from multimodal_unlearning_tpu_torch.methods.eco.prepare_prompts import tagged_prompts

    retain = next(r["question"] for r in resolve_text_rows(NLP_DATA, "retain90")
                  if r.get("name") not in names.values())
    questions = [next(iter(names)), retain]
    prompts = tagged_prompts(questions, text_tags(get_model_identifiers("llama2-7b")))
    tok, dev = eco.tokenizer, eco.device
    ids, mask = pad_prompts([tok.encode(p, add_special_tokens=True) for p in prompts],
                            tok.pad_token_id)
    if eco.prompt_classifier.predict(questions, threshold=eco.threshold) != [1, 0]:
        raise AssertionError(f"{label}: the gate does not pass {retain!r} alone")
    attacked = eco(ids, attention_mask=mask, prompts=prompts, gate_prompts=questions)["logits"]
    with torch.inference_mode():
        clean = eco.model.forward(torch.from_numpy(ids).to(dev).long(),
                                  attention_mask=torch.from_numpy(mask).to(dev),
                                  compute_dtype=torch.float32)["logits"]
    with torch.inference_mode():
        plain = eco.model.forward(
            inputs_embeds=eco.corrupted_embeds(eco._ids(ids), prompts, questions),
            attention_mask=eco._ids(mask), compute_dtype=eco.compute_dtype,
            attn_impl="plain")["logits"]
    change = float((attacked[0] - clean[0]).abs().max())
    vs_plain = float((attacked - plain).abs().max())
    if not torch.equal(attacked[1], clean[1]) or change == 0 or vs_plain > ECO_LOGIT_TOL:
        raise AssertionError(f"{label}: ungated row equal to the clean forward "
                             f"{torch.equal(attacked[1], clean[1])}, flagged row's change "
                             f"{change}, kernels vs plain attention {vs_plain} (tol "
                             f"{ECO_LOGIT_TOL})")
    return change, vs_plain


def _eco_file(label, out_dir, rows):
    path = os.path.join(out_dir, "eco_prompts.jsonl")
    with open(path) as f:
        got = [json.loads(line) for line in f]
    if len(got) != len(rows) or any(set(g) != {"question", "answer"} for g in got) or \
            [g["question"] for g in got] != [r["question"] for r in rows]:
        raise AssertionError(f"{label}: {path} holds {got[:2]}...")
    return got


def _train_detectors(out_dir, log_path):
    """``cli.eco_train_classifiers`` as it ships on the host, in a
    subprocess of its own (it uses no card) on ``DETECTOR_THREADS`` cores.
    Returns {"proc", "dir", "log", "seconds": filled in when it exits}."""
    import threading

    env = dict(os.environ, OMP_NUM_THREADS=str(DETECTOR_THREADS), CUDA_VISIBLE_DEVICES="")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "multimodal_unlearning_tpu_torch.cli.eco_train_classifiers",
             f"data_path={NLP_DATA}", f"out_dir={out_dir}"], stdout=log,
            stderr=subprocess.STDOUT, env=env)
    job = dict(proc=proc, dir=out_dir, log=log_path)
    t0 = time.perf_counter()
    threading.Thread(target=lambda: (proc.wait(), job.update(seconds=time.perf_counter() - t0)),
                     daemon=True).start()
    return job


def _eco_run(label, ft_dir, out_dir, sync, detectors, args=ECO_ARGS):
    """10b: ``cli.eco_prepare.main`` (eco_llama2-7b.yaml, f32) on 9a's
    checkpoint, its checks, then the learned detectors (``detectors``:
    ``_train_detectors``' job) on the same model.  Returns (launches,
    numbers)."""
    from multimodal_unlearning_tpu_torch.cli import eco_prepare
    from multimodal_unlearning_tpu_torch.cli.nlp_finetune import text_tags
    from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers
    from multimodal_unlearning_tpu_torch.data.nlp import resolve_text_rows
    from multimodal_unlearning_tpu_torch.methods.eco import get_eco_model
    from multimodal_unlearning_tpu_torch.methods.eco.prepare_prompts import prepare_eco_prompts

    rows = resolve_text_rows(NLP_DATA, "forget10")
    names = {r["question"]: r["name"] for r in rows}
    with _EcoRecorder() as rec:
        t0 = time.perf_counter()
        _, peak, launches = _measured(lambda: eco_prepare.main(
            args + [f"model_path={ft_dir or 'null'}", f"out_dir={out_dir}"]))
        wall = time.perf_counter() - t0
    eco = rec.eco
    n_b, L = len(rec.calls), eco.model_cfg.num_layers
    max_new = rec.calls[0]["tokens"].shape[1]
    want = dict(dict.fromkeys(kernels.LAUNCHES, 0), flash_fwd_f32=n_b * L,
                flash_decode_f32=n_b * (max_new - 1) * L)
    if launches != want or eco.compute_dtype != torch.float32:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    got = _eco_file(label, out_dir, rows)
    t1 = time.perf_counter()
    gated, _, n_tok, gap = _eco_streams(label, eco, rec.calls, names, max_new)
    change, vs_plain = _eco_ungated(label, eco, names)
    numbers = dict(main_s=round(wall, 1), batches=[int(c["ids"].shape[0]) for c in rec.calls],
                   prompt_columns=int(rec.calls[0]["ids"].shape[1]), new_tokens=max_new,
                   gated=gated, tokens_checked=n_tok, max_gap=round(gap, 6),
                   flagged_change=round(change, 4), kernels_vs_plain=vs_plain,
                   peak_gib=round(peak, 2), checks_s=round(time.perf_counter() - t1, 1),
                   launches={k: v for k, v in launches.items() if v})
    print(f"{label}: {json.dumps(numbers)}; first answer {got[0]['answer']!r}", flush=True)
    # the learned detectors, trained on the host meanwhile, drive the same model
    det_dir = detectors["dir"]
    t1 = time.perf_counter()
    code = detectors["proc"].wait(timeout=600)
    waited = time.perf_counter() - t1
    if code != 0:
        with open(detectors["log"]) as f:
            raise AssertionError(f"{label}: eco_train_classifiers exited {code}: "
                                 f"{f.read()[-3000:]}")
    with open(os.path.join(det_dir, "metrics.json")) as f:
        metrics = json.load(f)
    learned = get_eco_model(eco.model, eco.tokenizer, [r["question"] for r in rows],
                            sorted(set(names.values())),
                            prompt_classifier_path=os.path.join(det_dir, "prompt_classifier"),
                            token_classifier_path=os.path.join(det_dir, "token_classifier"))
    t1 = time.perf_counter()
    with _EcoRecorder() as rec2:
        out2, _, launches2 = _measured(lambda: prepare_eco_prompts(
            learned, eco.tokenizer, text_tags(get_model_identifiers("llama2-7b")), NLP_DATA,
            "forget10", f"{out_dir}/learned"))
    prepare_s = time.perf_counter() - t1
    if launches2 != want:
        raise AssertionError(f"{label} learned: launches {launches2}, expected {want}")
    _eco_file(f"{label} learned", f"{out_dir}/learned", rows)
    gated2, on_entity, n_tok2, gap2 = _eco_streams(f"{label} learned", learned, rec2.calls,
                                                   names, max_new, exact=False)
    numbers["learned"] = dict(train_s=round(detectors.get("seconds", -1.0), 1),
                              waited_s=round(waited, 1), prepare_s=round(prepare_s, 1),
                              metrics=metrics, rows=len(out2), gated=gated2,
                              flag_their_entity=on_entity, tokens_checked=n_tok2,
                              max_gap=round(gap2, 6))
    print(f"{label} learned detectors: {json.dumps(numbers['learned'])}", flush=True)
    rec2.calls.clear()
    rec.eco = eco = learned = None
    rec.calls.clear()
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    return launches, numbers


def _eco_ft_run(label, ft_dir, eco_dir, root, sync, args=ECO_FT_ARGS):
    """10c: ``cli.nlp_forget.main`` with ``forget_loss=eco_ft`` on 10b's
    prompts from 9a's checkpoint: every step finite, the LoRA b leaves off
    zero, B1-B3 as the steps' structure gives.  Returns (launches, numbers)."""
    from multimodal_unlearning_tpu_torch.cli import nlp_forget
    from multimodal_unlearning_tpu_torch.config.registry import get_model_identifiers

    mcfg = common.build_model_config(get_model_identifiers("llama2-7b"))
    with _CliRecorder(nlp_forget) as rec:
        t0 = time.perf_counter()
        _, peak, launches = _measured(lambda: nlp_forget.main(
            args + [f"model_path={ft_dir or 'null'}", f"eco_prompts_path={eco_dir}",
                    f"save_dir={os.path.join(root, 'eco_ft')}"]))
        wall = time.perf_counter() - t0
    _check_steps(label, rec.steps)
    accum = int(_arg(args, "gradient_accumulation_steps", 2))
    want = _expected_launches("eco_ft", {}, mcfg, None, steps=len(rec.steps) * accum)
    b_max = max(float(b.detach().abs().max())
                for p, b in tree_leaves_with_path(rec.loop["state"].trainable) if p[-1] == "b")
    if len(rec.steps) != 2 or launches != want or not b_max > 0:
        raise AssertionError(f"{label}: {len(rec.steps)} steps, launches {launches} (expected "
                             f"{want}), max |b| {b_max}")
    print(f"{label}: main() {wall:.1f} s; max |b| {b_max:.3e}", flush=True)
    _report_steps(label, rec.steps, launches, peak, METHODS_PEAK_BOUND_GIB)
    numbers = dict(main_s=round(wall, 1), steps=[round(m["wall"], 3) for m in rec.steps],
                   losses=[round(m["loss"], 5) for m in rec.steps], peak_gib=round(peak, 2),
                   launches={k: v for k, v in launches.items() if v})
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def _sweep_run(label, root, args=SWEEP_ARGS, device="0"):
    """10d: ``orchestrate.run_exps`` with one loss, forget then evaluation
    as subprocesses; a second run finds both artifacts and launches
    nothing.  Returns its numbers."""
    from multimodal_unlearning_tpu_torch.orchestrate import run_exps

    save = os.path.join(root, "sweep", "grad_ascent_sweep")
    logs = os.path.join(root, "sweep", "logs")
    argv = args + [f"devices=[{device}]", f"log_root={logs}", f"save_dir={save}"]
    codes, seconds, launched = [], [], []
    run = run_exps.subprocess.run
    for attempt in range(2):
        def counted(*a, **kw):
            launched.append(attempt)
            return run(*a, **kw)

        run_exps.subprocess.run = counted
        t0 = time.perf_counter()
        try:
            run_exps.main(argv)
        except SystemExit as e:
            codes.append(e.code)
        finally:
            run_exps.subprocess.run = run
        seconds.append(round(time.perf_counter() - t0, 1))
    log_files = sorted(os.listdir(os.path.join(logs, "grad_ascent")))
    agg = os.path.join(save, "eval_results", "eval_log_aggregated.json")
    if codes != [0, 0] or launched != [0, 0] or log_files != [
            "eval_grad_ascent.log", "forget_grad_ascent.log"] or not os.path.exists(
            os.path.join(save, "model.safetensors")) or not os.path.exists(agg):
        tails = {f: open(os.path.join(logs, "grad_ascent", f)).read()[-1500:] for f in log_files}
        raise AssertionError(f"{label}: exit codes {codes}, subprocesses {launched}, logs "
                             f"{log_files}: {tails}")
    numbers = dict(first_run_s=seconds[0], second_run_s=seconds[1], subprocesses=len(launched),
                   logs=log_files)
    print(f"{label}: {json.dumps(numbers)}", flush=True)
    return numbers


def run_methods_path(ft_dir, sync=torch.cuda.synchronize, salun_tiny_args=(),
                     salun_7b_args=SALUN_7B_ARGS, eco_args=ECO_ARGS, eco_ft_args=ECO_FT_ARGS,
                     sweep_args=SWEEP_ARGS, sweep_device="0"):
    """Phase 10 on 9a's checkpoint ``ft_dir`` (a random init where it is
    None): 10a SalUn, 10b ECO, 10c eco_ft forgetting, 10d the sweep.
    Returns each sub-phase's launches and numbers."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="methods_")
    out, numbers, phase_s = {}, {}, {}
    detectors = _train_detectors(os.path.join(root, "detectors"),
                                 os.path.join(root, "detectors.log"))
    try:
        t0 = time.perf_counter()
        _, numbers["10a_tiny"] = _salun_run("10a salun.yaml", list(salun_tiny_args),
                                            _mask_template("tiny-llama-test"), 0, sync)
        with cut_depth("llama2-7b", SALUN_DEPTH):
            out["10a"], numbers["10a"] = _salun_run(
                f"10a llama2-7b at {SALUN_DEPTH} layers", list(salun_7b_args),
                _mask_template("llama2-7b"), SALUN_DEPTH, sync)
        phase_s["10a"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        eco_dir = os.path.join(root, "eco")
        out["10b"], numbers["10b"] = _eco_run("10b eco_prepare", ft_dir, eco_dir, sync,
                                              detectors, list(eco_args))
        phase_s["10b"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out["10c"], numbers["10c"] = _eco_ft_run("10c forget eco_ft", ft_dir, eco_dir, root,
                                                 sync, list(eco_ft_args))
        phase_s["10c"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        numbers["10d"] = _sweep_run("10d run_exps", root, list(sweep_args), sweep_device)
        phase_s["10d"] = time.perf_counter() - t0
        print(f"phase 10 seconds by sub-phase: "
              f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}", flush=True)
        out["numbers"] = numbers
        return out
    finally:
        if detectors["proc"].poll() is None:
            detectors["proc"].kill()
            detectors["proc"].wait()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def run_serving_phase():
    """Phase 3: LLaVA-1.5-7B served through ``cli.serve.build_engine`` in
    every serving configuration (bf16, speculation, paged, int4, the int8
    serve config, paged int8).  Returns the launches of each run, the
    requests and the bf16 prefill logits."""
    cfg = serve.load_config(SERVE_ARGS + ["quantize_base=false"])
    engine, launches, specs, bf16_logits, dense_streams = run_main_path(cfg)
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
    model = engine.params
    processor = common.build_processor(serve.get_model_identifiers("llava"))
    del engine, plain
    torch.cuda.empty_cache()

    # speculation + chunked prefill + prefix cache on the bf16 model
    spec, spec_launches, spec_streams = run_spec_path(model, specs, processor)
    decode_window(spec, "bf16, speculation K=4", profile=True)
    del spec
    torch.cuda.empty_cache()
    # the paged cache on the bf16 model: plain decode on a tight pool, then
    # paged60 with speculation, chunked prefill and the system prompt
    paged_launches = run_paged_path(model, specs, processor, dense_streams, spec_streams)
    torch.cuda.empty_cache()
    # grouped int4 (W4A16, B8) on a second init from the same seed, before
    # the bf16 model is quantized to int8 in place
    b8_launches, b8_spec_launches, b8_rows_seen = run_int4_path(model, specs, bf16_logits)
    # the serve config as it ships: quantizes the model in place
    eng8, spec8, q8_launches, spec8_launches, (streams8, spec_streams8) = run_int8_path(
        model, specs, bf16_logits)
    decode_window(eng8, "int8 weights + int8 cache", profile=True)
    decode_window(spec8, "int8 weights + int8 cache, speculation K=4", profile=True)
    del eng8, spec8
    torch.cuda.empty_cache()
    # the same on a paged60 pool
    paged8_launches = run_paged_int8_path(model, specs, streams8, spec_streams8)

    del model
    gc.collect()
    torch.cuda.empty_cache()
    return (launches, specs, bf16_logits, spec_launches, paged_launches, b8_launches,
            b8_spec_launches, b8_rows_seen, q8_launches, spec8_launches, paged8_launches)


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
    if "--methods-only" in sys.argv[1:]:  # phase 2's f32 cases and phase 10: no result line
        f32_err, f32_rec = check_f32(dev, gen)
        torch.cuda.empty_cache()
        print(json.dumps({"phase10": run_methods_path(None), "f32_phase2": f32_rec}))
        return 0
    if "--nlp-only" in sys.argv[1:]:  # phase 2 at the nlp shapes and phase 9: no result line
        nlp_err, nlp_rec = check_nlp(dev, gen)
        torch.cuda.empty_cache()
        print(json.dumps({"phase9": run_nlp_path(), "nlp_phase2": nlp_rec}))
        return 0
    b1_err, b1 = check_b1(dev, gen)
    b4_err, b4 = check_b4(dev, gen)
    b4q_err, b4q = check_b4q(dev, gen)
    b5_err, b5 = check_b5(dev, gen)
    b6_err, b6 = check_b6(dev, gen)
    b7_err, b7 = check_b7(dev, gen)
    bwd_err, bwd = check_bwd(dev, gen)
    b8_err, b8_rec = check_b8(dev, gen)
    qwen_err, qwen_rec = check_qwen(dev, gen)
    nlp_err, nlp_rec = check_nlp(dev, gen)
    f32_err, f32_rec = check_f32(dev, gen)
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv[1:]:  # phases 1-2 alone: no main path, no result line
        print(json.dumps({"phase2": dict(b1=b1, b4=b4, b4q=b4q, b5=b5, b6=b6, b7=b7, bwd=bwd,
                                         b8=b8_rec, qwen=qwen_rec, nlp=nlp_rec, f32=f32_rec)}))
        return 0
    if "--qwen-only" in sys.argv[1:]:  # phases 1-2 and 8 alone: no result line
        print(json.dumps({"phase8": run_qwen_path(), "qwen_phase2": qwen_rec}))
        return 0

    with cut_depth("llava", LLAVA_SERVE_DEPTH):
        serving = run_serving_phase()
    (launches, specs, bf16_logits, spec_launches, paged_launches, b8_launches, b8_spec_launches,
     b8_rows_seen, q8_launches, spec8_launches, paged8_launches) = serving
    # the forget step at full depth, on a model of its own from the seed
    gc.collect()
    torch.cuda.empty_cache()
    step_launches, dots = run_forget_path(None)
    import shutil
    import tempfile

    with cut_depth("llava", LLAVA_CLI_DEPTH):
        cli_launches, reload_launches = run_forget_cli_path(specs)
        # CLEAR's recipe: finetune -> forget at LoRA.r=0 -> the other losses,
        # then the evaluation of the finetuned checkpoint
        ft_dir = tempfile.mkdtemp(prefix="recipe_finetune_")
        mm_results = tempfile.mkdtemp(prefix="mm_results_")
        try:
            recipe_launches = run_recipe_path(ft_dir)
            evals = run_eval_path(ft_dir)
            # phase 7's two aggregates (7b's as the gold model's), for phase
            # 9's build_tables
            for name, sub in (("gold", "eval_spec"), ("base", "eval_results")):
                os.makedirs(os.path.join(mm_results, name, "eval_results"))
                shutil.copy(os.path.join(ft_dir, sub, "eval_log_aggregated.json"),
                            os.path.join(mm_results, name, "eval_results"))
        finally:
            shutil.rmtree(ft_dir, ignore_errors=True)
    ev_a, ev_b, ev_d = (evals[k] for k in EVAL_RUNS)
    # Qwen2-VL: the shipped mm configs' family, then Qwen2.5-VL-3B
    qwen = run_qwen_path()
    qwen_eval = qwen.pop("8c_numbers")
    qwen_serving = qwen.pop("8f_numbers")
    # CLEAR's text stack on Llama-2-7B at full depth, then the results CLIs,
    # then CLEAR's methods and the sweep on 9a's checkpoint
    try:
        nlp = run_nlp_path(mm_results, then=run_methods_path)
    finally:
        shutil.rmtree(mm_results, ignore_errors=True)
    nlp_eval = nlp.pop("numbers")
    methods = nlp.pop("then")
    methods_numbers = methods.pop("numbers")

    def f32_row(name, source, replaces):
        """A kernel's f32 instance (ECO): phase 2's numbers at 10b's shapes
        and its launches in 10b's run of ``cli.eco_prepare``."""
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=methods["10b"][name], max_abs_err=f32_err[name],
                    **{k: f32_rec[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")})

    def methods_row(name):
        """A kernel's launches in SalUn's 7B run (10a) and eco_ft (10c)."""
        return {k: methods[k].get(name, 0) for k in ("10a", "10c")}

    def nlp_row(name, *subphases, **extra):
        """A kernel's text-stack numbers: phase 2's at phase 9's shapes where
        it has a case there, and its launches in phase 9's sub-phases."""
        row = {c: n for c, n in nlp_rec.get(name, {}).items()}
        if name in nlp_err:
            row["max_abs_err"] = nlp_err[name]
        return dict(row, **extra, launches={k: nlp[k].get(name, 0) for k in subphases})

    def q_row(name, *subphases):
        """A kernel's Qwen2-VL numbers: phase 2's at phase 8's shapes, its
        largest error there, and its launches in phase 8's sub-phases."""
        return dict(max_abs_err=qwen_err[name], **qwen_rec[name],
                    launches={k: qwen[k][name] for k in subphases})

    rows = [
        dict(name="flash_fwd (B1)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="multimodal_unlearning_tpu/ops/attention.py:117",
             launches=launches["flash_fwd"], max_abs_err=b1_err, **b1["prefill"],
             # the same kernel on the forget path: its launches there and its
             # numbers at that path's decoder and ViT shapes
             vit=b1["vit"],  # the serving ViT tower's shape
             forget_step=dict(launches=step_launches["flash_fwd"], decoder=b1["step"],
                              vit=b1["step_vit"]),
             # the forget CLI (phase 5) and the serving of what it saved
             forget_cli_launches=cli_launches["flash_fwd"],
             reload_launches=reload_launches["flash_fwd"],
             # CLEAR's recipe (phase 6): finetune, forget at r=0, the other losses
             recipe_launches={k: v["flash_fwd"] for k, v in recipe_launches.items()},
             # CLEAR's evaluation (phase 7): teacher-forced forwards and prefills
             eval_launches={"7a": ev_a["launches"]["flash_fwd"],
                            "7b": ev_b["launches"]["flash_fwd"],
                            "7d": ev_d["launches"]["flash_fwd"]},
             # Qwen2-VL (phase 8): head dim 80 in the towers, group 6 in the decoder
             qwen2vl=q_row("flash_fwd", "8a", "8b", "8c", "8d_shipped", "8d_int8_cache",
                           "8d_int8_paged", "8d_int8_paged_spec", "8e", *QWEN_8F_RUNS, "8g",
                           "8h", "8i"),
             # the text stack (phase 9): Llama-2-7B's training and eval shapes
             nlp=nlp_row("flash_fwd", "9a", "9b", "9c_losses", "9c_grad_proj",
                         "9c_grad_proj_l2", "9d", "9e"),
             methods_launches=methods_row("flash_fwd"),
             # the f32 instance: ECO's prefill and cache-less forward (phase 10b)
             f32=f32_row("flash_fwd_f32",
                         "multimodal_unlearning_tpu_torch/ops/csrc/flash_fwd_f32.cu",
                         "multimodal_unlearning_tpu/ops/attention.py:117")),
        dict(name="flash_bwd_dq (B2)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_bwd_dq.cu",
             replaces="multimodal_unlearning_tpu/ops/attention.py:219",
             launches=step_launches["flash_bwd_dq"], max_abs_err=bwd_err["dq"], **bwd["dq"],
             forget_cli_launches=cli_launches["flash_bwd_dq"],
             recipe_launches={k: v["flash_bwd_dq"] for k, v in recipe_launches.items()},
             qwen2vl=q_row("flash_bwd_dq", "8a", "8b", "8g", "8h", "8i"),
             # the towers' backward at head dim 80 (8g Qwen2-VL-2B, 8i Qwen2.5-VL-3B)
             d80_launches={k: qwen[f"{k}_by_d"].get("flash_bwd_dq D80", 0)
                           for k in ("8g", "8i")},
             nlp=nlp_row("flash_bwd_dq", "9a", "9b", "9c_losses", "9c_grad_proj",
                         "9c_grad_proj_l2"),
             methods_launches=methods_row("flash_bwd_dq")),
        dict(name="flash_bwd_dkv (B3)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
             replaces="multimodal_unlearning_tpu/ops/attention.py:268",
             launches=step_launches["flash_bwd_dkv"], max_abs_err=bwd_err["dkv"],
             forget_cli_launches=cli_launches["flash_bwd_dkv"],
             recipe_launches={k: v["flash_bwd_dkv"] for k, v in recipe_launches.items()},
             qwen2vl=q_row("flash_bwd_dkv", "8a", "8b", "8g", "8h", "8i"),
             d80_launches={k: qwen[f"{k}_by_d"].get("flash_bwd_dkv D80", 0)
                           for k in ("8g", "8i")},
             nlp=nlp_row("flash_bwd_dkv", "9a", "9b", "9c_losses", "9c_grad_proj",
                         "9c_grad_proj_l2"), methods_launches=methods_row("flash_bwd_dkv"),
             **bwd["dkv"]),
        dict(name="flash_decode (B4)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/decode_attention.py:51",
             launches=launches["flash_decode"], max_abs_err=b4_err, **b4,
             reload_launches=reload_launches["flash_decode"],
             eval_launches={"7a": ev_a["launches"]["flash_decode"]},
             qwen2vl=q_row("flash_decode", "8c", "8d_shipped", "8e", "8f_mixed",
                           "8f_only_base", "8f_only_ft", "8f_only_rnd", "8f_sampled",
                           "8f_sampled_reversed", "8f_generate"),
             # phase 9's decode: 32 heads on 32, D 128, 8 rows, as phase 2's case
             nlp=nlp_row("flash_decode", "9d", shape="phase 2's case (B 8, 32 heads on 32)"),
             # the f32 instance: ECO's decode steps (phase 10b)
             f32=f32_row("flash_decode_f32",
                         "multimodal_unlearning_tpu_torch/ops/csrc/flash_decode.cu",
                         "multimodal_unlearning_tpu/ops/decode_attention.py:51")),
        dict(name="flash_decode_q8 (B4q)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/decode_attention.py:71",
             launches=q8_launches["flash_decode_q8"], max_abs_err=b4q_err, **b4q,
             qwen2vl=q_row("flash_decode_q8", "8d_int8_cache", "8f_int8_prefix")),
        dict(name="chunk_decode (B5)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/chunk_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/decode_attention.py:242",
             launches=spec_launches["chunk_decode"], max_abs_err=b5_err["chunk_decode"],
             **b5["chunk_decode"]["verify"],
             # the chunked-prefill / prefix-suffix regime and the GQA case
             prefill_chunk=b5["chunk_decode"]["prefill_chunk"], gqa=b5["chunk_decode"]["gqa"],
             eval_verify=b5["chunk_decode"]["eval_verify"],
             eval_launches={"7b": ev_b["launches"]["chunk_decode"],
                            "7d": ev_d["launches"]["chunk_decode"]},
             qwen2vl=q_row("chunk_decode"),
             nlp=nlp_row("chunk_decode", "9e", shape="phase 2's verify case (B 8, C 5)")),
        dict(name="chunk_decode_q8 (B5q)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/chunk_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/decode_attention.py:267",
             launches=spec8_launches["chunk_decode_q8"], max_abs_err=b5_err["chunk_decode_q8"],
             **b5["chunk_decode_q8"]["verify"],
             prefill_chunk=b5["chunk_decode_q8"]["prefill_chunk"],
             gqa=b5["chunk_decode_q8"]["gqa"], eval_verify=b5["chunk_decode_q8"]["eval_verify"],
             qwen2vl=q_row("chunk_decode_q8", "8f_int8_prefix")),
        dict(name="paged_decode (B6)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/paged_attention.py:105",
             launches=paged_launches["paged_decode"], max_abs_err=b6_err["paged_decode"],
             **b6["paged_decode"][128], page16=b6["paged_decode"][16],
             qwen2vl=q_row("paged_decode")),
        dict(name="paged_decode_q8 (B6q)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/flash_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/paged_attention.py:148",
             launches=paged8_launches["paged_decode_q8"], max_abs_err=b6_err["paged_decode_q8"],
             **b6["paged_decode_q8"][128], page16=b6["paged_decode_q8"][16],
             qwen2vl=q_row("paged_decode_q8", "8d_int8_paged", "8f_int8_paged_prefix")),
        dict(name="paged_chunk (B7)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/chunk_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/paged_attention.py:341",
             launches=paged_launches["paged_chunk"], max_abs_err=b7_err["paged_chunk"],
             **b7["paged_chunk"]["verify"],
             **{k: b7["paged_chunk"][k] for k in ("prefill_chunk", "gqa", "straddle",
                                                   "verify_p16")},
             qwen2vl=q_row("paged_chunk")),
        dict(name="paged_chunk_q8 (B7q)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/chunk_decode.cu",
             replaces="multimodal_unlearning_tpu/ops/paged_attention.py:384",
             launches=paged8_launches["paged_chunk_q8"], max_abs_err=b7_err["paged_chunk_q8"],
             **b7["paged_chunk_q8"]["verify"],
             **{k: b7["paged_chunk_q8"][k] for k in ("prefill_chunk", "gqa", "straddle",
                                                      "verify_p16")},
             qwen2vl=q_row("paged_chunk_q8", "8d_int8_paged_spec", "8f_int8_paged_prefix",
                           "8f_int8_paged_spec_prefix")),
        dict(name="int4_matmul (B8)", route="cuda",
             source="multimodal_unlearning_tpu_torch/ops/csrc/int4_matmul.cu",
             replaces="multimodal_unlearning_tpu/ops/int4_matmul.py:45",
             launches=b8_launches, max_abs_err=b8_err,
             # 8h: the QLoRA run's forward products at up to 1,024 rows
             qlora_launches=qwen["8h"]["int4_matmul"],
             # the headline case: gate/up at decode (M 8), then every case
             **{k: v for k, v in b8_rec["gate_up_m8"].items() if k != "library"},
             library_call=b8_rec["gate_up_m8"]["library"],
             speculative_launches=b8_spec_launches, rows_per_product=b8_rows_seen,
             decode_step_ms=b8_rec["decode_step_ms"], host_us_per_call_m8=b8_rec["host_us_m8"],
             cases={k: v for k, v in b8_rec.items()
                    if k not in ("gate_up_m8", "decode_step_ms", "host_us_m8")}),
    ]
    print(json.dumps({"eval": evals, "qwen_eval": qwen_eval, "qwen_serving": qwen_serving,
                      "nlp_eval": nlp_eval, "methods": methods_numbers}))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
