"""MM evaluation entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.mm_eval model_family=llava \\
        model_path=<dir> [engine_generate=true speculative_k=4 ...]

Counterpart of ``multimodal_unlearning_tpu/cli/mm_eval.py``, CLEAR's third
step (finetune, forget, evaluate): reads ``configs/mm/eval.yaml`` with
``key=value`` overrides and runs its six zipped tasks -- teacher-forced
losses of the answer, the paraphrase and the perturbed answers (kernel B1
in both towers), greedy generation from the recovered question (B1 in the
prefill, then B4, or B5 under ``speculative_k``) and ROUGE -- into one JSON
file per task and ``eval_log_aggregated.json`` under ``save_dir``, in the
JAX CLI's schema.  ``cli/mm_calculate_metrics.py`` reads them.

Options as in the JAX CLI: ``eval_task_ids``, ``overwrite``, ``ds_size``,
``generate_with_images``, ``quantize_base`` (true / int8 / int4) with
``int8_compute``, ``kv_cache_dtype=int8``, ``speculative_k``,
``engine_generate`` (the serving engine drains each task's generations at
once: ``engine_slots``, ``engine_chunk``, ``spec_ref_len``, ``page_size``,
``kv_pool_pages``) and ``reinitialize_weights`` (the port's own random init
from seed 0, not the JAX package's stream).  ``aot_param_layouts`` is
accepted and ignored; mesh axes above 1 raise.  The card is the device
unless ``+device=cpu`` is given.
"""

from __future__ import annotations

import os
from functools import partial
from pathlib import Path

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader, ImageCaptioningDataset
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.evaluation import evaluator
from multimodal_unlearning_tpu_torch.evaluation.generate import greedy_generate
from multimodal_unlearning_tpu_torch.models import llama


def get_dataloader(quest_strat, quest_key, cap_key, fold, split, bs, ds_size, collate, seed=0):
    ds = ImageCaptioningDataset(fold, split=split, caption_key=cap_key,
                                question_strategy=quest_strat, question_key=quest_key, seed=seed)
    if ds_size:
        ds.rows_ = ds.rows_[: min(ds_size, len(ds.rows_))]
    return DataLoader(ds, bs, collate, drop_last=False)


def eval_engine(cfg, model, mcfg, kind, tok, cache_dtype, dtype, device, attn_impl="auto"):
    """With ``engine_generate``, the serving engine that generates each
    task's texts in ONE continuous-batching drain (the same texts as the
    per-batch route), sized from the eval config; else None."""
    if not cfg.get("engine_generate"):
        return None
    from multimodal_unlearning_tpu_torch.serve import ServingEngine

    speculate_k = int(cfg.get("speculative_k", 0) or 0)
    slack = 2 * speculate_k + 2 if speculate_k else 0
    return ServingEngine(
        model, mcfg, kind,
        num_slots=int(cfg.get("engine_slots", cfg.batch_size)),
        max_len=-(-(cfg.max_length + cfg.generation.max_new_tokens + slack) // 128) * 128,
        chunk=int(cfg.get("engine_chunk", 16)),
        pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id,
        cache_dtype=cache_dtype, compute_dtype=dtype,
        speculate_k=speculate_k,
        spec_ref_len=int(cfg.get("spec_ref_len", 128) or 0) if speculate_k else 0,
        page_size=int(cfg.get("page_size", 0) or 0),
        kv_pool_pages=int(cfg.get("kv_pool_pages", 0) or 0) or None,
        attn_impl=attn_impl, device=device)


def run(cfg):
    # int8_compute is a module-global switch: give the caller's value back
    prev = llama.INT8_COMPUTE
    try:
        return _run(cfg)
    finally:
        llama.enable_int8_compute(prev)


def _check_ported(cfg) -> None:
    mesh = cfg.get("mesh") or {}
    big = {k: v for k, v in mesh.items() if v is not None and int(v) > 1}
    if big:
        raise NotImplementedError(f"mesh axes above 1 ({big}) need multi-GPU, which is not "
                                  "ported yet")


def _run(cfg):
    lists = [cfg.data_path, cfg.split_list, cfg.eval_task, cfg.question_key, cfg.answer_key,
             cfg.base_answer_key, cfg.perturbed_answer_key]
    if len({len(x) for x in lists}) != 1:
        raise ValueError("data_path, split, eval_task, question/answer keys must be the same "
                         "length")
    eval_task_ids = (cfg.eval_task_ids if cfg.get("eval_task_ids") not in (None, "None")
                     else list(range(len(cfg.data_path))))
    _check_ported(cfg)
    device = resolve_device(cfg.get("device"))

    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    Path(cfg.save_dir).mkdir(parents=True, exist_ok=True)
    processor = common.build_processor(model_cfg, cfg)
    kind, mcfg, model = common.init_or_load_params(
        model_cfg, cfg.get("model_path"), seed=cfg.get("seed", 42), dtype=dtype, device=device)
    if cfg.get("quantize_base"):
        model = common.quantize_base_params(model, kind, cfg.quantize_base)
        if cfg.get("int8_compute"):
            llama.enable_int8_compute(True)
    vlm = common.is_vlm(kind)
    if cfg.get("reinitialize_weights"):
        # the sanity ablation: random weights (the port's stream from seed 0)
        del model
        model = common._init_model(kind, mcfg, 0, dtype, device)

    def model_logits(input_ids, attention_mask, pixel_values):
        with torch.inference_mode():
            kw = dict(attention_mask=torch.from_numpy(attention_mask).to(device),
                      compute_dtype=dtype)
            if vlm:
                kw["pixel_values"] = torch.from_numpy(pixel_values).to(device, dtype)
            return model(torch.from_numpy(input_ids).to(device).long(), **kw)["logits"]

    _pad_rows, _target = common.make_tail_padder(cfg.batch_size)

    def apply_fn(batch):
        B = len(batch["input_ids"])
        to = _target(B)
        pix = batch.get("pixel_values")
        logits = model_logits(_pad_rows(np.asarray(batch["input_ids"]), to),
                              _pad_rows(np.asarray(batch["attention_mask"]), to),
                              None if pix is None else _pad_rows(np.asarray(pix), to))
        return {"logits": logits[:B]}

    tok = processor.tokenizer
    cache_dtype = torch.int8 if str(cfg.get("kv_cache_dtype") or "") == "int8" else dtype
    aot_layouts = bool(cfg.get("aot_param_layouts", False))  # an XLA option: ignored
    speculate_k = int(cfg.get("speculative_k", 0) or 0)

    def generate_fn(batch, max_new_tokens):
        pix = batch.get("pixel_values")
        dref = batch.get("draft_ref") if speculate_k else None
        B = len(batch["input_ids"])
        to = _target(B)
        gen = greedy_generate(
            model, mcfg,
            _pad_rows(np.asarray(batch["input_ids"]), to),
            _pad_rows(np.asarray(batch["attention_mask"]), to),
            max_new_tokens=max_new_tokens,
            pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id,
            pixel_values=None if pix is None else _pad_rows(np.asarray(pix), to),
            is_vlm=vlm, aot_layouts=aot_layouts, cache_dtype=cache_dtype, compute_dtype=dtype,
            speculate_k=speculate_k,
            draft_ref=None if dref is None else _pad_rows(
                common.pad_width(np.asarray(dref), 64, -2), to))
        return [tok.decode(row, skip_special_tokens=True) for row in gen.cpu().numpy()[:B]]

    gen_engine = eval_engine(cfg, model, mcfg, kind, tok, cache_dtype, dtype, device)

    aggregated = {}
    zipped = zip(cfg.data_path, cfg.split_list, cfg.question_key, cfg.question_strategy,
                 cfg.answer_key, cfg.eval_task, cfg.base_answer_key, cfg.perturbed_answer_key)
    for task_idx, (fol, split, qk, qs, ak, task, base_ak, pert_ak) in enumerate(zipped):
        if task_idx not in eval_task_ids:
            continue
        print(f"Working on eval task {task} with split {split}")
        save_filename = os.path.join(cfg.save_dir, f"{task}.json")
        if os.path.exists(save_filename) and not cfg.get("overwrite", True):
            print(f"Skipping {task}: exists")
            continue

        collate_ans = partial(processor.collate, max_length=cfg.max_length,
                              return_indices=True, return_answers=True)
        collate_plain = partial(processor.collate, max_length=cfg.max_length,
                                return_indices=True)
        small_bs = max(cfg.batch_size // 4, 1)  # the perturbed loaders' batch
        eval_dl = get_dataloader(qs, qk, ak, fol, split, cfg.batch_size, cfg.ds_size, collate_ans)
        base_dl = get_dataloader(qs, qk, base_ak, fol, split, small_bs, cfg.ds_size, collate_plain)
        pert_dl = get_dataloader(qs, qk, pert_ak, fol, split, small_bs, cfg.ds_size, collate_plain)

        logs = evaluator.get_all_evals(
            task, eval_dl, base_dl, pert_dl, apply_fn=apply_fn, generate_fn=generate_fn,
            processor=processor, max_new_tokens=cfg.generation.max_new_tokens,
            generate_with_images=bool(cfg.get("generate_with_images", False)),
            gen_engine=gen_engine)
        evaluator.save_eval_logs(cfg.save_dir, task, logs)
        aggregated[f"{task}.json"] = logs

    evaluator.save_aggregated(cfg.save_dir, aggregated)
    print(f"Saved aggregated eval to {cfg.save_dir}/eval_log_aggregated.json")
    return aggregated


main = config_main(config_dir() / "mm", "eval")(run)

if __name__ == "__main__":
    main()
