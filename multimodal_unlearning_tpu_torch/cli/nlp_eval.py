"""Text-stack (TOFU) evaluation entry point of the port.

    python -m multimodal_unlearning_tpu_torch.cli.nlp_eval model_path=<dir> \\
        'data_path=[synthetic,synthetic,synthetic,synthetic]' ...

Counterpart of ``multimodal_unlearning_tpu/cli/nlp_eval.py``: reads
``configs/nlp/eval_everything.yaml`` with ``key=value`` overrides and runs
its four zipped tasks (retain, real authors, world facts, forget):
teacher-forced losses of the answer, the paraphrase and the perturbed
answers (kernel B1), greedy generation from the prompt recovered at the
family's split symbol (B1 in the prefill, then B4, or B5 under
``speculative_k``) and ROUGE against the text after the symbol
(``evaluation/evaluator.nlp_get_all_evals``), into one JSON file per task
and ``eval_log_aggregated.json`` under ``save_dir``, in the JAX CLI's
schema.  ``cli/nlp_aggregate.py`` reads them.

Options as in the JAX CLI: ``ds_size``, ``overwrite``, ``quantize_base``
(true / int8 / int4) with ``int8_compute``, ``kv_cache_dtype=int8``,
``speculative_k``, ``engine_generate`` (``engine_slots``, ``engine_chunk``,
``spec_ref_len``, ``page_size``, ``kv_pool_pages``) and
``reinitialize_weights`` (the port's own random init from seed 0, not the
JAX package's stream).  ``aot_param_layouts`` is accepted and ignored; mesh
axes above 1 raise.  Attention follows the registry's ``flash_attention2``
(``common.attn_impl_of``), as in the training CLIs: a family that turns it
off (the tiny test families, whose head dim the kernels do not take) runs
the plain attention on the card too.  The card is the device unless
``+device=cpu`` is given.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.cli import common
from multimodal_unlearning_tpu_torch.cli.mm_eval import _check_ported, eval_engine
from multimodal_unlearning_tpu_torch.cli.nlp_finetune import text_tags
from multimodal_unlearning_tpu_torch.config import main as config_main
from multimodal_unlearning_tpu_torch.config.registry import config_dir, get_model_identifiers
from multimodal_unlearning_tpu_torch.data import DataLoader
from multimodal_unlearning_tpu_torch.data.nlp import TextDatasetQA, eval_collator
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.evaluation import evaluator
from multimodal_unlearning_tpu_torch.evaluation.generate import greedy_generate, pad_prompts
from multimodal_unlearning_tpu_torch.models import llama


def run(cfg):
    # int8_compute is a module-global switch: give the caller's value back
    prev = llama.INT8_COMPUTE
    try:
        return _run(cfg)
    finally:
        llama.enable_int8_compute(prev)


def _run(cfg):
    _check_ported(cfg)
    device = resolve_device(cfg.get("device"))
    model_cfg = get_model_identifiers(cfg.model_family)
    dtype = common.dtype_of(cfg)
    Path(cfg.save_dir).mkdir(parents=True, exist_ok=True)
    tok = common.build_processor(model_cfg, cfg).tokenizer
    tags = text_tags(model_cfg)
    kind, mcfg, model = common.init_or_load_params(
        model_cfg, cfg.get("model_path"), seed=cfg.get("seed", 42), dtype=dtype, device=device)
    if cfg.get("quantize_base"):
        model = common.quantize_base_params(model, kind, cfg.quantize_base)
        if cfg.get("int8_compute"):
            llama.enable_int8_compute(True)
    if cfg.get("reinitialize_weights"):
        # the sanity ablation: random weights (the port's stream from seed 0)
        del model
        model = common._init_model(kind, mcfg, 0, dtype, device)

    _pad_rows, _target = common.make_tail_padder(cfg.batch_size)
    # the kernels unless the registry turns them off (the tiny test families:
    # head dim 16, which the kernels do not take)
    attn = common.attn_impl_of(model_cfg)

    def apply_fn(batch):
        B = len(batch["input_ids"])
        to = _target(B)
        ids = _pad_rows(np.asarray(batch["input_ids"]), to)
        mask = _pad_rows(np.asarray(batch["attention_mask"]), to)
        with torch.inference_mode():
            logits = model(torch.from_numpy(ids).to(device).long(),
                           attention_mask=torch.from_numpy(mask).to(device),
                           compute_dtype=dtype, attn_impl=attn)["logits"]
        return {"logits": logits[:B]}

    cache_dtype = torch.int8 if str(cfg.get("kv_cache_dtype") or "") == "int8" else dtype
    aot_layouts = bool(cfg.get("aot_param_layouts", False))  # an XLA option: ignored
    speculate_k = int(cfg.get("speculative_k", 0) or 0)

    def generate_fn(q_texts, ref_texts=None):
        ids, mask = pad_prompts([tok.encode(q, add_special_tokens=True) for q in q_texts],
                                tok.pad_token_id)
        B = len(ids)
        to = _target(B)
        dref = None
        if speculate_k and ref_texts is not None:
            # the ground-truth answers seed the lookup corpus (-2: padding);
            # drafts are verified, the output stays greedy
            enc = [tok.encode(r, add_special_tokens=False) for r in ref_texts]
            R = -(-max((len(e) for e in enc), default=0) // 64) * 64
            if R:
                dref = np.full((len(enc), R), -2, np.int32)
                for i, e in enumerate(enc):
                    dref[i, :len(e)] = e
                dref = _pad_rows(dref, to)
        gen = greedy_generate(
            model, mcfg, _pad_rows(ids, to), _pad_rows(mask, to),
            max_new_tokens=cfg.generation.max_new_tokens,
            pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id,
            aot_layouts=aot_layouts, cache_dtype=cache_dtype, compute_dtype=dtype,
            speculate_k=speculate_k, draft_ref=dref, attn_impl=attn)
        return [tok.decode(row, skip_special_tokens=True) for row in gen.cpu().numpy()[:B]]

    # engine_generate: each task's generations in one drain of the serving
    # engine (evaluator._nlp_pregenerate); the same texts
    gen_engine = eval_engine(cfg, model, mcfg, kind, tok, cache_dtype, dtype, device, attn)

    aggregated = {}
    zipped = zip(cfg.data_path, cfg.split_list, cfg.question_key, cfg.answer_key,
                 cfg.eval_task, cfg.base_answer_key, cfg.perturbed_answer_key)
    for fol, split, qk, ak, task, base_ak, pert_ak in zipped:
        print(f"Working on eval task {task} with split {split}")
        if os.path.exists(os.path.join(cfg.save_dir, f"{task}.json")) and not cfg.get(
                "overwrite", True):
            continue

        def loader(answer_key, bs):
            ds = TextDatasetQA(fol, tok, tags, max_length=cfg.max_length, split=split,
                               question_key=qk, answer_key=answer_key)
            if cfg.ds_size:
                ds.rows_ = ds.rows_[: min(cfg.ds_size, len(ds.rows_))]
            return DataLoader(ds, bs, eval_collator, drop_last=False)

        small_bs = max(cfg.batch_size // 4, 1)  # the perturbed loaders' batch
        logs = evaluator.nlp_get_all_evals(
            task, loader(ak, cfg.batch_size), loader(base_ak, small_bs),
            loader(pert_ak, small_bs), apply_fn=apply_fn, generate_fn=generate_fn, tok=tok,
            tags=tags, gen_engine=gen_engine, max_new_tokens=int(cfg.generation.max_new_tokens))
        evaluator.save_eval_logs(cfg.save_dir, task, logs)
        aggregated[f"{task}.json"] = logs

    evaluator.save_aggregated(cfg.save_dir, aggregated)
    print(f"Saved aggregated eval to {cfg.save_dir}/eval_log_aggregated.json")
    return aggregated


main = config_main(config_dir() / "nlp", "eval_everything")(run)

if __name__ == "__main__":
    main()
