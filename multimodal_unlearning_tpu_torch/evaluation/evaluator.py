"""Per-task evaluation: teacher-forced losses, truth ratios, generation, ROUGE.

The port's copy of the mm half of
``multimodal_unlearning_tpu/evaluation/evaluator.py`` and its savers.  The
JSON schema is the reference eval's: per task {average_perturb_loss,
avg_paraphrased_loss, truth_ratio, paraphrased_loss, perturb_loss,
num_token_paraphrased, num_token_perturb, avg_gt_loss, gt_loss,
num_token_gt, generated_text, rouge1_recall, rougeL_recall[,
normalized_gt_loss]} keyed by dataset index, plus
``eval_log_aggregated.json``.

Kept from the reference, on purpose:
- generation re-tokenizes the decoded question *without images* (the
  decoded input cut at the last occurrence of the decoded answer);
  ``generate_with_images`` generates from the question span with its image
  instead;
- ``normalized_gt_loss`` only for tasks whose name lacks ``eval_log``.

Losses are per-sequence summed CE over the -100-masked labels
(``train/losses.seq_sum_ce``).  ROUGE is ``evaluation/rouge.py``'s copy of
``rouge_score``.

The nlp half (``nlp_get_all_evals``) recovers the prompt and the ROUGE
ground truth from the decoded input split at the family's split symbol
(``nlp_split_symbol``): the ground truth is the decoded text after the
symbol, not the dataset's answer column, which only a row without the
symbol falls back to.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.evaluation.generate import pad_prompts
from multimodal_unlearning_tpu_torch.evaluation.rouge import RougeScorer
from multimodal_unlearning_tpu_torch.train.losses import seq_sum_ce

__all__ = ["rouge_scorer", "eval_accuracy", "eval_rouge_recall", "eval_perturbation_ratio",
           "get_all_evals", "nlp_split_symbol", "nlp_get_all_evals", "save_eval_logs",
           "save_aggregated"]

rouge_scorer = RougeScorer(["rouge1", "rougeL"], use_stemmer=True)


def eval_accuracy(logits, labels):
    """Next-token accuracy over the valid shifted labels."""
    preds = torch.argmax(torch.as_tensor(logits), -1).cpu().numpy()
    shifted = np.asarray(labels)[..., 1:]
    mask = shifted != -100
    acc = ((preds[..., :-1] == shifted) & mask).sum() / max(mask.sum(), 1)
    return {"eval accuracy": float(acc)}


def eval_rouge_recall(gen_answers, true_ans, indices):
    rouge1, rougeL = {}, {}
    for idx, gen, gt in zip(indices, gen_answers, true_ans):
        scores = rouge_scorer.score(gt, gen)
        rouge1[idx] = scores["rouge1"].recall
        rougeL[idx] = scores["rougeL"].recall
    return {"rouge1_recall": rouge1, "rougeL_recall": rougeL}


def _model_losses(apply_fn, batch):
    """(per-seq summed CE, valid-token counts) for one collated batch, as
    numpy."""
    logits = apply_fn(batch)["logits"]
    with torch.inference_mode():
        loss = seq_sum_ce(logits, torch.as_tensor(np.asarray(batch["labels"])).to(logits.device))
    n_tok = (np.asarray(batch["labels"]) != -100).sum(-1)
    return loss.float().cpu().numpy(), n_tok


def eval_perturbation_ratio(base_loader, perturb_loader, apply_fn):
    """The paraphrased answer against N perturbed answers per sample."""
    logs = defaultdict(dict)
    for batch, perturb in zip(base_loader, perturb_loader):
        batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        perturb = {k: v for k, v in perturb.items() if isinstance(v, np.ndarray)}
        indices = [int(i) for i in batch.pop("indices")]
        perturb.pop("indices")
        bsz, num_seq = perturb["input_ids"].shape[:2]
        flat_perturb = {k: v.reshape(bsz * num_seq, *v.shape[2:]) for k, v in perturb.items()}

        gt_loss, num_token_gt = _model_losses(apply_fn, batch)
        p_loss_flat, p_tok_flat = _model_losses(apply_fn, flat_perturb)
        perturb_loss = p_loss_flat.reshape(bsz, num_seq)
        num_token_perturb = p_tok_flat.reshape(bsz, num_seq)

        perturb_loss_pt = perturb_loss / num_token_perturb
        gt_loss_pt = gt_loss / num_token_gt
        truth_ratio = np.exp(gt_loss_pt - perturb_loss_pt.mean(-1))

        logs["average_perturb_loss"].update(dict(zip(indices, perturb_loss_pt.tolist())))
        logs["avg_paraphrased_loss"].update(dict(zip(indices, gt_loss_pt.tolist())))
        logs["truth_ratio"].update(dict(zip(indices, truth_ratio.tolist())))
        logs["paraphrased_loss"].update(dict(zip(indices, gt_loss.tolist())))
        logs["perturb_loss"].update(dict(zip(indices, perturb_loss.tolist())))
        logs["num_token_paraphrased"].update(dict(zip(indices, num_token_gt.tolist())))
        logs["num_token_perturb"].update(dict(zip(indices, num_token_perturb.tolist())))
    return logs


def _questions(batch, tok, answers):
    """The decoded inputs cut before the last occurrence of each decoded
    answer (the whole decoded input where the answer is empty or absent)."""
    str_inputs = [tok.decode(r, skip_special_tokens=True) for r in batch["input_ids"]]
    return [s[: s.rfind(a)] if a and s.rfind(a) != -1 else s
            for s, a in zip(str_inputs, answers)]


def _question_spans(batch):
    """Per row, the -100-labelled non-pad token ids (the question with its
    expanded image tokens): exact and tokenizer-agnostic."""
    ids = np.asarray(batch["input_ids"])
    qmask = (np.asarray(batch["labels"]) == -100) & (np.asarray(batch["attention_mask"]) == 1)
    return [ids[r][qmask[r]].tolist() for r in range(len(ids))]


def _gen_prompt_rows(batch, tok, generate_with_images):
    """Generation inputs for one eval batch: the per-row prompt ids (built
    exactly as ``get_all_evals`` builds them), pixel rows, and the
    ground-truth draft corpus.  ``batch`` must still hold 'answers'."""
    raw_answers = np.asarray(batch["answers"])
    answers = [tok.decode(a, skip_special_tokens=True) for a in raw_answers]
    draft_ref = np.where(raw_answers == tok.pad_token_id, -2, raw_answers)
    if generate_with_images:
        return _question_spans(batch), np.asarray(batch["pixel_values"]), draft_ref
    rows = [tok.encode(q, add_special_tokens=True) for q in _questions(batch, tok, answers)]
    return rows, None, draft_ref


def _pregenerate(gen_engine, eval_loader, tok, max_new_tokens, generate_with_images):
    """Every eval sample's question is submitted to the serving engine up
    front and the engine drains once: finished slots refill across batch
    boundaries, so one long answer never stalls the rest of the task.  The
    texts equal the per-batch ``greedy_generate`` route's."""
    reqs = []
    for batch in eval_loader:
        rows, pix, dref = _gen_prompt_rows(batch, tok, generate_with_images)
        for i, row in enumerate(rows):
            reqs.append(gen_engine.submit(
                row, max_new_tokens,
                pixel_values=None if pix is None else pix[i],
                draft_ref=dref[i].tolist() if gen_engine.K else None))
    gen_engine.drain(reqs)
    return [tok.decode(r.tokens, skip_special_tokens=True) for r in reqs]


def get_all_evals(eval_task: str, eval_loader, base_loader, perturb_loader, *, apply_fn,
                  generate_fn, processor, max_new_tokens: int,
                  generate_with_images: bool = False, gen_engine=None):
    """One task's logs.  ``apply_fn(batch) -> {"logits"}`` is the
    teacher-forced forward; ``generate_fn(batch, max_new_tokens) -> texts``
    the per-batch generation.  ``gen_engine``: a ``ServingEngine`` instead,
    which generates the whole task in one continuous-batching drain
    (``_pregenerate``); the texts are the same."""
    logs = defaultdict(dict)
    gen_answers, true_ans, all_indices = [], [], []

    logs.update(eval_perturbation_ratio(base_loader, perturb_loader, apply_fn))

    tok = processor.tokenizer
    gen_cache = (_pregenerate(gen_engine, eval_loader, tok, max_new_tokens, generate_with_images)
                 if gen_engine is not None else None)
    gen_cursor = 0
    for batch in eval_loader:
        indices = [int(i) for i in batch.pop("indices")]
        raw_answers = np.asarray(batch.pop("answers"))
        answers = [tok.decode(a, skip_special_tokens=True) for a in raw_answers]
        # the ground-truth answer tokens as the speculative lookup corpus
        # (-2 marks padding, which never matches); generation stays greedy
        draft_ref = np.where(raw_answers == tok.pad_token_id, -2, raw_answers)

        gt_loss, num_token_gt = _model_losses(apply_fn, batch)
        questions = _questions(batch, tok, answers)

        if gen_cache is not None:
            n_rows = len(batch["input_ids"])
            gen_texts = gen_cache[gen_cursor: gen_cursor + n_rows]
            gen_cursor += n_rows
        else:
            if generate_with_images:
                ids, mask = pad_prompts(_question_spans(batch), tok.pad_token_id)
                pix = batch["pixel_values"]
            else:
                # the reference's quirk: text-only questions, re-tokenized
                ids, mask = pad_prompts([tok.encode(q, add_special_tokens=True)
                                         for q in questions], tok.pad_token_id)
                pix = None
            gen_texts = generate_fn({"input_ids": ids, "attention_mask": mask,
                                     "pixel_values": pix, "draft_ref": draft_ref},
                                    max_new_tokens)

        gen_answers.extend(gen_texts)
        true_ans.extend(answers)
        all_indices.extend(indices)

        gt_loss_pt = gt_loss / num_token_gt
        logs["avg_gt_loss"].update(dict(zip(indices, gt_loss_pt.tolist())))
        logs["gt_loss"].update(dict(zip(indices, gt_loss.tolist())))
        logs["num_token_gt"].update(dict(zip(indices, num_token_gt.tolist())))
        logs["generated_text"].update(dict(zip(indices, zip(questions, gen_texts, answers))))

    logs.update(eval_rouge_recall(gen_answers, true_ans, all_indices))
    if "eval_log" not in eval_task:
        logs["normalized_gt_loss"] = _normalized_gt_loss(logs)
    return logs


def _normalized_gt_loss(logs) -> dict:
    normalized = {}
    for idx, gl in logs["avg_gt_loss"].items():
        truth_prob = np.exp(-gl)
        perturb_prob = np.exp(-np.asarray(logs["average_perturb_loss"][idx]))
        normalized[idx] = float(-np.log(truth_prob / (perturb_prob.sum() + truth_prob)))
    return normalized


def nlp_split_symbol(tags: dict) -> tuple[str, bool]:
    """(split symbol, re-append) of the text stack's prompt recovery: an
    empty ``answer_tag`` is the instruction format, split at
    ``question_end_tag`` and re-append it to the prompt; otherwise split at
    ``answer_tag`` and do not (the model emits the tag itself)."""
    answer_tag = tags.get("answer_tag", "") or ""
    if answer_tag:
        return answer_tag, False
    return tags.get("question_end_tag", "") or "", True


def _nlp_split_questions(dec, answers, split_symbol, reappend):
    """(prompts, ground truths) from the decoded inputs; a row without the
    symbol keeps its whole text as the prompt and its dataset answer."""
    q_texts, gts = [], []
    for s, fallback in zip(dec, answers):
        parts = s.split(split_symbol) if split_symbol else [s]
        if len(parts) > 1:
            q_texts.append(parts[0] + (split_symbol if reappend else ""))
            gts.append(parts[1])
        else:
            q_texts.append(s)
            gts.append(fallback)
    return q_texts, gts


def _nlp_pregenerate(gen_engine, eval_loader, tok, tags, max_new_tokens):
    """The text stack's ``_pregenerate``: every recovered prompt submitted
    to the serving engine, its ground truth as the speculative draft
    corpus, one drain."""
    split_symbol, reappend = nlp_split_symbol(tags)
    reqs = []
    for batch in eval_loader:
        answers = batch.get("answers_text", [""] * len(batch["input_ids"]))
        dec = [tok.decode(r, skip_special_tokens=True) for r in batch["input_ids"]]
        q_texts, gts = _nlp_split_questions(dec, answers, split_symbol, reappend)
        for q, gt in zip(q_texts, gts):
            dref = tok.encode(gt, add_special_tokens=False) if gen_engine.K else None
            reqs.append(gen_engine.submit(tok.encode(q, add_special_tokens=True),
                                          max_new_tokens, draft_ref=dref))
    gen_engine.drain(reqs)
    return [tok.decode(r.tokens, skip_special_tokens=True) for r in reqs]


def nlp_get_all_evals(eval_task: str, eval_loader, base_loader, perturb_loader, *, apply_fn,
                      generate_fn, tok, tags: dict, normalize_gt: bool | None = None,
                      gen_engine=None, max_new_tokens: int | None = None):
    """One text task's logs.  ``generate_fn(prompt_texts, ref_texts=None)
    -> texts`` encodes, pads, generates and decodes (``ref_texts``, the
    ground truths, seed the speculative draft corpus); ``gen_engine``: a
    ``ServingEngine`` that generates the whole task in one drain instead.
    ``normalize_gt`` defaults to every task but the ``eval_log*`` ones."""
    logs = defaultdict(dict)
    logs.update(eval_perturbation_ratio(base_loader, perturb_loader, apply_fn))

    split_symbol, reappend = nlp_split_symbol(tags)
    gen_cache = (_nlp_pregenerate(gen_engine, eval_loader, tok, tags, max_new_tokens)
                 if gen_engine is not None else None)
    gen_cursor = 0
    gen_answers, true_ans, all_indices = [], [], []
    for batch in eval_loader:
        indices = [int(i) for i in batch.pop("indices")]
        batch.pop("questions", None)
        answers = batch.pop("answers_text", [""] * len(indices))

        gt_loss, num_token_gt = _model_losses(apply_fn, batch)

        dec = [tok.decode(r, skip_special_tokens=True) for r in batch["input_ids"]]
        q_texts, gts = _nlp_split_questions(dec, answers, split_symbol, reappend)
        if gen_cache is not None:
            gen_texts = gen_cache[gen_cursor: gen_cursor + len(q_texts)]
            gen_cursor += len(q_texts)
        else:
            gen_texts = generate_fn(q_texts, ref_texts=gts)

        gen_answers.extend(gen_texts)
        true_ans.extend(gts)
        all_indices.extend(indices)
        gt_loss_pt = gt_loss / num_token_gt
        logs["avg_gt_loss"].update(dict(zip(indices, gt_loss_pt.tolist())))
        logs["gt_loss"].update(dict(zip(indices, gt_loss.tolist())))
        logs["num_token_gt"].update(dict(zip(indices, num_token_gt.tolist())))
        logs["generated_text"].update(dict(zip(indices, zip(q_texts, gen_texts, gts))))

    logs.update(eval_rouge_recall(gen_answers, true_ans, all_indices))
    if normalize_gt is None:
        normalize_gt = "eval_log" not in eval_task
    if normalize_gt:
        logs["normalized_gt_loss"] = _normalized_gt_loss(logs)
    return logs


def save_eval_logs(save_dir, eval_task, logs) -> str:
    from multimodal_unlearning_tpu_torch.cli.common import rank_suffix

    Path(save_dir).mkdir(parents=True, exist_ok=True)
    path = os.path.join(save_dir, f"{eval_task}{rank_suffix()}.json")
    with open(path, "w") as f:
        json.dump(logs, f, indent=4, default=float)
    return path


def save_aggregated(save_dir, aggregated) -> str:
    from multimodal_unlearning_tpu_torch.cli.common import rank_suffix

    path = os.path.join(save_dir, f"eval_log_aggregated{rank_suffix()}.json")
    with open(path, "w") as f:
        json.dump(aggregated, f, indent=4, default=float)
    return path
