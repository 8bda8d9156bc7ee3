"""Metrics and aggregation: Model Utility, Forget Quality, truth ratios.

The port's copy of ``multimodal_unlearning_tpu/evaluation/metrics.py``
(numpy and scipy only, as there):
- the mm calculator (``mm_calculate_metrics``): its task map, the
  scalar-mean perturbed loss of its truth ratios, and the 1 - JS table
  variant;
- the TOFU-style stack the nlp side uses, and the nlp aggregator's own
  Model Utility;
- the legacy 2-process interleave repair.
"""

from __future__ import annotations

import copy
import re

import numpy as np
from scipy.spatial.distance import jensenshannon
from scipy.stats import hmean, ks_2samp

from multimodal_unlearning_tpu_torch.evaluation.evaluator import eval_rouge_recall

__all__ = ["FILE_TO_TASK", "METRIC_NAMES", "TOFU_TASK_DICT", "evaluate_forget_quality",
           "compute_model_utility", "forget_quality_table_variant", "get_model_utility",
           "nlp_get_model_utility", "get_forget_quality", "merge_dicts", "get_total_len",
           "interleave", "interleave_eval_result_dict"]


def _vals(d: dict):
    return np.array(list(d.values()))


# ---------------------------------------------------------------------------
# mm flavor
# ---------------------------------------------------------------------------

FILE_TO_TASK = {
    "eval_real_faces_wo_options.json": "Real Faces",
    "eval_real_world_wo_options.json": "Real World",
    "eval_log.json": "Retain",
    "eval_retain_facerec.json": "Retain FaceRec",
    "eval_log_forget.json": "Forget",
    "eval_forget_facerec.json": "Forget FaceRec",
}

METRIC_NAMES = ("ROUGE", "Prob.", "Truth Ratio")


def evaluate_forget_quality(unlearned_data: dict, retained_data: dict) -> dict:
    """KS two-sample p-value and Jensen-Shannon distance between the truth
    ratios of the forget task; the perturbed loss is ONE scalar, the mean
    over every row and every perturbed answer, as the reference's mm
    calculator takes it."""
    u = unlearned_data["eval_log_forget.json"]
    r = retained_data["eval_log_forget.json"]
    u_tr = np.exp(_vals(u["average_perturb_loss"]).mean() - _vals(u["avg_paraphrased_loss"]))
    r_tr = np.exp(_vals(r["average_perturb_loss"]).mean() - _vals(r["avg_paraphrased_loss"]))
    return {
        "KS test p-value": ks_2samp(u_tr, r_tr).pvalue,
        "JS metric": jensenshannon(u_tr, r_tr),
    }


def compute_model_utility(eval_results: dict) -> dict:
    """Per task: the answer's normalized probability, ROUGE-L recall and the
    truth-ratio score; then the harmonic mean of every entry whose name
    lacks "Forget".  A log without ROUGE scores gets them from its
    ``generated_text`` triples (this updates ``eval_results``)."""
    agg = {}
    for task_file, res in eval_results.items():
        task = FILE_TO_TASK[task_file]

        true_probs = np.exp(-_vals(res["avg_gt_loss"]))
        if "eval_log" in task_file:
            avg_gt_prob = np.mean(true_probs)
        else:
            false_probs = np.exp(-_vals(res["average_perturb_loss"]))
            combined = np.concatenate(
                [np.expand_dims(true_probs, -1), false_probs], axis=1).sum(-1)
            avg_gt_prob = np.mean(true_probs / combined)
        agg[f"Prob. {task}"] = avg_gt_prob

        if len(res.get("rougeL_recall", [])) == 0:
            res.update(eval_rouge_recall(
                [g for _, g, _ in res["generated_text"].values()],
                [a for _, _, a in res["generated_text"].values()],
                list(res["generated_text"].keys())))
        agg[f"ROUGE {task}"] = _vals(res["rougeL_recall"]).mean()

        tr = np.exp(_vals(res["average_perturb_loss"]).mean() - _vals(res["avg_paraphrased_loss"]))
        if "forget" in task_file:
            agg[f"Truth Ratio {task}"] = np.mean(np.minimum(tr, 1 / tr))
        else:
            agg[f"Truth Ratio {task}"] = np.mean(np.maximum(0, 1 - 1 / tr))

    agg["Model Utility"] = hmean([v for k, v in agg.items() if "Forget" not in k])
    return agg


def forget_quality_table_variant(unlearned_data: dict, retained_data: dict) -> float:
    """1 - JS, the tables' forget quality."""
    return 1.0 - evaluate_forget_quality(unlearned_data, retained_data)["JS metric"]


# ---------------------------------------------------------------------------
# TOFU flavor (the nlp stack)
# ---------------------------------------------------------------------------

TOFU_TASK_DICT = {
    "eval_real_author_wo_options.json": "Real Authors",
    "eval_real_world_wo_options.json": "Real World",
    "eval_log.json": "Retain",
    "eval_log_forget.json": "Forget",
}


def _gt_prob(k: str, res: dict):
    true_p = np.exp(-_vals(res["avg_gt_loss"]))
    if "eval_log" in k:
        return np.mean(true_p)
    false_p = np.exp(-_vals(res["average_perturb_loss"]))
    all_p = np.concatenate([np.expand_dims(true_p, -1), false_p], axis=1).sum(-1)
    return np.mean(true_p / all_p)


def get_model_utility(eval_result_dict: dict) -> dict:
    """TOFU's shared Model Utility: per-sample truth ratios, the mean of the
    perturbed answers' probabilities over the paraphrase's."""
    output = {}
    for k, res in eval_result_dict.items():
        task = TOFU_TASK_DICT[k]
        output[f"{task} Probability"] = _gt_prob(k, res)
        output[f"{task} ROUGE"] = _vals(res["rougeL_recall"]).mean()
        idxs = list(res["avg_paraphrased_loss"].keys())
        para = np.exp(-np.array([res["avg_paraphrased_loss"][i] for i in idxs]))
        pert = np.exp(-np.array([res["average_perturb_loss"][i] for i in idxs])).mean(-1)
        stat = pert / para
        if "forget" in k:
            output[f"{task} Truth Ratio"] = np.mean(np.minimum(stat, 1 / stat))
        else:
            output[f"{task} Truth Ratio"] = np.mean(np.maximum(0, 1 - stat))
    output["Model Utility"] = hmean([v for k, v in output.items() if "Forget" not in k])
    return output


def nlp_get_model_utility(eval_result_dict: dict) -> dict:
    """The nlp aggregator CLI's own Model Utility: keys "Prob. {task}",
    "ROUGE {task}", "Truth Ratio {task}"; the truth ratio is exp(mean
    perturbed loss - paraphrase loss) per sample, clamped as max(0, 1 -
    1/stat) off the forget task.  The keys come in the reference's
    init-then-overwrite order (ROUGE, Prob., Truth Ratio per task, then Model
    Utility), so CSV columns match."""
    output = {}
    for k in TOFU_TASK_DICT:
        for m in METRIC_NAMES:
            output[m + " " + TOFU_TASK_DICT[k]] = []
    for k, res in eval_result_dict.items():
        task = TOFU_TASK_DICT[k]
        output[f"Prob. {task}"] = _gt_prob(k, res)
        output[f"ROUGE {task}"] = _vals(res["rougeL_recall"]).mean()
        stat = np.exp(_vals(res["average_perturb_loss"]).mean(-1)
                      - _vals(res["avg_paraphrased_loss"]))
        if "forget" in k:
            output[f"Truth Ratio {task}"] = np.mean(np.minimum(stat, 1 / stat))
        else:
            output[f"Truth Ratio {task}"] = np.mean(np.maximum(0, 1 - 1 / stat))
    output["Model Utility"] = hmean([v for k, v in output.items() if "Forget" not in k])
    return output


def get_forget_quality(unlearn_result: dict, retain_result: dict) -> dict:
    """TOFU's Forget Quality: KS test on per-sample truth ratios (the mean
    over each sample's perturbed answers)."""
    u = unlearn_result["eval_log_forget.json"]
    r = retain_result["eval_log_forget.json"]
    u_tr = np.exp(_vals(u["average_perturb_loss"]).mean(axis=-1) - _vals(u["avg_paraphrased_loss"]))
    r_tr = np.exp(_vals(r["average_perturb_loss"]).mean(axis=-1) - _vals(r["avg_paraphrased_loss"]))
    res = ks_2samp(u_tr, r_tr)
    return {"Forget Quality": res.pvalue, "KS Test PVal Forget": res.pvalue,
            "KS Test Forget": res.statistic}


# ---------------------------------------------------------------------------
# Multi-process interleave repair
# ---------------------------------------------------------------------------


def _natsorted(keys):
    """Natural-order sort of keys (digit runs compare as numbers)."""
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(s))]

    return sorted(keys, key=key)


def merge_dicts(a: dict, b: dict) -> dict:
    """Recursive merge of ``b`` into a copy of ``a``: nested dicts merge,
    two lists under one key keep ``a``'s, anything else takes ``b``'s; keys
    in natural order."""
    out = copy.deepcopy(a)
    for key, value in b.items():
        if key in out:
            if isinstance(out[key], dict) and isinstance(value, dict):
                out[key] = merge_dicts(out[key], value)
            elif isinstance(out[key], list) and isinstance(value, list):
                pass  # duplicate lists: keep one
            else:
                out[key] = value
        else:
            out[key] = value
    return {k: out[k] for k in _natsorted(out)}


def get_total_len(name: str, forget_rate: str) -> int:
    if name == "eval_real_author_wo_options.json":
        return 100
    if name == "eval_real_world_wo_options.json":
        return 117
    if name == "eval_log.json":
        return 300
    if forget_rate == "forget01":
        return 40
    if forget_rate == "forget05":
        return 200
    return 300


def interleave(a: list, b: list, size: int) -> list:
    assert len(a) == len(b) and size > 0
    c = []
    for i in range(0, len(a), size):
        c.extend(a[i: i + size])
        c.extend(b[i: i + size])
    return c


def interleave_eval_result_dict(eval_result_dict, forget_rate, large_bsz, num_processes=2):
    """Rebuild the sample order of logs written by exactly two processes
    (halve each list and interleave the halves in loader-batch blocks); any
    other process count raises rather than mis-assemble the order."""
    if num_processes != 2:
        raise ValueError(
            f"interleave_eval_result_dict repairs exactly 2-process shards, got {num_processes}; "
            "merge per-rank eval logs by their saved indices instead")
    small_bsz = large_bsz // 4
    for k, v in eval_result_dict.items():
        for metric, value in v.items():
            bsz = small_bsz if "perturb" in metric or "paraphrase" in metric else large_bsz
            total_len = get_total_len(k, forget_rate)
            a = value[0: len(value) // 2]
            b = value[len(value) // 2:]
            eval_result_dict[k][metric] = interleave(a, b, bsz)[:total_len]
    return eval_result_dict
