"""The port's ROUGE and metrics against the packages the JAX side uses.

- ``evaluation/rouge.PorterStemmer`` equals NLTK's ``PorterStemmer()`` word
  for word on a fixed corpus (the refusal answers, the synthetic CLEAR
  rows, NLTK's irregular forms, the words of NLTK's own doctests) and on
  hypothesis-drawn lowercase strings;
- ``evaluator.eval_rouge_recall`` equals the JAX package's
  (``rouge_score``) exactly on texts that mix words, digits, punctuation
  and non-ASCII characters;
- every function of ``evaluation/metrics.py`` equals the JAX package's to
  1e-12 relative on random logs.
"""

import copy
import re
from pathlib import Path

import nltk
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from nltk.stem.porter import PorterStemmer as NltkPorter

from multimodal_unlearning_tpu.evaluation import evaluator as jevaluator
from multimodal_unlearning_tpu.evaluation import metrics as jmetrics
from multimodal_unlearning_tpu_torch.data import SyntheticClearData
from multimodal_unlearning_tpu_torch.data.datasets import load_idk_answers
from multimodal_unlearning_tpu_torch.evaluation import evaluator as tevaluator
from multimodal_unlearning_tpu_torch.evaluation import metrics as tmetrics
from multimodal_unlearning_tpu_torch.evaluation.rouge import PorterStemmer

NLTK = NltkPorter()
PORT = PorterStemmer()


def _synthetic_texts():
    data = SyntheticClearData(n_persons=12, qa_per_person=4)
    out = []
    for kind in ("image_caption", "text"):
        for row in data.rows(kind):
            for v in row.values():
                out.extend([v] if isinstance(v, str) else
                           [x for x in v if isinstance(x, str)] if isinstance(v, list) else [])
    return out


def _corpus():
    texts = load_idk_answers() + _synthetic_texts()
    texts += list(NLTK.pool) + list(NLTK.pool.values())
    for doc in sorted(Path(nltk.__file__).parent.joinpath("test").glob("*.doctest")):
        texts.append(doc.read_text(errors="ignore"))
    words = set()
    for t in texts:
        words.update(re.findall(r"[A-Za-z0-9]+", t))
    return sorted(words)


def test_stemmer_equals_nltk_on_the_corpus():
    words = _corpus()
    assert len(words) > 5000
    bad = [(w, PORT.stem(w), NLTK.stem(w)) for w in words if PORT.stem(w) != NLTK.stem(w)]
    assert not bad, bad[:20]


@settings(max_examples=2000, deadline=None)
@given(st.text(alphabet="abcdefghijklmnopqrstuvwxyz", min_size=1, max_size=16))
def test_stemmer_equals_nltk_on_drawn_words(word):
    assert PORT.stem(word) == NLTK.stem(word)


@settings(max_examples=600, deadline=None)
@given(st.text(alphabet="eiyslnbtdgaoucmz", min_size=3, max_size=14))
def test_stemmer_equals_nltk_on_suffix_heavy_words(word):
    # letters of the rules' suffixes, so that most steps fire
    assert PORT.stem(word) == NLTK.stem(word)


def _texts(rng, n):
    words = _corpus()
    extra = ["3.14", "Person007", "naïve", "café", "—", "日本", "\x10\x02", "!!", "l33t", "  ",
             "", "a", "it's", "U.S.A.", "re-run"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 14))
        toks = [words[int(i)] if rng.random() < 0.7 else extra[int(rng.integers(len(extra)))]
                for i in rng.integers(0, len(words), k)]
        out.append((" " if rng.random() < 0.5 else ", ").join(toks))
    return out


def test_rouge_recall_equals_rouge_score():
    rng = np.random.default_rng(0)
    gens, gts = _texts(rng, 400), _texts(rng, 400)
    # shared words, so that recall is not always 0
    gens = [g + " " + t.split(" ")[0] if i % 2 else g for i, (g, t) in enumerate(zip(gens, gts))]
    idx = list(range(400))
    want = jevaluator.eval_rouge_recall(gens, gts, idx)
    got = tevaluator.eval_rouge_recall(gens, gts, idx)
    assert got == want
    assert {type(v) for v in got["rougeL_recall"].values()} == {
        type(v) for v in want["rougeL_recall"].values()}
    assert 0 < np.mean(list(got["rouge1_recall"].values())) < 1


def _task_log(rng, n, with_rouge, offset=0):
    idx = [str(offset + 3 * i) for i in range(n)]
    log = {
        "avg_gt_loss": {i: float(rng.uniform(0.1, 4)) for i in idx},
        "avg_paraphrased_loss": {i: float(rng.uniform(0.1, 4)) for i in idx},
        "average_perturb_loss": {i: rng.uniform(0.1, 4, 3).tolist() for i in idx},
        "generated_text": {i: ["q", f"Person{int(rng.integers(10)):03d} wears outfit",
                               f"Person{int(rng.integers(10)):03d} wearing outfits"]
                           for i in idx},
    }
    if with_rouge:
        log["rougeL_recall"] = {i: float(rng.uniform()) for i in idx}
    return log


def _mm_logs(seed):
    rng = np.random.default_rng(seed)
    return {name: _task_log(rng, 9, with_rouge=j % 2 == 0)
            for j, name in enumerate(tmetrics.FILE_TO_TASK)}


def _tofu_logs(seed):
    rng = np.random.default_rng(seed)
    return {name: _task_log(rng, 7, with_rouge=True) for name in tmetrics.TOFU_TASK_DICT}


def _close(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mm_metrics_equal_jax(seed):
    u, r = _mm_logs(seed), _mm_logs(seed + 10)
    ju, tu = copy.deepcopy(u), copy.deepcopy(u)
    _close(tmetrics.compute_model_utility(tu), jmetrics.compute_model_utility(ju))
    assert tu == ju  # both filled in the missing ROUGE the same way
    _close(tmetrics.evaluate_forget_quality(u, r), jmetrics.evaluate_forget_quality(u, r))
    np.testing.assert_allclose(tmetrics.forget_quality_table_variant(u, r),
                               jmetrics.forget_quality_table_variant(u, r), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_tofu_metrics_equal_jax(seed):
    u, r = _tofu_logs(seed), _tofu_logs(seed + 10)
    _close(tmetrics.get_model_utility(u), jmetrics.get_model_utility(u))
    _close(tmetrics.nlp_get_model_utility(u), jmetrics.nlp_get_model_utility(u))
    _close(tmetrics.get_forget_quality(u, r), jmetrics.get_forget_quality(u, r))


def test_merge_and_interleave_equal_jax():
    rng = np.random.default_rng(4)
    a = {"k10": {"x2": 1, "x10": [1, 2]}, "k2": [3], "k1": 5}
    b = {"k10": {"x1": 7, "x10": [9]}, "k2": [4], "k3": {"z": 1}, "k1": 6}
    assert tmetrics.merge_dicts(a, b) == jmetrics.merge_dicts(a, b)
    assert list(tmetrics.merge_dicts(a, b)) == list(jmetrics.merge_dicts(a, b))
    for name in ("eval_real_author_wo_options.json", "eval_log.json", "eval_log_forget.json"):
        for rate in ("forget01", "forget05", "forget10"):
            assert tmetrics.get_total_len(name, rate) == jmetrics.get_total_len(name, rate)
    x, y = rng.integers(0, 9, 12).tolist(), rng.integers(0, 9, 12).tolist()
    assert tmetrics.interleave(x, y, 5) == jmetrics.interleave(x, y, 5)
    logs = {"eval_log_forget.json": {"avg_gt_loss": rng.uniform(size=40).tolist(),
                                     "perturb_loss": rng.uniform(size=40).tolist()}}
    want = jmetrics.interleave_eval_result_dict(copy.deepcopy(logs), "forget01", 8)
    assert tmetrics.interleave_eval_result_dict(copy.deepcopy(logs), "forget01", 8) == want
    with pytest.raises(ValueError, match="exactly 2-process"):
        tmetrics.interleave_eval_result_dict(copy.deepcopy(logs), "forget01", 8, num_processes=3)
