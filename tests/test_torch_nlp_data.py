"""The port's text-stack data (``data/nlp.py``) against the JAX package's
(CPU): the split algebra of the synthetic text rows, the model format
(padding, the one supervised EOS, the masked question, truncation), the
forget datasets by loss (forget, idk and eco_ft pairs, DPO triplets), the
multi-answer evaluation rows, and the collators.  Everything is compared
exactly: the same ``ByteTokenizer`` text and the same ``random.Random``
stream on both sides."""

import json

import numpy as np
import pytest

from multimodal_unlearning_tpu.data import nlp as jnlp
from multimodal_unlearning_tpu.data.tokenizer import ByteTokenizer as JTok
from multimodal_unlearning_tpu_torch.data import nlp as tnlp
from multimodal_unlearning_tpu_torch.data.tokenizer import ByteTokenizer as TTok

DATA = "synthetic:n_persons=10,qa_per_person=4"
LLAMA_TAGS = {"question_start_tag": "[INST] ", "question_end_tag": " [/INST]", "answer_tag": ""}
PHI_TAGS = {"question_start_tag": "Question: ", "question_end_tag": "\n", "answer_tag": "Answer: "}


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("split", ["full", "forget10", "forget05_perturbed", "retain90",
                                   "retain_perturbed", "real_authors_perturbed",
                                   "world_facts_perturbed", "forget10_perturbed"])
def test_text_rows_equal_jax(split):
    _same(tnlp.resolve_text_rows(DATA, split), jnlp.resolve_text_rows(DATA, split))


@pytest.mark.parametrize("tags", [LLAMA_TAGS, PHI_TAGS], ids=["llama", "phi"])
@pytest.mark.parametrize("max_length", [24, 40, 64], ids=["truncated", "exact", "padded"])
def test_model_format_equal_jax(tags, max_length):
    question, answer = "What is fact 3 about Person007?", "Person007 enjoys activity number 3."
    got = tnlp.convert_raw_to_model_format(TTok(), max_length, question, answer, tags)
    want = jnlp.convert_raw_to_model_format(JTok(), max_length, question, answer, tags)
    _same(got, want)
    ids, labels, attn = got
    n = int(attn.sum())
    if n < max_length:  # exactly one supervised EOS, after the last real token
        assert labels[n] == TTok().eos_token_id and (labels[n + 1:] == -100).all()
        assert (ids[n:] == TTok().eos_token_id).all()


@pytest.mark.parametrize("loss", ["grad_ascent", "idk", "rmu", "grad_proj"])
def test_forget_pairs_equal_jax(loss):
    kw = dict(max_length=64, split="forget10", loss_type=loss, seed=3)
    t = tnlp.TextForgetDatasetQA(DATA, TTok(), LLAMA_TAGS, **kw)
    j = jnlp.TextForgetDatasetQA(DATA, JTok(), LLAMA_TAGS, **kw)
    assert len(t) == len(j) == 4
    # the pairing stream advances item by item: draw in the same order
    _same([t[i] for i in (0, 1, 2, 3, 1, 0)], [j[i] for i in (0, 1, 2, 3, 1, 0)])


def test_eco_prompts_from_jsonl_equal_jax(tmp_path):
    path = tmp_path / "eco_prompts.jsonl"
    path.write_text("".join(json.dumps({"question": f"Corrupted question {i}?",
                                        "answer": f"Answer {i}."}) + "\n" for i in range(3)))
    kw = dict(max_length=48, split="forget10", loss_type="eco_ft", seed=1)
    for p in (tmp_path, path):  # a directory holding the file, or the file
        t = tnlp.TextForgetDatasetQA(DATA, TTok(), PHI_TAGS, eco_prompts_path=str(p), **kw)
        j = jnlp.TextForgetDatasetQA(DATA, JTok(), PHI_TAGS, eco_prompts_path=str(p), **kw)
        assert len(t) == 3
        _same([t[i] for i in range(3)], [j[i] for i in range(3)])


def test_eco_prompts_from_a_datasets_dir_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="datasets"):
        tnlp.TextForgetDatasetQA(DATA, TTok(), LLAMA_TAGS, loss_type="eco_ft",
                                 eco_prompts_path=str(tmp_path))


@pytest.mark.parametrize("seed", [0, 42])
def test_dpo_triplets_equal_jax(seed):
    t = tnlp.TextForgetDatasetDPOQA(DATA, TTok(), LLAMA_TAGS, max_length=64, seed=seed)
    j = jnlp.TextForgetDatasetDPOQA(DATA, JTok(), LLAMA_TAGS, max_length=64, seed=seed)
    items = [t[i] for i in (3, 0, 2)]
    _same(items, [j[i] for i in (3, 0, 2)])
    assert list(items[0]) == ["idk", "forget", "retain"]


@pytest.mark.parametrize("answer_key", ["answer", "paraphrased_answer", "perturbed_answer"])
def test_eval_rows_and_collators_equal_jax(answer_key):
    kw = dict(max_length=56, split="forget10_perturbed", answer_key=answer_key)
    t = tnlp.TextDatasetQA(DATA, TTok(), LLAMA_TAGS, **kw)
    j = jnlp.TextDatasetQA(DATA, JTok(), LLAMA_TAGS, **kw)
    ts, js = [t[i] for i in range(len(t))], [j[i] for i in range(len(j))]
    _same(ts, js)
    if answer_key == "perturbed_answer":  # three answers a row, stacked
        assert ts[0]["input_ids"].shape == (3, 56)
    _same(tnlp.eval_collator(ts), jnlp.eval_collator(js))


@pytest.mark.parametrize("loss", ["idk", "dpo"])
def test_text_collator_equal_jax(loss):
    if loss == "dpo":
        t = tnlp.TextForgetDatasetDPOQA(DATA, TTok(), PHI_TAGS, max_length=40, seed=5)
        j = jnlp.TextForgetDatasetDPOQA(DATA, JTok(), PHI_TAGS, max_length=40, seed=5)
    else:
        t = tnlp.TextForgetDatasetQA(DATA, TTok(), PHI_TAGS, max_length=40, loss_type=loss, seed=5)
        j = jnlp.TextForgetDatasetQA(DATA, JTok(), PHI_TAGS, max_length=40, loss_type=loss, seed=5)
    _same(tnlp.text_collator([t[i] for i in range(4)]), jnlp.text_collator([j[i] for i in range(4)]))
