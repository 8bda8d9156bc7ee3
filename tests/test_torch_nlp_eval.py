"""The text stack's evaluator (``evaluation/evaluator.py``'s nlp half)
against the JAX package's (CPU, f32): the split symbol and the prompt /
ground-truth recovery on llama-style tags (an empty answer tag: split at the
question's end tag and re-append it) and phi-style tags (split at the answer
tag), a row without the symbol falling back to its dataset answer; then
``nlp_get_all_evals`` on a 2-layer llama with the same weights and rows, the
same deterministic ``generate_fn`` on both sides (generation itself is held
against JAX in ``tests/test_torch_nlp_cli_eval.py``), for a retain-style task (no
normalized loss) and a forget-style one.

Tolerances: every number 1e-4 relative, every text equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_unlearning_tpu.cli import common as jcommon
from multimodal_unlearning_tpu.config import registry as jregistry
from multimodal_unlearning_tpu.data import loader as jloader
from multimodal_unlearning_tpu.data import nlp as jnlp
from multimodal_unlearning_tpu.data.tokenizer import ByteTokenizer as JTok
from multimodal_unlearning_tpu.evaluation import evaluator as jev
from multimodal_unlearning_tpu.models import llama as jllama
from multimodal_unlearning_tpu_torch.cli import common as tcommon
from multimodal_unlearning_tpu_torch.config import registry as tregistry
from multimodal_unlearning_tpu_torch.data import DataLoader
from multimodal_unlearning_tpu_torch.data import nlp as tnlp
from multimodal_unlearning_tpu_torch.data.tokenizer import ByteTokenizer as TTok
from multimodal_unlearning_tpu_torch.evaluation import evaluator as tev

LLAMA_TAGS = {"question_start_tag": "[INST] ", "question_end_tag": " [/INST]", "answer_tag": ""}
PHI_TAGS = {"question_start_tag": "Question: ", "question_end_tag": "\n", "answer_tag": "Answer: "}
DATA = "synthetic:n_persons=20"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tags", [LLAMA_TAGS, PHI_TAGS, {}], ids=["llama", "phi", "no_tags"])
def test_split_rule_matches_jax(tags):
    assert tev.nlp_split_symbol(tags) == jev.nlp_split_symbol(tags)
    symbol, reappend = tev.nlp_split_symbol(tags)
    q = tags.get("question_start_tag", "") + "Who is Person003?" + tags.get("question_end_tag", "")
    dec = [q + tags.get("answer_tag", "") + "Person003 enjoys activity 2.",
           "a row without the symbol",
           q + tags.get("answer_tag", "") + "two parts" + (symbol or "") + "and more"]
    answers = ["ans 0", "the fallback answer", "ans 2"]
    prompts, truths = tev._nlp_split_questions(dec, answers, symbol, reappend)
    assert (prompts, truths) == jev._nlp_split_questions(dec, answers, symbol, reappend)
    if symbol:
        assert truths[:2] == ["Person003 enjoys activity 2.", "the fallback answer"]
        assert prompts[0].endswith(symbol) == reappend and prompts[1] == dec[1]


def _generate(q_texts, ref_texts=None):
    """A deterministic stand-in for generation: the same on both sides."""
    return [q[-14:][::-1] + " " + (r or "")[:9] for q, r in zip(q_texts, ref_texts)]


def _loaders(nlp, tok, loader_cls, tags, split):
    def mk(answer_key, bs):
        ds = nlp.TextDatasetQA(DATA, tok, tags, max_length=96, split=split, answer_key=answer_key)
        ds.rows_ = ds.rows_[:6]
        return loader_cls(ds, bs, nlp.eval_collator, drop_last=False)

    return mk("answer", 4), mk("paraphrased_answer", 2), mk("perturbed_answer", 2)


def _close(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, str):
        assert a == b, where
    else:
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=where)


@pytest.mark.parametrize("task,split,tags", [
    ("eval_log", "retain_perturbed", LLAMA_TAGS),
    ("eval_log_forget", "forget10_perturbed", PHI_TAGS),
    ("eval_real_author_wo_options", "real_authors_perturbed", LLAMA_TAGS)])
def test_nlp_get_all_evals_matches_jax(task, split, tags):
    model_cfg = tregistry.get_model_identifiers("tiny-llama-test")
    _, _, model = tcommon.init_or_load_params(model_cfg, None, seed=1, device="cpu",
                                              dtype=torch.float32)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcommon.model_tree(model))
    jmcfg = jcommon.build_model_config(jregistry.get_model_identifiers("tiny-llama-test"))

    @jax.jit
    def jlogits(ids, mask):
        return jllama.forward(jparams, jmcfg, ids, attention_mask=mask,
                              compute_dtype=jnp.float32)["logits"]

    def japply(batch):
        return {"logits": jlogits(jnp.asarray(batch["input_ids"]),
                                  jnp.asarray(batch["attention_mask"]))}

    def tapply(batch):
        with torch.inference_mode():
            return {"logits": model(torch.from_numpy(np.asarray(batch["input_ids"])).long(),
                                    attention_mask=torch.from_numpy(
                                        np.asarray(batch["attention_mask"])),
                                    compute_dtype=torch.float32)["logits"]}

    want = jev.nlp_get_all_evals(task, *_loaders(jnlp, JTok(), jloader.DataLoader, tags, split),
                                 apply_fn=japply, generate_fn=_generate, tok=JTok(), tags=tags)
    got = tev.nlp_get_all_evals(task, *_loaders(tnlp, TTok(), DataLoader, tags, split),
                                apply_fn=tapply, generate_fn=_generate, tok=TTok(), tags=tags)
    # as the CLIs write them: JSON
    got, want = (json.loads(json.dumps(x, default=float)) for x in (got, want))
    assert ("normalized_gt_loss" in got) == ("eval_log" not in task)
    assert len(got["avg_gt_loss"]) == 6
    _close(got, want)
