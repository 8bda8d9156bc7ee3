"""Text-only (TOFU-style) datasets and collators: the port's copy of
``multimodal_unlearning_tpu/data/nlp.py``.

Rules kept from the JAX package, which mirrors the reference's text stack:
- a fixed ``max_length``, right-padded with EOS tokens, attention 0 on the
  padding;
- labels: the ids themselves when truncated, else the ids, one EOS and
  -100s: exactly one EOS is supervised;
- the question's tokens (its tag-formatted token count) masked -100;
- forget pairs with a random retain partner (``idx + randint`` from one
  ``random.Random(seed)`` stream, idk answers drawn from the same stream), so
  that both packages pair the same rows;
- DPO triplets idk / forget / retain;
- ``TextDatasetQA`` with several answers (the perturbed lists) stacked.

Rows come from the synthetic generator (``synthetic:n_persons=..``); the
eco_ft prompts from a ``.jsonl`` file.  A local HF-datasets directory needs
the ``datasets`` package, which the port does not use: it raises.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np

from multimodal_unlearning_tpu_torch.data.datasets import (
    SyntheticClearData, load_idk_answers, resolve_rows)


def resolve_text_rows(data_path: str, split: str | None) -> list[dict]:
    """Rows of a text split: the synthetic corpus's text QA rows cut by the
    split's percentage (``forgetNN`` the first NN%, ``retainNN`` the last,
    ``real_authors`` / ``world_facts`` the first quarter), each with its
    ``index`` and the reference's ``perturbed_answer`` list."""
    if data_path.startswith("synthetic"):
        cfg = {}
        if ":" in data_path:
            for kv in data_path.split(":", 1)[1].split(","):
                if "=" in kv:
                    k, v = kv.split("=")
                    cfg[k] = int(v)
        rows = SyntheticClearData(**cfg).rows("text")
        base = (split or "full").replace("_perturbed", "")
        n = len(rows)
        if base.startswith("forget"):
            pct = int("".join(c for c in base if c.isdigit()) or 10)
            rows = rows[: max(1, n * pct // 100)]
        elif base.startswith("retain"):
            pct = int("".join(c for c in base if c.isdigit()) or 90)
            rows = rows[max(1, n * (100 - pct) // 100):]
        elif base in ("real_authors", "world_facts"):
            rows = rows[: max(1, n // 4)]
        out = []
        for i, r in enumerate(rows):
            r = dict(r, index=i)
            r["perturbed_answer"] = r.pop("perturbed_answers", [])
            out.append(r)
        return out
    return resolve_rows(data_path, split)


def convert_raw_to_model_format(tokenizer, max_length: int, question: str, answer: str,
                                tags: dict):
    """(input_ids, labels, attention_mask), int32 arrays of ``max_length``."""
    q = tags["question_start_tag"] + question + tags["question_end_tag"]
    full = q + tags.get("answer_tag", "") + answer
    n_question = len(tokenizer.encode(q, add_special_tokens=True))

    ids = tokenizer.encode(full, add_special_tokens=True)[:max_length]
    pad = max_length - len(ids)
    eos = tokenizer.eos_token_id
    input_ids = np.asarray(ids + [eos] * pad, np.int32)
    attention = np.asarray([1] * len(ids) + [0] * pad, np.int32)
    labels = list(ids) if pad == 0 else ids + [eos] + [-100] * (pad - 1)
    labels = np.asarray(labels, np.int32)
    labels[: min(n_question, max_length)] = -100
    return input_ids, labels, attention


def _retain_split(split: str) -> str:
    """forgetNN -> retain(100 - NN), two digits."""
    return "retain" + str(100 - int(split.replace("forget", "").replace("_perturbed", "")
                                    or 10)).zfill(2)


def _eco_rows(path) -> list[dict]:
    p = Path(path)
    if (p / "eco_prompts.jsonl").exists() or p.suffix == ".jsonl":
        f = p / "eco_prompts.jsonl" if p.is_dir() else p
        with open(f) as fh:
            return [json.loads(line) for line in fh]
    raise NotImplementedError(
        f"eco prompts at {path}: an HF-datasets directory (`datasets.load_from_disk`) needs the "
        "`datasets` package, which the port does not use yet (write them as eco_prompts.jsonl)")


class TextForgetDatasetQA:
    """{forget | idk, retain} pairs per forget row."""

    def __init__(self, data_path, tokenizer, tags, max_length=512, split="forget10",
                 loss_type="idk", eco_prompts_path=None, seed=0):
        self.tokenizer = tokenizer
        self.tags = tags
        self.max_length = max_length
        self.loss_type = loss_type
        if loss_type == "eco_ft" and eco_prompts_path:
            self.forget_rows = _eco_rows(eco_prompts_path)
        else:
            self.forget_rows = resolve_text_rows(data_path, split)
        self.retain_rows = resolve_text_rows(data_path, _retain_split(split))
        self.rng = random.Random(seed)
        if loss_type == "idk":
            self.split1, self.split2 = "idk", "retain"
            self.idk = load_idk_answers()
        else:
            self.split1, self.split2 = "forget", "retain"

    def __len__(self):
        return len(self.forget_rows)

    def __getitem__(self, idx):
        out = {}
        for data_type in (self.split1, self.split2):
            rows = self.retain_rows if data_type == "retain" else self.forget_rows
            i = idx if data_type != "retain" else (
                (idx + self.rng.randint(0, len(self.retain_rows) - 1)) % len(self.retain_rows))
            question = rows[i]["question"]
            answer = (self.idk[self.rng.randint(0, len(self.idk) - 1)].strip()
                      if data_type == "idk" else rows[i]["answer"])
            out["retain" if data_type == "retain" else data_type] = convert_raw_to_model_format(
                self.tokenizer, self.max_length, question, answer, self.tags)
        return out


class TextForgetDatasetDPOQA:
    """{idk, forget, retain} triplets per forget row (DPO, llmu)."""

    def __init__(self, data_path, tokenizer, tags, max_length=512, split="forget10", seed=0):
        self.tokenizer = tokenizer
        self.tags = tags
        self.max_length = max_length
        self.forget_rows = resolve_text_rows(data_path, split)
        self.retain_rows = resolve_text_rows(data_path, _retain_split(split))
        self.idk = load_idk_answers()
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.forget_rows)

    def __getitem__(self, idx):
        out = {}
        for data_type in ("idk", "forget", "retain"):
            rows = self.forget_rows if data_type != "retain" else self.retain_rows
            i = idx if data_type != "retain" else (
                (idx + self.rng.randint(0, len(self.retain_rows) - 1)) % len(self.retain_rows))
            question = rows[i]["question"]
            answer = (self.idk[self.rng.randint(0, len(self.idk) - 1)].strip()
                      if data_type == "idk" else rows[i]["answer"])
            out[data_type] = convert_raw_to_model_format(
                self.tokenizer, self.max_length, question, answer, self.tags)
        return out


class TextDatasetQA:
    """Evaluation rows; a list-valued answer column (the perturbed answers)
    gives one stacked row per answer."""

    def __init__(self, data_path, tokenizer, tags, max_length=512, split=None,
                 question_key="question", answer_key="answer"):
        self.rows_ = resolve_text_rows(data_path, split)
        self.tokenizer = tokenizer
        self.tags = tags
        self.max_length = max_length
        self.qk, self.ak = question_key, answer_key

    def __len__(self):
        return len(self.rows_)

    def __getitem__(self, idx):
        row = self.rows_[idx]
        question = row[self.qk]
        answers = row[self.ak]
        if isinstance(answers, str):
            answers = [answers]
        ids, labels, attn = zip(*(
            convert_raw_to_model_format(self.tokenizer, self.max_length, question, a, self.tags)
            for a in answers))
        stack = (lambda xs: xs[0]) if len(answers) == 1 else np.stack
        return {"input_ids": stack(list(ids)), "labels": stack(list(labels)),
                "attention_mask": stack(list(attn)), "idx": row["index"],
                "question": question, "answer": answers[0]}


def text_collator(samples: list[dict]) -> dict:
    """Per-split (ids, labels, attention) tuples -> a dict of stacked arrays
    per split."""
    out = {}
    for split in samples[0]:
        ids, labels, attn = (np.stack([s[split][j] for s in samples]) for j in range(3))
        out[split] = {"input_ids": ids, "labels": labels, "attention_mask": attn}
    return out


def eval_collator(samples: list[dict], tokenizer=None) -> dict:
    del tokenizer
    return {
        "input_ids": np.stack([s["input_ids"] for s in samples]),
        "labels": np.stack([s["labels"] for s in samples]),
        "attention_mask": np.stack([s["attention_mask"] for s in samples]),
        "indices": np.asarray([s["idx"] for s in samples]),
        "questions": [s["question"] for s in samples],
        "answers_text": [s["answer"] for s in samples],
    }
