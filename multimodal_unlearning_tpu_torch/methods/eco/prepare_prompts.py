"""Generate ECO-corrupted answers over the forget split -> the ``eco_ft``
dataset: the port's counterpart of
``multimodal_unlearning_tpu/methods/eco/prepare_prompts.py`` (reference:
methods/eco/prepare_eco_prompts.py:30-49).

The corrupted model answers each forget question; the (question, corrupted
answer) pairs become the ``eco_ft`` training set, ``eco_prompts.jsonl``,
which ``data/nlp.py`` reads for the ``eco_ft`` loss (``cli/nlp_forget.py``).

The token labels come from the tagged prompts the model reads (question
start tag + question + end tag), so that they mark exactly the entity's
tokens of each encoded row; the gate judges the bare question.  (The JAX
package labels the bare question and right-aligns those labels to the
tagged row: they land ``len(question_end_tag + answer_tag)`` tokens to the
right of the entity.)
"""

from __future__ import annotations

import json
from pathlib import Path

from multimodal_unlearning_tpu_torch.data.nlp import resolve_text_rows
from multimodal_unlearning_tpu_torch.evaluation.generate import pad_prompts

__all__ = ["prepare_eco_prompts", "tagged_prompts"]


def tagged_prompts(questions: list[str], tags: dict) -> list[str]:
    """The text the model reads for each question."""
    return [tags["question_start_tag"] + q + tags["question_end_tag"] + tags.get("answer_tag", "")
            for q in questions]


def prepare_eco_prompts(attacked_model, tokenizer, tags: dict, data_path: str, split: str,
                        out_dir: str, *, max_new_tokens: int = 32, batch_size: int = 8):
    rows = resolve_text_rows(data_path, split)
    out_rows = []
    for i in range(0, len(rows), batch_size):
        chunk = rows[i:i + batch_size]
        questions = [r["question"] for r in chunk]
        prompts = tagged_prompts(questions, tags)
        enc = [tokenizer.encode(p, add_special_tokens=True) for p in prompts]
        ids, mask = pad_prompts(enc, tokenizer.pad_token_id)
        gen = attacked_model.generate(ids, mask, max_new_tokens=max_new_tokens, prompts=prompts,
                                      gate_prompts=questions)
        for r, g in zip(chunk, gen):
            out_rows.append({"question": r["question"],
                             "answer": tokenizer.decode(g, skip_special_tokens=True)})
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    with open(p / "eco_prompts.jsonl", "w") as f:
        for r in out_rows:
            f.write(json.dumps(r) + "\n")
    return out_rows
