"""ECO classifiers: the port's copy of
``multimodal_unlearning_tpu/methods/eco/classifier.py`` (reference:
methods/eco/classifier.py:29-104).  Plain Python on the host: the corpus
detectors need no package, and the two ``transformers`` pipeline backends
import it lazily and run on the host CPU (``device=-1``), as there.

Two detector roles:
- PromptClassifier — is this prompt about the forget set? (threshold gate)
- TokenClassifier  — which tokens name the entity? (labels in the target
  tokenizer's space)

The reference drives both through HF ``pipeline`` models pulled from the hub.
Zero-egress pods get two backends:
- ``HFPipelineBackend``   — wraps local ``transformers`` pipeline checkpoints;
- ``CorpusBackend``       — hub-free detector built from the forget corpus
  itself: prompt score = max token-overlap with forget questions/entities;
  token labels = tokens belonging to a known entity string.  This keeps the
  full ECO path runnable (and testable) without downloads.
"""

from __future__ import annotations

import re


def _token_set(s: str) -> set[str]:
    return set(re.findall(r"[a-z0-9]+", s.lower()))


class CorpusPromptClassifier:
    def __init__(self, forget_prompts: list[str], entities: list[str] | None = None):
        self.prompt_tokens = [_token_set(p) for p in forget_prompts]
        self.entities = [e.lower() for e in (entities or [])]

    def score(self, prompt: str) -> float:
        toks = _token_set(prompt)
        if any(e in prompt.lower() for e in self.entities):
            return 1.0
        if not toks:
            return 0.0
        best = 0.0
        for ft in self.prompt_tokens:
            if not ft:
                continue
            best = max(best, len(toks & ft) / len(toks | ft))
        return best

    def predict(self, prompts: list[str], threshold: float = 0.5) -> list[int]:
        return [1 if self.score(p) > threshold else 0 for p in prompts]


def spans_to_target_labels(prompts: list[str], spans_list: list[list[tuple]], target_tokenizer) -> list[list[int]]:
    """Map character spans onto the *target* tokenizer's token space
    (the reference's offset-matching retokenization, classifier.py:62-104):
    a target token is flagged iff its character span overlaps any entity
    span.  Left-pads rows to a common length (left-padded prompts)."""
    out = []
    for p, spans in zip(prompts, spans_list):
        ids = target_tokenizer.encode(p, add_special_tokens=True)
        labels = []
        consumed = 0
        for tid in ids:
            piece = target_tokenizer.decode([tid], skip_special_tokens=True)
            s, epos = consumed, consumed + len(piece)
            hit = any(not (epos <= a or s >= b) for a, b in spans) and piece.strip() != ""
            labels.append(1 if hit else 0)
            consumed = epos
        # safety fallback (classifier.py:92-99): all-zero → label all but last
        if all(l == 0 for l in labels) and labels:
            labels = [1] * (len(labels) - 1) + [0]
        out.append(labels)
    L = max(len(l) for l in out)
    return [[0] * (L - len(l)) + l for l in out]


def _entity_spans(text: str, entities: list[str]) -> list[tuple]:
    low = text.lower()
    spans = []
    for e in entities:
        start = 0
        while True:
            j = low.find(e, start)
            if j == -1:
                break
            spans.append((j, j + len(e)))
            start = j + 1
    return spans


class CorpusTokenClassifier:
    """Entity-token labeling by substring match, mapped into the target
    tokenizer's space via greedy decode-and-match (offset-mapping analog:
    methods/eco/classifier.py:62-104)."""

    def __init__(self, entities: list[str]):
        self.entities = [e.lower() for e in entities]

    def predict_target_token_labels(self, prompts: list[str], target_tokenizer) -> list[list[int]]:
        spans_list = [_entity_spans(p, self.entities) for p in prompts]
        return spans_to_target_labels(prompts, spans_list, target_tokenizer)


class HFPipelineBackend:
    """Local-checkpoint HF ``pipeline`` prompt classifier — the reference's
    PromptClassifier interface (classifier.py:29-48): flag a prompt iff the
    positive label wins with score above the gate threshold (llama_setup
    uses 0.999, methods/eco/main.py:6-45).  Train one locally with
    ``methods/eco/train_classifiers.py``."""

    def __init__(self, model_path: str, task: str = "text-classification", batch_size: int = 16):
        from transformers import pipeline

        self.model = pipeline(task, model=model_path, batch_size=batch_size, device=-1)

    def predict_prompts(self, prompts, threshold=0.5):
        preds = self.model(list(prompts), truncation=True, max_length=512, padding="longest")
        return [1 if p["label"] == "LABEL_1" and p["score"] > threshold else 0 for p in preds]

    # AttackedModel prompt-classifier interface
    predict = predict_prompts

    def score(self, prompt: str) -> float:
        p = self.model([prompt], truncation=True, max_length=512)[0]
        return p["score"] if p["label"] == "LABEL_1" else 1.0 - p["score"]


class HFTokenPipelineBackend:
    """Local-checkpoint HF token-classification (NER analog) backend —
    the reference's TokenClassifier (classifier.py:51-104): run the tagger,
    take character spans of entity-labeled tokens, and retokenize them into
    the target tokenizer's space via offset matching."""

    def __init__(self, model_path: str, batch_size: int = 16, positive_labels=("ENT", "LABEL_1")):
        from transformers import pipeline

        self.model = pipeline(
            "token-classification", model=model_path, batch_size=batch_size, device=-1
        )
        self.positive = set(positive_labels)

    def _spans(self, prompts: list[str]) -> list[list[tuple]]:
        preds = self.model(list(prompts))
        if preds and isinstance(preds[0], dict):  # single-prompt shape
            preds = [preds]
        out = []
        for row in preds:
            out.append([
                (p["start"], p["end"]) for p in row
                if p.get("entity", p.get("entity_group")) in self.positive
            ])
        return out

    def predict_target_token_labels(self, prompts: list[str], target_tokenizer) -> list[list[int]]:
        return spans_to_target_labels(prompts, self._spans(prompts), target_tokenizer)
