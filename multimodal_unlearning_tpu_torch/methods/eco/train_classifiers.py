"""Train ECO's learned detectors locally (no hub access): the port's copy
of ``multimodal_unlearning_tpu/methods/eco/train_classifiers.py``.

The reference drives ECO through two hub-hosted HF pipeline models
(methods/eco/classifier.py:29-104: a forget-prompt text classifier and a
NER token tagger; assembled with zero_out_top_k dims=1000 threshold=.999 in
methods/eco/main.py:6-45).  Zero-egress pods can't download them, so this
module *trains* equivalent tiny transformers from the experiment corpus:

- ``train_prompt_classifier``: binary BertForSequenceClassification over
  forget vs retain prompts;
- ``train_token_classifier``: BertForTokenClassification tagging entity
  tokens (labels derived from the known entity strings).

Both save HF ``pipeline``-loadable directories (model + fast tokenizer), so
the ECO attack path runs through the exact interface the reference uses.
Training is torch on the host CPU: these are host-side detector models, not
the card's compute path.  ``transformers`` and ``tokenizers`` are imported
inside the functions that need them.
"""

from __future__ import annotations

from pathlib import Path


def _build_fast_tokenizer(corpus: list[str], vocab_size: int = 800):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.WordPieceTrainer(
        vocab_size=vocab_size,
        special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
    )
    tok.train_from_iterator(corpus, trainer)
    return PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="[PAD]", unk_token="[UNK]",
        cls_token="[CLS]", sep_token="[SEP]", mask_token="[MASK]",
    )


def _tiny_bert_config(vocab_size: int, num_labels: int):
    from transformers import BertConfig

    return BertConfig(
        vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=128, num_labels=num_labels,
    )


def train_prompt_classifier(
    forget_prompts: list[str],
    retain_prompts: list[str],
    save_dir: str | Path,
    *,
    epochs: int = 400,
    lr: float = 1e-3,
    seed: int = 0,
) -> str:
    """Binary forget-prompt detector → HF text-classification dir.
    LABEL_1 = forget (the polarity HFPipelineBackend gates on).
    The forget class is oversampled to balance the batch (forget splits are
    ~10% of the corpus)."""
    import torch
    from transformers import BertForSequenceClassification

    torch.manual_seed(seed)
    fast = _build_fast_tokenizer(forget_prompts + retain_prompts)
    model = BertForSequenceClassification(_tiny_bert_config(len(fast), 2))
    rep = max(1, len(retain_prompts) // max(1, len(forget_prompts)))
    forget_over = list(forget_prompts) * rep
    texts = forget_over + list(retain_prompts)
    labels = torch.tensor([1] * len(forget_over) + [0] * len(retain_prompts))
    enc = fast(texts, padding=True, truncation=True, max_length=64, return_tensors="pt")

    opt = torch.optim.AdamW(model.parameters(), lr=lr)
    model.train()
    for _ in range(epochs):
        opt.zero_grad()
        out = model(**enc, labels=labels)
        out.loss.backward()
        opt.step()

    save_dir = Path(save_dir)
    model.eval().save_pretrained(save_dir)
    fast.save_pretrained(save_dir)
    return str(save_dir)


def evaluate_prompt_classifier(
    model_dir: str | Path, forget_prompts: list[str], retain_prompts: list[str],
    *, threshold: float = 0.999,
) -> dict:
    """Held-out detector quality: accuracy at the attack threshold (.999,
    methods/eco/main.py:38) + threshold-free ROC-AUC.  The reference's
    detectors are hub models of implicit quality; ours are trained, so this
    records that they actually detect."""
    from multimodal_unlearning_tpu_torch.methods.eco.classifier import HFPipelineBackend

    clf = HFPipelineBackend(str(model_dir))
    scores = [clf.score(p) for p in forget_prompts] + [clf.score(p) for p in retain_prompts]
    labels = [1] * len(forget_prompts) + [0] * len(retain_prompts)
    preds = [int(s > threshold) for s in scores]
    acc = sum(int(p == y) for p, y in zip(preds, labels)) / len(labels)
    # ROC-AUC = P(score_pos > score_neg), ties count half (Mann-Whitney U)
    pos = [s for s, y in zip(scores, labels) if y == 1]
    neg = [s for s, y in zip(scores, labels) if y == 0]
    wins = sum((p > n) + 0.5 * (p == n) for p in pos for n in neg)
    auc = wins / max(len(pos) * len(neg), 1)
    tp = sum(p and y for p, y in zip(preds, labels))
    return {
        "accuracy": acc,
        "roc_auc": float(auc),
        "recall_forget": tp / max(len(pos), 1),
        "false_positive_rate": sum(p and not y for p, y in zip(preds, labels)) / max(len(neg), 1),
        "n_forget": len(pos), "n_retain": len(neg), "threshold": threshold,
    }


def evaluate_token_classifier(
    model_dir: str | Path, prompts: list[str], entities: list[str]
) -> dict:
    """Character-span F1 of the learned tagger against the gold entity spans
    (the same supervision rule used for training labels)."""
    from multimodal_unlearning_tpu_torch.methods.eco.classifier import HFTokenPipelineBackend

    tagger = HFTokenPipelineBackend(str(model_dir))
    pred_spans = tagger._spans(prompts)
    lowered = [e.lower() for e in entities]
    tp = fp = fn = 0
    for p, spans in zip(prompts, pred_spans):
        low = p.lower()
        gold = set()
        for e in lowered:
            start = 0
            while (j := low.find(e, start)) != -1:
                gold.update(range(j, j + len(e)))
                start = j + 1
        pred = set()
        for a, b in spans:
            pred.update(range(a, b))
        tp += len(pred & gold)
        fp += len(pred - gold)
        fn += len(gold - pred)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return {"precision": prec, "recall": rec, "span_f1": f1, "n_prompts": len(prompts)}


def train_token_classifier(
    prompts: list[str],
    entities: list[str],
    save_dir: str | Path,
    *,
    epochs: int = 400,
    lr: float = 1e-3,
    seed: int = 0,
) -> str:
    """Entity token tagger (NER analog) → HF token-classification dir.
    Supervision comes from character spans of the known entity strings,
    aligned to wordpieces via the fast tokenizer's offset mapping."""
    import torch
    from transformers import BertForTokenClassification

    torch.manual_seed(seed)
    fast = _build_fast_tokenizer(list(prompts) + list(entities))
    model = BertForTokenClassification(_tiny_bert_config(len(fast), 2))
    model.config.id2label = {0: "O", 1: "ENT"}
    model.config.label2id = {"O": 0, "ENT": 1}

    lowered = [e.lower() for e in entities]
    enc = fast(
        list(prompts), padding=True, truncation=True, max_length=64,
        return_tensors="pt", return_offsets_mapping=True,
    )
    offsets = enc.pop("offset_mapping")
    labels = torch.full(enc["input_ids"].shape, -100, dtype=torch.long)
    for r, p in enumerate(prompts):
        low = p.lower()
        spans = []
        for e in lowered:
            start = 0
            while (j := low.find(e, start)) != -1:
                spans.append((j, j + len(e)))
                start = j + 1
        for c, (a, b) in enumerate(offsets[r].tolist()):
            if a == b:  # special/pad token
                continue
            hit = any(not (b <= s or a >= t) for s, t in spans)
            labels[r, c] = 1 if hit else 0

    opt = torch.optim.AdamW(model.parameters(), lr=lr)
    model.train()
    for _ in range(epochs):
        opt.zero_grad()
        out = model(**enc, labels=labels)
        out.loss.backward()
        opt.step()

    save_dir = Path(save_dir)
    model.eval().save_pretrained(save_dir)
    fast.save_pretrained(save_dir)
    return str(save_dir)
