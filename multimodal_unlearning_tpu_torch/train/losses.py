"""The unlearning losses -- plain functions over model applies.

Counterpart of ``multimodal_unlearning_tpu/train/losses.py``, with the torch
semantics of the reference reproduced as there:

- ``ce_loss``      = HF ``outputs.loss``: mean CE over shifted non-(-100)
                     labels (image-token positions carry -100).
- ``seq_sum_ce``   = per-sequence summed CE, ignore -100.
- ``kl_div(i, t)`` = ``F.kl_div(input, target, reduction="batchmean",
                     log_target=True)`` over [B*S, V] flattened log-probs:
                     sum(exp(t) * (t - i)) / (B*S), i.e. KL(t || i).

Ported loss types: ``retain_ft``, ``grad_ascent`` and every ``grad_diff_*``
variant.  The others (scrub, kl, llmu, rmu, npo, idk, eco_ft, dpo, sku) and
``l_regularization`` raise ``NotImplementedError`` until they are ported.

Each loss takes the batch dict (split -> tensors) plus ``student`` /
``teacher`` apply closures, and returns (scalar loss, metrics dict).
"""

from __future__ import annotations

import torch

# teacher-need predicate
LOSSES_WITH_TEACHER = ("DPO", "SCRUB", "RMU", "LLMU", "SKU", "NPO")
UNPORTED_LOSSES = ("scrub", "kl", "llmu", "rmu", "npo", "idk", "eco_ft", "dpo", "sku")


def loss_needs_teacher(loss_type: str) -> bool:
    return "KL" in loss_type or loss_type.upper() in LOSSES_WITH_TEACHER


def batch_return_pairs(loss_type: str) -> tuple[str, ...]:
    """Which batch splits the loss consumes."""
    lt = loss_type.upper()
    if lt in ("DPO", "LLMU"):
        return ("forget", "retain", "idk")
    if lt == "IDK":
        return ("idk", "retain")
    if lt == "SKU":
        return ("forget", "retain", "random")
    return ("forget", "retain")


# ---------------------------------------------------------------------------
# primitive loss pieces (torch semantics)
# ---------------------------------------------------------------------------


def _promote(dtype):
    return torch.promote_types(dtype, torch.float32)


def shift(logits, labels):
    return logits[:, :-1, :], labels[:, 1:]


def _token_nll(logits, labels):
    """Per-token NLL in logsumexp form, in f32 for bf16 logits."""
    lg, lb = shift(logits, labels)
    valid = lb != -100
    lb_safe = torch.where(valid, lb, torch.zeros_like(lb)).long()
    lg32 = lg.to(_promote(lg.dtype))
    lse = torch.logsumexp(lg32, dim=-1)
    ll = torch.gather(lg32, -1, lb_safe[..., None])[..., 0]
    nll = lse - ll
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def ce_loss(logits, labels):
    """HF ``outputs.loss``: mean CE over valid shifted positions."""
    nll, valid = _token_nll(logits, labels)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def seq_sum_ce(logits, labels):
    """Per-sequence summed CE, ignore -100 -> [B]."""
    nll, _ = _token_nll(logits, labels)
    return nll.sum(dim=-1)


def logits2logprobs(logits):
    """[B, S, V] -> [B*S, V] log-softmax."""
    lp = torch.log_softmax(logits.to(_promote(logits.dtype)), dim=-1)
    return lp.reshape(-1, lp.shape[-1])


def logits2probs(logits):
    p = torch.softmax(logits.to(_promote(logits.dtype)), dim=-1)
    return p.reshape(-1, p.shape[-1])


def kl_div(input_logp, target_logp):
    """torch F.kl_div(..., reduction='batchmean', log_target=True)."""
    t = torch.exp(target_logp)
    return torch.sum(t * (target_logp - input_logp)) / input_logp.shape[0]


def mse(a, b):
    return torch.mean((a - b) ** 2)


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def compute_forget_loss(loss_type: str, batch: dict, *, student, teacher=None,
                        beta: float = 1.0):
    """Returns (loss, metrics).

    ``student(split_batch, capture_layer=None)`` -> {"logits", "captured"}
    with gradients; ``teacher`` the same, its outputs detached here.
    """
    lt = loss_type.lower()
    metrics = {}

    def s_fwd(split, **kw):
        return student(batch[split], **kw)

    def t_fwd(split, **kw):
        if teacher is None:
            raise ValueError(f"loss type {loss_type} needs a teacher")
        out = teacher(batch[split], **kw)
        return {k: None if v is None else v.detach() for k, v in out.items()}

    if lt == "retain_ft":
        loss = ce_loss(s_fwd("retain")["logits"], batch["retain"]["labels"])

    elif lt == "grad_ascent":
        loss = -ce_loss(s_fwd("forget")["logits"], batch["forget"]["labels"])

    elif lt.startswith("grad_diff"):
        forget_logits = s_fwd("forget")["logits"]
        retain_logits = s_fwd("retain")["logits"]

        if "forget_ce" in lt:
            forget_loss = ce_loss(forget_logits, batch["forget"]["labels"])
        elif "forget_entropy" in lt:
            p = logits2probs(forget_logits)
            forget_loss = torch.sum(p * torch.log(p + 1e-30))
        elif "forget_kl" in lt:
            forget_loss = kl_div(
                logits2logprobs(forget_logits),
                logits2logprobs(t_fwd("forget")["logits"]),
            )
        else:
            raise ValueError(f"Invalid loss type on forget {loss_type}")

        if "retain_ce" in lt:
            retain_loss = ce_loss(retain_logits, batch["retain"]["labels"])
        elif "retain_kl" in lt:
            retain_loss = kl_div(
                logits2logprobs(retain_logits),
                logits2logprobs(t_fwd("retain")["logits"]),
            )
        else:
            raise ValueError(f"Invalid loss type on retain {loss_type}")

        metrics.update(forget_loss=forget_loss, retain_loss=retain_loss)
        loss = -beta * forget_loss + retain_loss

    elif lt in UNPORTED_LOSSES:
        raise NotImplementedError(f"loss type {loss_type!r} is not ported yet")

    else:
        raise ValueError(f"Invalid loss type {loss_type}")

    metrics["loss"] = loss
    return loss, metrics
