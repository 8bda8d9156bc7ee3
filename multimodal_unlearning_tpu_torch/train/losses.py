"""The unlearning losses -- plain functions over model applies.

Counterpart of ``multimodal_unlearning_tpu/train/losses.py``, with the torch
semantics of the reference reproduced as there:

- ``ce_loss``      = HF ``outputs.loss``: mean CE over shifted non-(-100)
                     labels (image-token positions carry -100).
- ``seq_sum_ce``   = per-sequence summed CE, ignore -100.
- ``kl_div(i, t)`` = ``F.kl_div(input, target, reduction="batchmean",
                     log_target=True)`` over [B*S, V] flattened log-probs:
                     sum(exp(t) * (t - i)) / (B*S), i.e. KL(t || i).

- DPO keeps the reference's effective final loss (the computed preference
  loss is overwritten, as in the JAX package), with the true DPO loss under
  ``dpo_fix``.

Every loss type of the JAX package is here: ``retain_ft``, ``grad_ascent``,
the ``grad_diff_*`` variants, ``scrub``, ``kl``, ``llmu``, ``rmu`` (and
``rmu_nlp``), ``npo`` (and ``npo_nlp``), ``idk``, ``eco_ft``, ``dpo`` and
``sku``; plus ``make_control_vec`` (RMU's steering vector) and
``l_regularization`` (L1/L0 from zero or from the initial model).

Each loss takes the batch dict (split -> tensors) plus ``student`` /
``teacher`` apply closures, and returns (scalar loss, metrics dict).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_unlearning_tpu_torch.utils.pytree import tree_leaves_with_path

# teacher-need predicate
LOSSES_WITH_TEACHER = ("DPO", "SCRUB", "RMU", "LLMU", "SKU", "NPO")
RMU_LAYER = 7  # the decoder layer whose output RMU steers


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
                        beta: float = 1.0, loss_args: dict | None = None, control_vec=None,
                        dpo_fix: bool = False):
    """Returns (loss, metrics).

    ``student(split_batch, capture_layer=None)`` -> {"logits", "captured"}
    with gradients; ``teacher`` the same, its outputs detached here.
    """
    lt = loss_type.lower()
    loss_args = loss_args or {}
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

    elif lt == "scrub":
        forget_lp = logits2logprobs(s_fwd("forget")["logits"])
        oracle_forget_lp = logits2logprobs(t_fwd("forget")["logits"])
        # torch call order: kl_div(input=oracle, target=student) = KL(student || oracle)
        kl_forget = kl_div(oracle_forget_lp, forget_lp)

        retain_logits = s_fwd("retain")["logits"]
        retain_lp = logits2logprobs(retain_logits)
        oracle_retain_lp = logits2logprobs(t_fwd("retain")["logits"])
        kl_retain = kl_div(oracle_retain_lp, retain_lp)
        retain_ce = ce_loss(retain_logits, batch["retain"]["labels"])

        metrics.update(kl_forget=kl_forget, kl_retain=kl_retain, retain_ce=retain_ce)
        loss = -beta * kl_forget + kl_retain + retain_ce

    elif lt == "kl":
        forget_loss = -ce_loss(s_fwd("forget")["logits"], batch["forget"]["labels"])
        retain_lp = logits2logprobs(s_fwd("retain")["logits"])
        oracle_retain_lp = logits2logprobs(t_fwd("retain")["logits"])
        retain_loss = kl_div(retain_lp, oracle_retain_lp)
        metrics.update(forget_loss=forget_loss, retain_loss=retain_loss)
        loss = forget_loss + retain_loss

    elif lt == "llmu":
        forget_loss = -ce_loss(s_fwd("forget")["logits"], batch["forget"]["labels"])
        random_loss = ce_loss(s_fwd("idk")["logits"], batch["idk"]["labels"])
        retain_lp = logits2logprobs(s_fwd("retain")["logits"])
        oracle_retain_lp = logits2logprobs(t_fwd("retain")["logits"])
        # torch call order: kl_div(input=oracle, target=student)
        retain_loss = kl_div(oracle_retain_lp, retain_lp)
        metrics.update(forget_loss=forget_loss, retain_loss=retain_loss, random_loss=random_loss)
        loss = forget_loss + retain_loss + random_loss

    elif lt == "rmu":
        if control_vec is None:
            raise ValueError("RMU needs a control vector (see make_control_vec)")
        forget_acts = s_fwd("forget", capture_layer=RMU_LAYER)["captured"]
        if loss_args.get("rmu_nlp"):
            # the NLP trainer's form: mse over the raw [B, S, H] activations
            # (no mean over the sequence) against a (1, 1, H) control vector
            forget_loss = mse(forget_acts, control_vec) * beta
        else:
            forget_loss = mse(torch.mean(forget_acts, dim=1), control_vec) * beta
        retain_acts = s_fwd("retain", capture_layer=RMU_LAYER)["captured"]
        oracle_retain_acts = t_fwd("retain", capture_layer=RMU_LAYER)["captured"]
        retain_loss = mse(retain_acts, oracle_retain_acts)
        metrics.update(forget_loss=forget_loss, retain_loss=retain_loss)
        loss = forget_loss + retain_loss

    elif lt == "npo":
        forget_p = logits2probs(s_fwd("forget")["logits"])
        oracle_forget_p = logits2probs(t_fwd("forget")["logits"])
        if loss_args.get("npo_nlp"):
            # the NLP trainer's form: the power applies to the LOG
            # probability ratio, with no epsilon (a fractional beta on a
            # negative log-ratio gives NaN, as there)
            pi_ratios = torch.log(forget_p / oracle_forget_p)
        else:
            # the MM trainer's form: ratio ** beta, +1e-8
            pi_ratios = forget_p / (oracle_forget_p + 1e-8)
        loss = (2.0 / beta) * torch.mean(torch.log1p(pi_ratios ** beta))

    elif lt == "idk":
        retain_loss = ce_loss(s_fwd("retain")["logits"], batch["retain"]["labels"])
        idk_loss = ce_loss(s_fwd("idk")["logits"], batch["idk"]["labels"])
        metrics.update(retain_loss=retain_loss, idk_loss=idk_loss)
        loss = retain_loss + idk_loss

    elif lt == "eco_ft":
        forget_loss = ce_loss(s_fwd("forget")["logits"], batch["forget"]["labels"])
        retain_loss = ce_loss(s_fwd("retain")["logits"], batch["retain"]["labels"])
        metrics.update(forget_loss=forget_loss, retain_loss=retain_loss)
        loss = beta * forget_loss + retain_loss

    elif lt == "dpo":
        idk_logits = s_fwd("idk")["logits"]
        forget_logits = s_fwd("forget")["logits"]
        idk_logits_o = t_fwd("idk")["logits"]
        forget_logits_o = t_fwd("forget")["logits"]

        idk_lp = -seq_sum_ce(idk_logits, batch["idk"]["labels"])
        forget_lp = -seq_sum_ce(forget_logits, batch["forget"]["labels"])
        idk_lp_o = -seq_sum_ce(idk_logits_o, batch["idk"]["labels"])
        forget_lp_o = -seq_sum_ce(forget_logits_o, batch["forget"]["labels"])

        pi_logratios = idk_lp - forget_lp
        ref_logratios = idk_lp_o - forget_lp_o
        dpo_beta = 0.1
        true_dpo = -torch.mean(F.logsigmoid(dpo_beta * (pi_logratios - ref_logratios)))
        metrics.update(true_dpo_loss=true_dpo, pi_logratios=torch.mean(pi_logratios))
        # the reference overwrites it with -mean(idk sequence log-prob)
        loss = true_dpo if dpo_fix else -torch.mean(idk_lp)

    elif lt == "sku":
        bad_loss = ce_loss(s_fwd("forget")["logits"], batch["forget"]["labels"])
        # random: [B, K, ...] -> K forwards
        rnd = batch["random"]
        K = rnd["input_ids"].shape[1]
        random_loss = 0.0
        for i in range(K):
            sub = {k: v[:, i] for k, v in rnd.items()}
            random_loss = random_loss + ce_loss(student(sub)["logits"], sub["labels"])
        retain_lp = logits2logprobs(s_fwd("retain")["logits"])
        teacher_retain_lp = logits2logprobs(t_fwd("retain")["logits"])
        normal_loss = -kl_div(retain_lp, teacher_retain_lp)
        metrics.update(bad_loss=bad_loss, random_loss=random_loss, normal_loss=normal_loss)
        loss = (loss_args.get("bad_weight", 2.5) * bad_loss
                + loss_args.get("random_weight", 1.0) * random_loss
                + loss_args.get("normal_weight", 0.5) * normal_loss)

    else:
        raise ValueError(f"Invalid loss type {loss_type}")

    metrics["loss"] = loss
    return loss, metrics


def make_control_vec(generator: torch.Generator, batch_size: int, hidden_size: int,
                     norm: float = 300.0):
    """RMU's steering vector: uniform [0, 1) draws of shape [B, 1, H] from
    ``generator`` (on the device the vector lives on), scaled to global
    norm ``norm``.  The JAX package draws from its own key; the streams
    differ, the distribution and the scaling do not."""
    v = torch.rand((batch_size, 1, hidden_size), generator=generator,
                   device=generator.device, dtype=torch.float32)
    return v / torch.linalg.vector_norm(v) * norm


def _delta(p, p0):
    """The leaf (or its distance from the initial model) in f32 or wider:
    the difference in the leaf's own dtype, then promoted, as in JAX."""
    d = p if p0 is None else p - p0
    return d.to(_promote(d.dtype))


def _slices(p, p0):
    """(leaf slice, initial slice) pairs: a stacked leaf a layer at a time,
    so that no f32 copy of a whole 7B leaf is made."""
    if p.ndim >= 3:
        return [(p[i], None if p0 is None else p0[i]) for i in range(p.shape[0])]
    return [(p, p0)]


def l1_grad(p, p0, l1_lambda: float, scale=1.0):
    """L1's gradient with respect to ``p``: ``scale * l1_lambda * sign(p - p0)``
    in f32, cast to ``p``'s dtype (sign(0) = 0, torch's subgradient), built
    a layer slice at a time."""
    out = torch.empty_like(p)
    for (s, s0), (o, _) in zip(_slices(p, p0), _slices(out, None)):
        o.copy_(torch.sign(_delta(s, s0)) * (scale * l1_lambda))
    return out


class _L1(torch.autograd.Function):
    """``l1_lambda * sum(d * sign(d))``, ``d = p - p0``, summed per layer
    slice in f32; the backward recomputes sign(d) slice by slice instead of
    saving an f32 copy of it."""

    @staticmethod
    def forward(ctx, p, p0, l1_lambda):
        ctx.save_for_backward(p, p0)
        ctx.l1_lambda = l1_lambda
        with torch.no_grad():
            tot = sum(torch.sum(d * torch.sign(d)) for d in
                      (_delta(s, s0) for s, s0 in _slices(p, p0)))
        return l1_lambda * tot

    @staticmethod
    def backward(ctx, g):
        p, p0 = ctx.saved_tensors
        return l1_grad(p, p0, ctx.l1_lambda, g), None, None


def l_regularization(trainable, init=None, *, l1_lambda: float = 0.0, l0_lambda: float = 0.0):
    """L1/L0 over the trainable leaves, or over their distance from
    ``init`` (the initial model, ``l_norm_from: init``).  The JAX package
    concatenates the tree into one f32 vector; here each leaf is summed in
    f32 a layer slice at a time, the same value up to summation order.  L1
    is ``x * sign(x)``, whose gradient is sign(x) with 0 at 0 (torch's), not
    d|x| = 1 there; L0 (the count of non-zeros) adds its value and no
    gradient."""
    inits = {} if init is None else dict(tree_leaves_with_path(init))
    reg = 0.0
    for path, p in tree_leaves_with_path(trainable):
        p0 = inits.get(path)
        p0 = None if p0 is None else p0.detach()
        if l1_lambda:
            reg = reg + _L1.apply(p, p0, l1_lambda)
        if l0_lambda:
            with torch.no_grad():
                n = sum(torch.count_nonzero(_delta(s, s0)) for s, s0 in _slices(p, p0))
            reg = reg + l0_lambda * n.to(torch.float32)
    return reg
