"""Prompt-lookup speculation, the steps shared by the serving engine's
verify rounds (``serve/engine.py``) and ``evaluation/generate.py``'s
speculative route: ``propose_drafts`` makes a round's K drafts, and
``accept_round`` keeps what one ``chunk_decode`` verify forward agreed
with.  The JAX package's ``propose`` and the accept step of its engine and
``_spec_generate``."""

from __future__ import annotations

import torch

__all__ = ["propose_drafts", "accept_round", "token_logprobs"]


def propose_drafts(draft_ref, ids_buf, token, cur, K: int):
    """Prompt-lookup drafts: the K tokens that followed the most recent
    2-gram match of (previous token, ``token``) in [draft corpus ``draft_ref``
    [B, R] | separator -5 | history ``ids_buf`` [B, Smax]]; -2 marks entries
    that never match.  A match whose K followers are all known wins over a
    later partial one; unknown followers are -4, which never equals an
    argmax.  ``cur`` [B] is each row's history length.  Returns [B, K]."""
    B, R = ids_buf.shape[0], draft_ref.shape[1]
    dev = ids_buf.device
    rows = torch.arange(B, device=dev)
    buf = torch.cat([draft_ref, torch.full((B, 1), -5, dtype=ids_buf.dtype, device=dev),
                     ids_buf], dim=1)
    W = buf.shape[1]
    prev = ids_buf[rows, torch.clamp(cur - 1, min=0)]
    nxt = torch.cat([buf[:, 1:], torch.full((B, 1), -3, dtype=buf.dtype, device=dev)], 1)
    m = (buf == prev[:, None]) & (nxt == token[:, None])
    pcol = torch.arange(W, device=dev)[None, :]
    limit = torch.where(pcol < R, R, R + 1 + cur[:, None])
    none = torch.tensor(-1, device=dev)
    p_full = torch.where(m & (pcol + 2 + K <= limit), pcol, none).amax(dim=1)
    p_any = torch.where(m & (pcol + 2 < limit), pcol, none).amax(dim=1)
    p = torch.where(p_full >= 0, p_full, p_any)
    cols = p[:, None] + 2 + torch.arange(K, device=dev)[None, :]
    vals = buf[rows[:, None], torch.clamp(cols, 0, W - 1)]
    p_limit = torch.where(p < R, R, R + 1 + cur)
    known = (p[:, None] >= 0) & (cols < p_limit[:, None])
    return torch.where(known, vals, -4)


def token_logprobs(logits, tokens):
    """The raw ``log_softmax`` of ``logits`` [..., V] (in f32) at
    ``tokens`` [...]: the logprob of each emitted token, whatever the
    sampling settings."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, -1, tokens[..., None])[..., 0]


def accept_round(chunk, preds, live, cap, ids_buf, kv_valid, write_col, eos: int,
                 logits=None):
    """What one verify round keeps.  ``chunk`` [B, K+1] is [token | drafts]
    as verified, ``preds`` [B, K+1] the argmax after each of its positions.
    The run of drafts equal to the argmax is accepted (``a``, 0..K), and the
    row emits preds[0..a], cut before an eos (which is not emitted) and at
    ``cap`` [B] tokens; a row that is not ``live`` emits nothing.  The
    accepted context chunk[0..a] extends the row's history ``ids_buf`` and
    its validity ``kv_valid`` (both [B, Smax], in place) from column
    ``write_col`` [B] on.  Returns (a, n_emit, hit_eos), each [B], and with
    the verify forward's ``logits`` [B, K+1, V] also the logprob of each
    position's argmax [B, K+1] (emitted tokens are preds[0..n_emit))."""
    B, C = chunk.shape
    dev = chunk.device
    ar = torch.arange(C, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None]
    a = torch.cumprod((chunk[:, 1:] == preds[:, :-1]).long(), dim=1).sum(dim=1)
    n_emit = a + 1
    if eos >= 0:
        eos_idx = torch.where(preds == eos, ar, C).amin(dim=1)
        n_emit = torch.minimum(n_emit, eos_idx)
        hit_eos = eos_idx <= a
    else:
        hit_eos = torch.zeros_like(live)
    n_emit = torch.where(live, torch.minimum(n_emit, cap), 0)
    acc = (ar <= a[:, None]) & live[:, None]
    cols = torch.where(acc, write_col[:, None] + ar, ids_buf.shape[1] - 1)
    ids_buf[rows, cols] = torch.where(acc, chunk, ids_buf[rows, cols])
    kv_valid[rows, cols] = torch.maximum(kv_valid[rows, cols], acc.to(torch.int32))
    if logits is not None:
        return a, n_emit, hit_eos, token_logprobs(logits, preds)
    return a, n_emit, hit_eos
