"""Batched generation with a KV cache, greedy or sampled, in PyTorch.

Counterpart of ``multimodal_unlearning_tpu/evaluation/generate.py``
(``pad_prompts``, ``greedy_generate``): the evaluator's per-batch
generation, the HF ``model.generate(..., use_cache=True)`` of the
reference eval.

- Plain route: one prefill of the left-padded prompts (kernel B1 on the
  card, ``last_logit_only``) into a [L, B, Hkv, Smax, D] cache of ``Smax =
  ceil((S + max_new_tokens + slack) / 128) * 128`` columns, then one-token
  decode steps through the model's decode mode (B4, or B4q on an int8
  cache).  Before step t, column S + t is made valid for the rows not yet
  finished; positions are ``prompt_len + t`` (valid tokens, not columns);
  a finished row emits ``pad_token_id``.
- Speculative route (``speculate_k`` = K > 0): prompt-lookup drafts of K
  tokens from a 2-gram match over the row's history and its ``draft_ref``
  corpus, verified by one ``chunk_decode`` forward (B5 / B5q); the drafts
  equal to the argmax are accepted, plus the argmax after them (the steps
  the serving engine's verify rounds take: ``speculative.py``).  Token for
  token the plain route's output.

The JAX package runs the loop as one compiled ``while_loop``; here it runs
on the host, one eager forward a step, and everything about a step stays on
the device.  The host learns whether every row has finished once per
``CHECK_EVERY`` steps, from a copy of the flag it queued before and does not
wait for (on the card), so the loop never stalls the device queue; the
steps run after the last row finished emit only pad, so the tokens are the
ones the JAX loop returns.  ``eos_token_id=None`` runs the whole budget.

- Sampled route (``do_sample``): the plain route with each token drawn by
  ``evaluation/sampling.py`` (temperature / top-k / top-p) instead of the
  argmax: row b's token i under the key ``fold_in(fold_in(key0,
  sample_seeds[b]), i)`` (the first token i = 0, step t's i = t + 1), the
  JAX package's stream bit for bit, and the stream the serving engine
  gives the same request and seed.

The JAX function's ``aot_layouts`` (an XLA parameter-layout cache) has no
meaning in eager PyTorch and is ignored; ``mesh`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.evaluation import sampling
from multimodal_unlearning_tpu_torch.models import decoder_module
from multimodal_unlearning_tpu_torch.speculative import accept_round, propose_drafts

__all__ = ["pad_prompts", "greedy_generate", "CHECK_EVERY"]

# decode steps (verify rounds) between two looks at whether every row has
# finished
CHECK_EVERY = 8


def pad_prompts(encoded: list[list[int]], pad_id: int, multiple: int = 128):
    """Left-pad variable-length prompts into a [B, S] batch, S a multiple
    of ``multiple`` (int32 numpy ids and mask)."""
    S = -(-max(len(e) for e in encoded) // multiple) * multiple
    ids = np.full((len(encoded), S), pad_id, np.int32)
    mask = np.zeros((len(encoded), S), np.int32)
    for r, e in enumerate(encoded):
        e = e[-S:]
        ids[r, S - len(e):] = e
        mask[r, S - len(e):] = 1
    return ids, mask


class _AllFinished:
    """Whether every row has finished, as far as the host can tell without
    waiting for the device.  ``check(finished)`` returns what the last
    landed copy of ``finished.all()`` said and queues a new copy once that
    one has landed; on the CPU it reads ``finished`` at once."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.flag = torch.zeros((), dtype=torch.bool, pin_memory=self.cuda)
        self.event = None

    def check(self, finished) -> bool:
        if not self.cuda:
            return bool(finished.all())
        if self.event is not None:
            if not self.event.query():
                return False
            if bool(self.flag):
                return True
        self.flag.copy_(finished.all(), non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        return False


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _bucket(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _prefill(model, is_vlm, input_ids, attention_mask, pixel_values, cache, kv_valid,
             attn_impl, compute_dtype):
    kw = dict(attention_mask=attention_mask, kv_cache=cache, cache_offset=0,
              kv_valid_mask=kv_valid, last_logit_only=True, attn_impl=attn_impl,
              compute_dtype=compute_dtype)
    if is_vlm:
        kw["pixel_values"] = pixel_values
    out = model(input_ids, **kw)
    # Qwen2-VL: decode positions continue from the M-RoPE prompt's extent
    delta = out.get("rope_delta")
    return out["logits"][:, -1, :], (0 if delta is None else delta.long())


def _generate(model, is_vlm, input_ids, attention_mask, pixel_values, *, cache, smax,
              max_new_tokens, pad_token_id, eos, attn_impl, compute_dtype, sample=None):
    B, S = input_ids.shape
    dev = input_ids.device
    kv_valid = torch.zeros((B, smax), dtype=torch.int32, device=dev)
    kv_valid[:, :S] = attention_mask
    last, delta = _prefill(model, is_vlm, input_ids, attention_mask, pixel_values, cache,
                           kv_valid, attn_impl, compute_dtype)
    prompt_len = attention_mask.sum(dim=-1).long() + delta
    if sample is None:
        def pick(logits, _):
            return torch.argmax(logits, dim=-1)
    else:  # token i of row b: the key of (sample_seeds[b], i)
        keys = sampling.row_keys(sample["seeds"], device=dev)

        def pick(logits, i):
            return sampling.sample_token(keys, torch.full((B,), i, device=dev), logits,
                                         sample["temperature"], sample["top_k"],
                                         sample["top_p"])
    token = pick(last, 0)
    finished = (token == eos) if eos >= 0 else torch.zeros((B,), dtype=torch.bool, device=dev)
    out = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
    out[:, 0] = torch.where(finished, pad_token_id, token)
    ones = torch.ones((B, 1), dtype=torch.int32, device=dev)
    done = _AllFinished(dev)
    steps = 0
    for t in range(max_new_tokens - 1):
        if eos >= 0 and t % CHECK_EVERY == 0 and done.check(finished):
            break
        kv_valid[:, S + t] = (~finished).to(torch.int32)
        # the one-token kernel reads only the columns a row can hold by now
        extent = min(smax, _bucket(S + t + 1, 128))
        logits = model(token[:, None], attention_mask=ones, positions=(prompt_len + t)[:, None],
                       kv_cache=cache, cache_offset=S + t, kv_valid_mask=kv_valid[:, :extent],
                       attn_impl=attn_impl, compute_dtype=compute_dtype)["logits"]
        token = pick(logits[:, -1, :], t + 1)
        if eos >= 0:
            finished = finished | (token == eos)
        out[:, t + 1] = torch.where(finished, pad_token_id, token)
        steps += 1
    return out, {"forwards": steps}


def _spec_generate(model, is_vlm, input_ids, attention_mask, pixel_values, draft_ref, *, cache,
                   smax, max_new_tokens, pad_token_id, eos, k_spec, vocab, attn_impl,
                   compute_dtype):
    B, S = input_ids.shape
    K = k_spec
    dev = input_ids.device
    kv_valid = torch.zeros((B, smax), dtype=torch.int32, device=dev)
    kv_valid[:, :S] = attention_mask
    last, delta = _prefill(model, is_vlm, input_ids, attention_mask, pixel_values, cache,
                           kv_valid, attn_impl, compute_dtype)
    token = torch.argmax(last, dim=-1)
    finished = (token == eos) if eos >= 0 else torch.zeros((B,), dtype=torch.bool, device=dev)
    finished = finished | (max_new_tokens <= 1)
    # token history for the lookup: -2 marks never-match slots
    ids_buf = torch.full((B, smax), -2, dtype=torch.long, device=dev)
    ids_buf[:, :S] = torch.where(attention_mask > 0, input_ids.long(), -2)
    out = torch.full((B, max_new_tokens + K + 1), pad_token_id, dtype=torch.long, device=dev)
    out[:, 0] = torch.where(finished, pad_token_id, token)
    ar = torch.arange(K + 1, device=dev)
    rows = torch.arange(B, device=dev)
    ones = torch.ones((B, K + 1), dtype=torch.int32, device=dev)
    cur = torch.full((B,), S, dtype=torch.long, device=dev)
    pos = attention_mask.sum(dim=-1).long() + delta
    n_out = torch.ones((B,), dtype=torch.long, device=dev)
    done = _AllFinished(dev)
    forwards = 0
    # at most max_new_tokens - 1 rounds: every live row emits >= 1 token a round
    while forwards < max_new_tokens - 1:
        if forwards % CHECK_EVERY == 0 and done.check(finished):
            break
        live = ~finished
        chunk = torch.cat([token[:, None], propose_drafts(draft_ref, ids_buf, token, cur, K)], 1)
        logits = model(torch.clamp(chunk, 0, vocab - 1), attention_mask=ones,
                       positions=pos[:, None] + ar[None, :], kv_cache=cache, cache_offset=cur,
                       kv_valid_mask=kv_valid, chunk_decode=True, attn_impl=attn_impl,
                       compute_dtype=compute_dtype)["logits"]
        forwards += 1
        preds = torch.argmax(logits, dim=-1)  # [B, K+1]
        a, n_emit, hit_eos = accept_round(chunk, preds, live, max_new_tokens - n_out, ids_buf,
                                          kv_valid, cur, eos)
        emit = ar[None, :] < n_emit[:, None]
        out_cols = torch.where(emit, n_out[:, None] + ar[None, :], max_new_tokens + ar[None, :])
        out[rows[:, None], out_cols] = torch.where(emit, preds, pad_token_id)
        adv = torch.where(live, a + 1, 0)
        n_out = n_out + n_emit
        finished = finished | hit_eos | (n_out >= max_new_tokens)
        token = torch.where(live, preds[rows, a], token)
        cur = cur + adv
        pos = pos + adv
    return out[:, :max_new_tokens], {"forwards": forwards}


def greedy_generate(
    params,
    model_cfg,
    input_ids,
    attention_mask,
    *,
    max_new_tokens: int,
    pad_token_id: int,
    eos_token_id: int | None = None,
    pixel_values=None,
    is_vlm: bool = False,
    cache_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    compute_dtype=torch.bfloat16,
    mesh=None,
    aot_layouts: bool = False,
    speculate_k: int = 0,
    draft_ref=None,
    do_sample: bool = False,
    temperature=1.0,
    top_k: int = 0,
    top_p=1.0,
    sample_seeds=None,
    return_stats: bool = False,
):
    """Generated token ids [B, max_new_tokens] (int64, pad after eos) on the
    model's device.

    ``params``: the model (``models.llava.Llava`` with ``is_vlm``, or
    ``models.llama.Llama``).  ``input_ids`` / ``attention_mask`` [B, S]
    left-padded prompts, numpy or torch.  ``cache_dtype=torch.int8``: the
    int8 KV cache (B4q / B5q).  ``speculate_k`` > 0: the speculative route,
    with ``draft_ref`` [B, R] optional reference rows (-2 padded) seeding
    the lookup corpus.  ``do_sample``: sampled decoding (``temperature``,
    ``top_k``, ``top_p``), row b seeded ``sample_seeds[b]`` (default
    ``arange(B)``); speculation verifies against the argmax, so the two
    together raise ValueError.  ``return_stats``: also return {"forwards":
    decode forwards (verify rounds) run}.  ``aot_layouts`` is accepted and
    ignored (an XLA layout cache in the JAX package); ``mesh`` raises."""
    del aot_layouts
    if do_sample and speculate_k:
        raise ValueError("speculate_k verifies against greedy argmax; combine it with "
                         "do_sample=False")
    if mesh is not None:
        raise NotImplementedError("mesh: tensor-parallel generation needs multi-GPU, which is "
                                  "not ported yet")
    dev = next(params.parameters()).device
    input_ids = _tensor(input_ids).to(dev, torch.long)
    attention_mask = _tensor(attention_mask).to(dev, torch.int32)
    if pixel_values is not None:
        pixel_values = _tensor(pixel_values).to(dev, compute_dtype)
    B, S = input_ids.shape
    dec_cfg = model_cfg.decoder if is_vlm else model_cfg
    slack = 2 * speculate_k + 2 if speculate_k else 0
    smax = _bucket(S + max_new_tokens + slack, 128)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    with torch.inference_mode():
        cache = decoder_module(dec_cfg).init_kv_cache(dec_cfg, B, smax, dtype=cache_dtype,
                                                      device=dev)
        kw = dict(cache=cache, smax=smax, max_new_tokens=max_new_tokens,
                  pad_token_id=pad_token_id, eos=eos, attn_impl=attn_impl,
                  compute_dtype=compute_dtype)
        if speculate_k:
            ref = torch.zeros((B, 0)) if draft_ref is None else _tensor(draft_ref)
            tokens, stats = _spec_generate(
                params, is_vlm, input_ids, attention_mask, pixel_values, ref.to(dev, torch.long),
                k_spec=int(speculate_k), vocab=dec_cfg.vocab_size, **kw)
        else:
            sample = None
            if do_sample:
                seeds = torch.arange(B) if sample_seeds is None else _tensor(sample_seeds)
                sample = dict(seeds=seeds.to(dev, torch.long), temperature=float(temperature),
                              top_k=int(top_k), top_p=float(top_p))
            tokens, stats = _generate(params, is_vlm, input_ids, attention_mask, pixel_values,
                                      sample=sample, **kw)
    return (tokens, stats) if return_stats else tokens
