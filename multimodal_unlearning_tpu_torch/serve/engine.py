"""Continuous-batching serving engine, dense KV cache, in PyTorch.

Counterpart of ``multimodal_unlearning_tpu/serve/engine.py`` with the same
host semantics: a fixed pool of decode slots, each at its own sequence
position, refilled from the queue between decode chunks.

- prefill + insert: a request's prompt, left-padded to its bucket, runs
  through the model straight into its slot's columns of the stacked
  [L, B, Hkv, Smax, D] cache (a view of the slot's slab); the first token
  is the argmax of the last position.
- decode chunk: ``chunk`` single-token steps for ALL slots at once.  Every
  slot sits at its own cache column (per-row cache write) and reads the
  cache through its [B, Smax] validity row, so idle slots (all-zero rows)
  decode too and their output is thrown away.
- the per-slot state (``kv_valid``, ``write_col``, ``pos_next``,
  ``token``, ``remaining``, ``live``) lives on the device and is updated in
  place; the host reads only each chunk's emitted tokens.  In pipelined
  mode chunk k+1 is queued before chunk k's tokens are read, so the device
  queue never drains while the host does its bookkeeping.

The JAX engine runs each chunk as one compiled ``lax.scan``; here every
op of every step is launched from Python, so decode is bound by the host
(CUDA graphs are the tool for that, in later work).  Everything runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models import decoder_module


@dataclass
class Request:
    """One generation request: prompt token ids -> generated token ids."""

    uid: int
    prompt_ids: list
    max_new_tokens: int
    pixel_values: np.ndarray | None = None
    tokens: list = field(default_factory=list)
    stop: list = field(default_factory=list)  # token-id stop sequences
    done: bool = False
    finish_reason: str = ""  # "length", "eos", "stop" or "cancel" once done
    submit_t: float = 0.0   # time.monotonic at submit
    first_t: float = 0.0    # first token available (TTFT = first_t - submit_t)
    done_t: float = 0.0     # request completed


def _bucket(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class ServingEngine:
    """Fixed-slot continuous-batching engine over one model.

    Args:
      params: the model (``models.llama.Llama`` or ``models.llava.Llava``).
      model_cfg / kind: its config and registry kind ("llama" or "llava").
      num_slots: decode batch width B.
      max_len: per-slot cache length Smax (rounded up to 128; prompt bucket
        + new tokens must fit -- longer submissions are rejected).
      chunk: decode steps per dispatch.
      bucket_multiple: prompt lengths round up to this.
      attn_impl: "auto" (the kernels on the card, the plain versions on the
        CPU) or "plain" (the plain versions everywhere; a reference run).
      pipeline: dispatch chunk k+1 before reading chunk k.
      device: where the engine runs; the card unless "cpu" is passed.
      on_prefill: optional ``fn(request, last_logits)`` called with each
        prefill's last-position logits [V] (f32, on the device).

    The JAX engine's speculative decoding, sampling, multi-LoRA, chunked
    prefill, paged cache, logprobs, mesh and int8 cache are not ported:
    asking for any of them raises ``NotImplementedError``.
    """

    def __init__(
        self,
        params,
        model_cfg,
        kind: str,
        *,
        num_slots: int = 8,
        max_len: int = 2048,
        chunk: int = 16,
        bucket_multiple: int = 128,
        pad_token_id: int = 0,
        eos_token_id: int | None = None,
        cache_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        attn_impl: str = "auto",
        mesh=None,
        pipeline: bool = True,
        speculate_k: int = 0,
        spec_ref_len: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        adapters: dict | None = None,
        prefill_chunk: int = 0,
        page_size: int = 0,
        kv_pool_pages: int | None = None,
        logprobs: bool = False,
        device=None,
        on_prefill=None,
    ):
        # spec_ref_len, top_k/top_p and kv_pool_pages only shape the options
        # below; the JAX engine ignores them too while those are off
        del spec_ref_len, top_k, top_p, kv_pool_pages
        unported = {
            "speculate_k": int(speculate_k) != 0,
            "temperature": float(temperature) > 0.0,
            "adapters": bool(adapters),
            "prefill_chunk": int(prefill_chunk) != 0,
            "page_size": int(page_size) != 0,
            "logprobs": bool(logprobs),
            "mesh": mesh is not None,
            "cache_dtype": cache_dtype not in (torch.bfloat16, torch.float16, torch.float32),
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"ServingEngine options not ported yet: {asked} (dense greedy serving only)")
        self.device = resolve_device(device)
        pdev = next(params.parameters()).device
        if pdev.type != self.device.type or (
                self.device.index is not None and pdev.index != self.device.index):
            raise ValueError(f"the model lives on {pdev}, the engine on {self.device}")
        self.params = params
        self.model_cfg = model_cfg
        self.kind = kind
        self.is_vlm = kind == "llava" or hasattr(model_cfg, "decoder")
        self.dec_cfg = model_cfg.decoder if self.is_vlm else model_cfg
        decoder_module(self.dec_cfg)  # raises for a family the port lacks
        self.B = num_slots
        self.smax = _bucket(max_len, 128)
        self.chunk = chunk
        self.bucket_multiple = bucket_multiple
        self.pad_id = pad_token_id
        self.eos = -1 if eos_token_id is None else eos_token_id
        self.cache_dtype = cache_dtype
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.pipeline = pipeline
        self.on_prefill = on_prefill
        self._queue: list[Request] = []
        self._slot_req: list[Request | None] = [None] * self.B
        self._free = list(range(self.B))
        self._uid = 0
        self._state = None
        self._n_dispatch = 0
        self._n_prefill = 0
        self._n_live_rounds = 0
        self._n_emitted = 0
        # pipelined mode: the not-yet-consumed previous chunk
        self._pending = None

    # ----------------------------------------------------------- device
    def _forward(self, ids, **kw):
        if not self.is_vlm:
            kw.pop("pixel_values", None)
        return self.params(ids, attn_impl=self.attn_impl, compute_dtype=self.compute_dtype,
                           **kw)

    def _init_state(self):
        dev, B = self.device, self.B
        z = torch.zeros((B,), dtype=torch.long, device=dev)
        return {
            "cache": decoder_module(self.dec_cfg).init_kv_cache(
                self.dec_cfg, B, self.smax, dtype=self.cache_dtype, device=dev),
            "kv_valid": torch.zeros((B, self.smax), dtype=torch.int32, device=dev),
            "write_col": z.clone(),   # next cache column per slot
            "pos_next": z.clone(),    # next rope position per slot
            "token": z.clone(),       # last emitted token per slot
            "remaining": z.clone(),   # decode-step budget per slot
            "live": torch.zeros((B,), dtype=torch.bool, device=dev),
        }

    def _prefill_insert(self, req: Request, slot: int) -> int:
        """Prefill ``req`` into ``slot``'s cache columns and arm the slot;
        returns the first token."""
        st, dev = self._state, self.device
        prompt = req.prompt_ids
        sp = _bucket(len(prompt), self.bucket_multiple)
        ids = np.full((1, sp), self.pad_id, np.int64)
        mask = np.zeros((1, sp), np.int32)
        ids[0, sp - len(prompt):] = prompt
        mask[0, sp - len(prompt):] = 1
        ids_t = torch.from_numpy(ids).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        pix = None
        if req.pixel_values is not None:
            pix = torch.from_numpy(np.asarray(req.pixel_values, np.float32)[None]).to(
                dev, self.compute_dtype)
        # the slot's columns 0..sp-1 of every layer, written in place
        slab = {k: st["cache"][k][:, slot:slot + 1, :, :sp] for k in ("k", "v")}
        out = self._forward(ids_t, pixel_values=pix, attention_mask=mask_t, kv_cache=slab,
                            cache_offset=0, kv_valid_mask=mask_t, last_logit_only=True)
        last = out["logits"][0, -1]
        if self.on_prefill is not None:
            self.on_prefill(req, last)
        first = int(torch.argmax(last))
        max_new = req.max_new_tokens
        finished_now = self.eos >= 0 and first == self.eos
        st["kv_valid"][slot].zero_()
        st["kv_valid"][slot, :sp] = mask_t[0]
        st["write_col"][slot] = sp
        st["pos_next"][slot] = len(prompt)
        st["token"][slot] = first
        st["remaining"][slot] = 0 if finished_now else max_new - 1
        st["live"][slot] = (not finished_now) and max_new - 1 > 0
        return first

    def _decode_chunk(self):
        """``chunk`` decode steps for every slot; returns the emitted tokens
        and liveness, both [chunk, B] on the device."""
        st, B, T = self._state, self.B, self.chunk
        dev = self.device
        rows = torch.arange(B, device=dev)
        ones = torch.ones((B, 1), dtype=torch.int32, device=dev)
        emits = torch.empty((T, B), dtype=torch.long, device=dev)
        lives = torch.empty((T, B), dtype=torch.bool, device=dev)
        for t in range(T):
            live = st["live"] & (st["remaining"] > 0)
            cols = st["write_col"]
            st["kv_valid"][rows, cols] = torch.maximum(
                st["kv_valid"][rows, cols], live.to(torch.int32))
            out = self._forward(st["token"][:, None], attention_mask=ones,
                                positions=st["pos_next"][:, None], kv_cache=st["cache"],
                                cache_offset=cols, kv_valid_mask=st["kv_valid"])
            nxt = torch.argmax(out["logits"][:, -1, :], dim=-1)
            emits[t] = torch.where(live, nxt, self.pad_id)
            lives[t] = live
            remaining = torch.where(live, st["remaining"] - 1, st["remaining"])
            still = live & (remaining > 0)
            if self.eos >= 0:
                still &= nxt != self.eos
            step = live.to(torch.long)
            st["write_col"] = cols + step
            st["pos_next"] = st["pos_next"] + step
            st["token"] = torch.where(live, nxt, st["token"])
            st["remaining"] = remaining
            st["live"] = still
        return emits, lives

    def _to_host(self, emits, lives):
        """Start copying a chunk's outputs to the host; returns a callable
        that waits for just that copy (not for work queued after it)."""
        if self.device.type != "cuda":
            return lambda: (emits.numpy(), lives.numpy())
        he = torch.empty(emits.shape, dtype=emits.dtype, pin_memory=True)
        hl = torch.empty(lives.shape, dtype=lives.dtype, pin_memory=True)
        he.copy_(emits, non_blocking=True)
        hl.copy_(lives, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()

        def wait():
            ev.synchronize()
            return he.numpy(), hl.numpy()

        return wait

    @torch.inference_mode()
    def _kill_slot_device(self, slot: int):
        """Flip a slot dead on the device when the host retires its request
        early (stop sequence, cancel)."""
        self._state["live"][slot] = False
        self._state["remaining"][slot] = 0

    # ------------------------------------------------------------- host
    def submit(self, prompt_ids, max_new_tokens: int, pixel_values=None, draft_ref=None,
               sample_seed=None, prefix=None, adapter=None, stop=None) -> Request:
        if draft_ref or prefix is not None or adapter is not None:
            raise NotImplementedError(
                "draft_ref, prefix and adapter need speculation, the prefix cache and "
                "multi-LoRA, which are not ported yet")
        del sample_seed  # greedy decoding only: a sampling seed changes nothing
        if pixel_values is not None and not self.is_vlm:
            raise ValueError("pixel_values given to a text-only model")
        sp = _bucket(len(prompt_ids), self.bucket_multiple)
        if sp + max_new_tokens > self.smax:
            raise ValueError(
                f"prompt bucket {sp} + max_new {max_new_tokens} exceeds max_len {self.smax}")
        self._uid += 1
        req = Request(self._uid, list(prompt_ids), max_new_tokens, pixel_values)
        # stop sequences: token-id lists checked on the emitted stream (the
        # matched suffix is cut away)
        req.stop = [list(int(t) for t in s) for s in (stop or []) if len(s)]
        req.submit_t = time.monotonic()
        self._queue.append(req)
        return req

    def _fill_slots(self):
        while self._free and self._queue:
            req = self._queue.pop(0)
            slot = self._free.pop(0)
            first = self._prefill_insert(req, slot)
            self._after_insert(req, slot, first)

    def _apply_stop(self, req, old_len: int) -> bool:
        """Scan tokens appended since ``old_len`` for a stop sequence (which
        may reach back across the boundary); on a match, cut the stream
        before it."""
        if not req.stop:
            return False
        toks = req.tokens
        for end in range(old_len + 1, len(toks) + 1):
            for s in req.stop:
                n = len(s)
                if end >= n and toks[end - n: end] == s:
                    del toks[end - n:]
                    return True
        return False

    def _retire(self, req, slot: int, reason: str, *, kill_device: bool = False):
        req.done = True
        req.finish_reason = reason
        req.done_t = time.monotonic()
        if self._slot_req[slot] is req:
            self._slot_req[slot] = None
            self._free.append(slot)
            if kill_device:
                self._kill_slot_device(slot)

    def cancel(self, req) -> bool:
        """Abort a request: drop it from the queue, or retire its slot
        (partial tokens stay on the request).  False if already done."""
        if req.done:
            return False
        if req in self._queue:
            self._queue.remove(req)
            req.done = True
            req.finish_reason = "cancel"
            req.done_t = time.monotonic()
            return True
        for slot, r in enumerate(self._slot_req):
            if r is req:
                self._retire(req, slot, "cancel", kill_device=True)
                return True
        return False

    def _after_insert(self, req, slot, first: int):
        self._n_prefill += 1
        now = time.monotonic()
        req.first_t = now
        if self.eos >= 0 and first == self.eos:
            req.done = True
            req.finish_reason = "eos"
            req.done_t = now
            self._free.append(slot)
            return
        req.tokens.append(first)
        if self._apply_stop(req, len(req.tokens) - 1):
            # the insert armed the slot on the device; disarm it
            self._slot_req[slot] = req
            self._retire(req, slot, "stop", kill_device=True)
        elif len(req.tokens) >= req.max_new_tokens:
            req.done = True
            req.finish_reason = "length"
            req.done_t = now
            self._free.append(slot)
        else:
            self._slot_req[slot] = req

    def _consume(self, wait, snapshot):
        """Deliver one chunk's emissions to its dispatch-time slot mapping
        and retire finished requests, from the emission arrays alone (the
        device state may already be a chunk further)."""
        emits, lives = wait()  # [T, B]
        self._n_live_rounds += int(lives.sum())
        for b, req in enumerate(snapshot):
            if req is None or req.done:
                continue
            hit_eos = False
            for t in range(self.chunk):
                if not lives[t, b]:
                    break
                tok = int(emits[t, b])
                if self.eos >= 0 and tok == self.eos:
                    hit_eos = True
                    break
                req.tokens.append(tok)
                self._n_emitted += 1
                if self._apply_stop(req, len(req.tokens) - 1):
                    self._retire(req, b, "stop", kill_device=True)
                    break
            if req.done:
                continue
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                req.finish_reason = "eos" if hit_eos else "length"
                req.done_t = time.monotonic()
                if self._slot_req[b] is req:
                    self._slot_req[b] = None
                    self._free.append(b)

    @torch.inference_mode()
    def step(self):
        """One engine iteration: fill free slots, dispatch one decode chunk,
        deliver the PREVIOUS chunk's tokens (pipelined) or this one's
        (``pipeline=False``)."""
        if self._state is None:
            self._state = self._init_state()
        self._fill_slots()
        prev, self._pending = self._pending, None
        if any(r is not None for r in self._slot_req):
            self._n_dispatch += 1
            snapshot = list(self._slot_req)
            wait = self._to_host(*self._decode_chunk())
            if self.pipeline:
                self._pending = (wait, snapshot)
            else:
                if prev is not None:  # mode flipped mid-flight
                    self._consume(*prev)
                    prev = None
                self._consume(wait, snapshot)
        if prev is not None:
            self._consume(*prev)

    def run(self):
        """Drain the queue and all in-flight slots."""
        while (self._queue or self._pending is not None
               or any(r is not None for r in self._slot_req)):
            self.step()

    def stats(self) -> dict:
        """Engine counters: decode dispatches, prefills, per-slot live
        rounds and emitted tokens."""
        rounds = max(self._n_live_rounds, 1)
        return {
            "dispatches": self._n_dispatch,
            "prefills": self._n_prefill,
            "live_rounds": self._n_live_rounds,
            "emitted": self._n_emitted,
            "tokens_per_round": self._n_emitted / rounds,
        }

    def drain(self, requests: list[Request]) -> list[list[int]]:
        """Run until the given requests complete; return their token lists."""
        while not all(r.done for r in requests):
            self.step()
        return [r.tokens for r in requests]
