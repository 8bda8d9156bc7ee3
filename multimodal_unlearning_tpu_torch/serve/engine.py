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

- int8 KV cache (``cache_dtype=torch.int8``): K/V quantized per position
  and kv-head as they are written, with f32 scales [L, B, Hkv, 1, Smax]
  whose position axis is the LAST one; every column slice goes through
  ``_cols``, which slices each key by its own layout.
- speculation (``speculate_k``): every decode step is a prompt-lookup
  verify round per slot -- a 2-gram match in [draft corpus | history]
  proposes K tokens, one ``chunk_decode`` forward verifies them and 1..K+1
  tokens are emitted.  Proposal and acceptance stay on the device; the
  host reads each chunk's emissions as before.  Output is exactly greedy.
- chunked prefill (``prefill_chunk``): a long prompt prefills one chunk per
  engine step (first chunk as a plain prefill into a slab, then
  ``chunk_decode`` passes extending it, the final right-padded chunk through
  the suffix insert), so live slots keep decoding between chunks.
- prefix cache (``register_prefix``): a shared prefix is prefilled once
  into a slab; a request with ``prefix=<id>`` copies the slab into its
  slot's columns and prefills only its suffix (one ``chunk_decode`` pass).

The JAX engine runs each chunk as one compiled ``lax.scan``; here every
op of every step is launched from Python, so decode is bound by the host
(CUDA graphs are the tool for that, in later work).  Everything runs under
``torch.inference_mode()``.  Eager PyTorch needs no compiled programs, so the
JAX engine's per-shape program caches have no counterpart.
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
    draft_ref: list = field(default_factory=list)  # lookup-corpus seed tokens
    prefix: int | None = None  # registered shared-prefix id (prefix cache)
    tokens: list = field(default_factory=list)
    stop: list = field(default_factory=list)  # token-id stop sequences
    done: bool = False
    finish_reason: str = ""  # "length", "eos", "stop" or "cancel" once done
    submit_t: float = 0.0   # time.monotonic at submit
    first_t: float = 0.0    # first token available (TTFT = first_t - submit_t)
    done_t: float = 0.0     # request completed


def _bucket(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _cols(cache, start: int, stop: int, rows=slice(None)) -> dict:
    """Views of cache columns ``start:stop`` (and batch rows ``rows``) of
    every key: K/V keep positions on axis 3, int8 scales on axis 4."""
    return {name: (t[:, rows, :, start:stop] if name in ("k", "v")
                   else t[:, rows, :, :, start:stop]) for name, t in cache.items()}


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
      cache_dtype: bf16/f32, or ``torch.int8`` for the quantized cache.
      speculate_k: >0 turns every decode step into a prompt-lookup verify
        round of K drafted tokens (1..K+1 tokens per slot per step, exactly
        greedy).
      spec_ref_len: width of the per-slot draft corpus; requests may carry
        ``draft_ref`` tokens (e.g. a cached prior answer) seeding the lookup.
      prefill_chunk: >0 prefills prompts longer than this one chunk per
        engine step (token-identical to a monolithic prefill on a float
        cache).
      device: where the engine runs; the card unless "cpu" is passed.
      on_prefill: optional ``fn(request, last_logits)`` called with each
        prefill's last-position logits [V] (f32, on the device).

    The JAX engine's sampling, multi-LoRA, paged cache, logprobs and mesh
    are not ported: asking for any of them raises ``NotImplementedError``.
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
        # top_k/top_p and kv_pool_pages only shape the options below; the
        # JAX engine ignores them too while those are off
        del top_k, top_p, kv_pool_pages
        unported = {
            "temperature": float(temperature) > 0.0,
            "adapters": bool(adapters),
            "page_size": int(page_size) != 0,
            "logprobs": bool(logprobs),
            "mesh": mesh is not None,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"ServingEngine options not ported yet: {asked} (greedy serving on a dense "
                "cache only)")
        if cache_dtype not in (torch.bfloat16, torch.float16, torch.float32, torch.int8):
            raise NotImplementedError(f"cache_dtype {cache_dtype}: float or int8 only")
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
        self.K = int(speculate_k)
        self.R = int(spec_ref_len) if self.K else 0
        self.prefill_chunk = (
            _bucket(int(prefill_chunk), self.bucket_multiple) if prefill_chunk else 0)
        self._prefill_job: dict | None = None
        self._n_prefill_chunks = 0
        self._prefixes: dict[int, dict] = {}
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
        state = {
            "cache": decoder_module(self.dec_cfg).init_kv_cache(
                self.dec_cfg, B, self.smax, dtype=self.cache_dtype, device=dev),
            "kv_valid": torch.zeros((B, self.smax), dtype=torch.int32, device=dev),
            "write_col": z.clone(),   # next cache column per slot
            "pos_next": z.clone(),    # next rope position per slot
            "token": z.clone(),       # last emitted token per slot
            "remaining": z.clone(),   # decode-step budget per slot
            "live": torch.zeros((B,), dtype=torch.bool, device=dev),
        }
        if self.K:
            # token history + per-slot draft corpus for the 2-gram lookup
            # (-2 marks never-match entries)
            state["ids_buf"] = torch.full((B, self.smax), -2, dtype=torch.long, device=dev)
            state["draft_ref"] = torch.full((B, self.R), -2, dtype=torch.long, device=dev)
        return state

    def _pixels(self, pixel_values):
        """One image [H, W, 3] as a [1, H, W, 3] batch on the device, or None."""
        if pixel_values is None:
            return None
        return torch.from_numpy(np.asarray(pixel_values, np.float32)[None]).to(
            self.device, self.compute_dtype)

    def _first_token(self, req, last) -> int:
        if self.on_prefill is not None:
            self.on_prefill(req, last)
        return int(torch.argmax(last))

    def _arm_slot(self, req, slot: int, first: int, valid_row, write_col: int, pos_next: int,
                  hist=None):
        """Slot state after an insert: validity row (the first n columns),
        next column and position, first token and budget; under speculation
        the token history ``hist`` (first n columns, -2 = no token) and the
        request's draft corpus."""
        st = self._state
        max_new = req.max_new_tokens
        finished_now = self.eos >= 0 and first == self.eos
        n = valid_row.shape[-1]
        st["kv_valid"][slot].zero_()
        st["kv_valid"][slot, :n] = valid_row
        st["write_col"][slot] = write_col
        st["pos_next"][slot] = pos_next
        st["token"][slot] = first
        st["remaining"][slot] = 0 if finished_now else max_new - 1
        st["live"][slot] = (not finished_now) and max_new - 1 > 0
        if self.K:
            st["ids_buf"][slot].fill_(-2)
            st["ids_buf"][slot, :hist.shape[-1]] = hist
            st["draft_ref"][slot].fill_(-2)
            if req.draft_ref:
                st["draft_ref"][slot, :len(req.draft_ref)] = torch.tensor(
                    req.draft_ref, dtype=torch.long, device=self.device)

    def _left_padded(self, prompt):
        """(ids [1, sp], mask [1, sp]) of a prompt left-padded to its bucket."""
        sp = _bucket(len(prompt), self.bucket_multiple)
        ids = np.full((1, sp), self.pad_id, np.int64)
        mask = np.zeros((1, sp), np.int32)
        ids[0, sp - len(prompt):] = prompt
        mask[0, sp - len(prompt):] = 1
        return torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)

    def _prefill_insert(self, req: Request, slot: int) -> int:
        """Prefill ``req`` into ``slot``'s cache columns and arm the slot;
        returns the first token."""
        ids_t, mask_t = self._left_padded(req.prompt_ids)
        sp = ids_t.shape[1]
        # the slot's columns 0..sp-1 of every layer, written in place
        slab = _cols(self._state["cache"], 0, sp, slice(slot, slot + 1))
        out = self._forward(ids_t, pixel_values=self._pixels(req.pixel_values),
                            attention_mask=mask_t, kv_cache=slab, cache_offset=0,
                            kv_valid_mask=mask_t, last_logit_only=True)
        first = self._first_token(req, out["logits"][0, -1])
        hist = torch.where(mask_t[0] > 0, ids_t[0], -2) if self.K else None
        self._arm_slot(req, slot, first, mask_t[0], sp, len(req.prompt_ids), hist)
        return first

    def _prefix_fill(self, slab, ids, mask, pix=None):
        """A standalone prompt forward into ``slab`` (its first columns, at
        offset 0): the prefix cache's and the first prefill chunk's."""
        self._forward(ids, pixel_values=pix, attention_mask=mask, kv_cache=slab,
                      cache_offset=0, kv_valid_mask=mask, last_logit_only=True)

    def _extend(self, slab, P: int, kv_row, plen: int, ids):
        """Chunked prefill: C unpadded prompt tokens run as one chunk_decode
        pass against the first P columns of ``slab`` (seen through
        ``kv_row``) and land at columns P..P+C-1; returns the validity row of
        the P+C columns."""
        C = ids.shape[1]
        dev = self.device
        row = torch.zeros((1, P + C), dtype=torch.int32, device=dev)
        row[:, :P] = kv_row
        self._forward(ids, attention_mask=torch.ones((1, C), dtype=torch.int32, device=dev),
                      positions=plen + torch.arange(C, device=dev)[None],
                      kv_cache=_cols(slab, 0, P + C),
                      cache_offset=torch.full((1,), P, dtype=torch.long, device=dev),
                      kv_valid_mask=row, chunk_decode=True, last_logit_only=True)
        row[:, P:] = 1
        return row

    def _suffix_insert(self, req, slot: int, pslab, pvalid, phist, plen: int, suffix):
        """The P-column slab ``pslab`` lands in ``slot``'s cache columns
        0..P-1; the RIGHT-padded suffix runs as one chunk_decode pass (its
        queries read the prefix through ``pvalid`` plus their own chunk
        columns causally), written at columns P..P+sp-1.  Arms the slot;
        returns the first token."""
        dev = self.device
        P, n_sfx = pvalid.shape[-1], len(suffix)
        sp = _bucket(max(n_sfx, 1), self.bucket_multiple)
        ids = np.full((1, sp), self.pad_id, np.int64)
        ids[0, :n_sfx] = suffix
        ids_t = torch.from_numpy(ids).to(dev)
        slab = _cols(self._state["cache"], 0, P + sp, slice(slot, slot + 1))
        for name, dst in _cols(slab, 0, P).items():
            dst.copy_(pslab[name])
        row = torch.zeros((1, P + sp), dtype=torch.int32, device=dev)
        row[:, :P] = pvalid
        out = self._forward(ids_t, attention_mask=torch.ones((1, sp), dtype=torch.int32,
                                                             device=dev),
                            positions=plen + torch.arange(sp, device=dev)[None], kv_cache=slab,
                            cache_offset=torch.full((1,), P, dtype=torch.long, device=dev),
                            kv_valid_mask=row, chunk_decode=True)
        first = self._first_token(req, out["logits"][0, n_sfx - 1])  # last REAL position
        row[:, P:P + n_sfx] = 1
        hist = None
        if self.K:
            hist = torch.full((P + sp,), -2, dtype=torch.long, device=dev)
            hist[:P] = phist
            hist[P:P + n_sfx] = ids_t[0, :n_sfx]
        self._arm_slot(req, slot, first, row[0], P + n_sfx, plen + n_sfx, hist)
        return first

    # ------------------------------------------------------- prefix cache
    @torch.inference_mode()
    def register_prefix(self, prompt_ids, pixel_values=None, adapter=None) -> int:
        """Prefill a shared prompt prefix (e.g. a system prompt, or an image
        + preamble) ONCE into a reusable KV slab; requests submitted with
        ``prefix=<id>`` prefill only their suffix against it.  The slab is
        copied into the slot's columns at insert: what is saved is the
        recomputation, not cache memory.  Left-padded to its bucket like any
        prompt, so suffix columns continue contiguously."""
        if adapter is not None:
            raise NotImplementedError("prefixes per adapter need multi-LoRA serving, which is "
                                      "not ported yet")
        ids_t, mask_t = self._left_padded(list(prompt_ids))
        P = ids_t.shape[1]
        slab = decoder_module(self.dec_cfg).init_kv_cache(
            self.dec_cfg, 1, P, dtype=self.cache_dtype, device=self.device)
        self._prefix_fill(slab, ids_t, mask_t, self._pixels(pixel_values))
        pid = len(self._prefixes)
        self._prefixes[pid] = dict(slab=slab, mask=mask_t, plen=len(prompt_ids), P=P,
                                   hist=torch.where(mask_t[0] > 0, ids_t[0], -2))
        return pid

    def _fill_with_prefix(self, req, slot):
        """Admit a request against a registered prefix: copy the cached
        slab, prefill only the suffix."""
        pre = self._prefixes[req.prefix]
        first = self._suffix_insert(req, slot, pre["slab"], pre["mask"], pre["hist"],
                                    pre["plen"], req.prompt_ids)
        self._after_insert(req, slot, first)

    # ---------------------------------------------------- chunked prefill
    def _needs_chunked_prefill(self, req) -> bool:
        C = self.prefill_chunk
        if not C or req.prefix is not None or len(req.prompt_ids) <= C:
            return False
        if req.pixel_values is not None:
            # image features splice at image-token positions during the
            # pixel-carrying first chunk: an image span crossing the chunk
            # boundary prefills whole
            tid = getattr(self.model_cfg, "image_token_id", None)
            if tid is None or any(int(t) == tid for t in req.prompt_ids[C:]):
                return False
        return True

    def _start_prefill_job(self, req, slot):
        """First chunk of a chunked prefill: exactly C (unpadded) prompt
        tokens (pixels ride here) into a slab that holds every column the
        prompt will need."""
        C, n = self.prefill_chunk, len(req.prompt_ids)
        n_full = (n - 1) // C  # chunks before the final (<= C) one
        total = n_full * C + _bucket(n - n_full * C, self.bucket_multiple)
        slab = decoder_module(self.dec_cfg).init_kv_cache(
            self.dec_cfg, 1, total, dtype=self.cache_dtype, device=self.device)
        ids = torch.tensor([req.prompt_ids[:C]], dtype=torch.long, device=self.device)
        mask = torch.ones((1, C), dtype=torch.int32, device=self.device)
        self._prefix_fill(_cols(slab, 0, C), ids, mask, self._pixels(req.pixel_values))
        self._n_prefill_chunks += 1
        self._prefill_job = dict(req=req, slot=slot, slab=slab, P=C, pos=C, kv_row=mask)

    def _advance_prefill(self):
        """One more chunk of the in-flight chunked prefill; the final
        (right-padded) chunk lands through the suffix insert, which emits the
        first token and arms the slot."""
        job = self._prefill_job
        req, C = job["req"], self.prefill_chunk
        prompt = req.prompt_ids
        self._n_prefill_chunks += 1
        if len(prompt) - job["pos"] > C:
            ids = torch.tensor([prompt[job["pos"]:job["pos"] + C]], dtype=torch.long,
                               device=self.device)
            job["kv_row"] = self._extend(job["slab"], job["P"], job["kv_row"], job["pos"], ids)
            job["P"] += C
            job["pos"] += C
            return
        self._prefill_job = None
        hist = (torch.tensor(prompt[:job["pos"]], dtype=torch.long, device=self.device)
                if self.K else None)
        first = self._suffix_insert(req, job["slot"], _cols(job["slab"], 0, job["P"]),
                                    job["kv_row"], hist, job["pos"], prompt[job["pos"]:])
        self._after_insert(req, job["slot"], first)

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

    def _propose(self, token, cur):
        """The K tokens that followed the most recent 2-gram match of
        (previous token, ``token``) in [draft corpus | separator | history]
        (the JAX engine's ``propose``): a match whose K followers are all
        known wins over a later partial one; unknown followers are -4,
        which never equals an argmax.  [B, K]."""
        st, B, K, R = self._state, self.B, self.K, self.R
        dev = self.device
        rows = torch.arange(B, device=dev)
        buf = torch.cat([st["draft_ref"], torch.full((B, 1), -5, dtype=torch.long, device=dev),
                         st["ids_buf"]], dim=1)
        W = buf.shape[1]
        prev = st["ids_buf"][rows, torch.clamp(cur - 1, min=0)]
        nxt = torch.cat([buf[:, 1:], torch.full((B, 1), -3, dtype=torch.long, device=dev)], 1)
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

    def _spec_decode_chunk(self):
        """``chunk`` verify rounds for every slot (the JAX engine's
        ``_make_spec_decode``): propose K tokens, verify [token, draft] with
        one chunk_decode forward, accept the matching run.  Returns the
        emitted tokens [chunk, B, K+1], how many of them count [chunk, B]
        and whether the slot finished [chunk, B], on the device."""
        st, B, T, K = self._state, self.B, self.chunk, self.K
        dev = self.device
        rows = torch.arange(B, device=dev)
        ar = torch.arange(K + 1, device=dev)
        ones = torch.ones((B, K + 1), dtype=torch.int32, device=dev)
        vocab = self.dec_cfg.vocab_size
        emits = torch.empty((T, B, K + 1), dtype=torch.long, device=dev)
        n_emits = torch.empty((T, B), dtype=torch.long, device=dev)
        dones = torch.empty((T, B), dtype=torch.bool, device=dev)
        for t in range(T):
            live = st["live"] & (st["remaining"] > 0)
            cur, pos, token = st["write_col"], st["pos_next"], st["token"]
            draft = self._propose(token, cur)
            chunk = torch.cat([token[:, None], draft], dim=1)
            # retired slots still run the forward: clamp their stale write
            # columns so the K+1-wide per-row write stays in bounds (live rows
            # satisfy cur + K < smax by the submit check)
            cur_w = torch.clamp(cur, max=self.smax - (K + 1))
            out = self._forward(torch.clamp(chunk, 0, vocab - 1), attention_mask=ones,
                                positions=pos[:, None] + ar[None, :], kv_cache=st["cache"],
                                cache_offset=cur_w, kv_valid_mask=st["kv_valid"],
                                chunk_decode=True)
            preds = torch.argmax(out["logits"], dim=-1)  # [B, K+1]
            a = torch.cumprod((draft == preds[:, :K]).long(), dim=1).sum(dim=1)  # accepted 0..K
            n_emit = a + 1
            if self.eos >= 0:
                eos_idx = torch.where(preds == self.eos, ar[None, :], K + 1).amin(dim=1)
                n_emit = torch.minimum(n_emit, eos_idx)  # eos is not emitted
                hit_eos = eos_idx <= a
            else:
                hit_eos = torch.zeros_like(live)
            n_emit = torch.where(live, torch.minimum(n_emit, st["remaining"]), 0)
            emits[t] = torch.where(ar[None, :] < n_emit[:, None], preds, self.pad_id)
            n_emits[t] = n_emit
            # the accepted context tokens chunk[0..a] extend history and validity
            acc = (ar[None, :] <= a[:, None]) & live[:, None]
            cols = torch.where(acc, cur_w[:, None] + ar[None, :], self.smax - 1)
            st["ids_buf"][rows[:, None], cols] = torch.where(
                acc, chunk, st["ids_buf"][rows[:, None], cols])
            st["kv_valid"][rows[:, None], cols] = torch.maximum(
                st["kv_valid"][rows[:, None], cols], acc.to(torch.int32))
            remaining = st["remaining"] - n_emit
            done = live & (hit_eos | (remaining <= 0))
            dones[t] = done
            adv = torch.where(live, a + 1, 0)
            st["write_col"] = cur + adv
            st["pos_next"] = pos + adv
            st["token"] = torch.where(live, preds[rows, a], token)
            st["remaining"] = remaining
            st["live"] = live & ~done
        return emits, n_emits, dones

    def _to_host(self, *tensors):
        """Start copying a chunk's outputs to the host; returns a callable
        that waits for just that copy (not for work queued after it)."""
        if self.device.type != "cuda":
            return lambda: tuple(t.numpy() for t in tensors)
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()

        def wait():
            ev.synchronize()
            return tuple(h.numpy() for h in hosts)

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
        if adapter is not None:
            raise NotImplementedError("adapter needs multi-LoRA serving, which is not ported yet")
        del sample_seed  # greedy decoding only: a sampling seed changes nothing
        if pixel_values is not None and not self.is_vlm:
            raise ValueError("pixel_values given to a text-only model")
        sp = _bucket(len(prompt_ids), self.bucket_multiple)
        if prefix is not None:
            if not len(prompt_ids):
                raise ValueError("prefix requests need >= 1 suffix token")
            sp += self._prefixes[prefix]["P"]
        slack = self.K + 1 if self.K else 0  # the verify chunk writes K past cur
        if sp + max_new_tokens + slack > self.smax:
            raise ValueError(
                f"prompt bucket {sp} + max_new {max_new_tokens} (+ speculative slack {slack}) "
                f"exceeds max_len {self.smax}")
        self._uid += 1
        req = Request(self._uid, list(prompt_ids), max_new_tokens, pixel_values)
        req.prefix = prefix
        req.draft_ref = list(draft_ref or [])[: self.R]
        # stop sequences: token-id lists checked on the emitted stream (the
        # matched suffix is cut away)
        req.stop = [list(int(t) for t in s) for s in (stop or []) if len(s)]
        req.submit_t = time.monotonic()
        self._queue.append(req)
        return req

    def _fill_slots(self):
        if self._prefill_job is not None:
            self._advance_prefill()
        while self._free and self._queue:
            # strict FIFO: a long prompt at the head waits for the active
            # chunked prefill rather than being overtaken
            if self._needs_chunked_prefill(self._queue[0]):
                if self._prefill_job is not None:
                    break
                self._start_prefill_job(self._queue.pop(0), self._free.pop(0))
                continue
            req = self._queue.pop(0)
            slot = self._free.pop(0)
            if req.prefix is not None:
                self._fill_with_prefix(req, slot)
                continue
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
        if self._prefill_job is not None and self._prefill_job["req"] is req:
            job, self._prefill_job = self._prefill_job, None
            req.done = True
            req.finish_reason = "cancel"
            req.done_t = time.monotonic()
            self._free.append(job["slot"])
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

    def _free_done(self, req, b: int, reason: str):
        req.done = True
        req.finish_reason = reason
        req.done_t = time.monotonic()
        if self._slot_req[b] is req:
            self._slot_req[b] = None
            self._free.append(b)

    def _consume(self, wait, snapshot):
        """Deliver one chunk's emissions to its dispatch-time slot mapping
        and retire finished requests, from the emission arrays alone (the
        device state may already be a chunk further)."""
        if self.K:
            return self._consume_spec(wait, snapshot)
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
                self._free_done(req, b, "eos" if hit_eos else "length")

    def _consume_spec(self, wait, snapshot):
        """Speculative delivery: round t emitted ``n_emits[t, b]`` verified
        tokens for slot b (an eos is never emitted); ``dones`` marks the
        eos or budget retirement decided on the device, which the host
        replays."""
        emits, n_emits, dones = wait()  # [T, B, K+1], [T, B], [T, B]
        self._n_live_rounds += int((n_emits > 0).sum())
        for b, req in enumerate(snapshot):
            if req is None or req.done:
                continue
            for t in range(self.chunk):
                old = len(req.tokens)
                req.tokens.extend(int(x) for x in emits[t, b, :n_emits[t, b]])
                self._n_emitted += int(n_emits[t, b])
                if self._apply_stop(req, old):
                    self._retire(req, b, "stop", kill_device=True)
                    break
                if dones[t, b]:
                    self._free_done(req, b, "length" if len(req.tokens) >= req.max_new_tokens
                                    else "eos")
                    break

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
            wait = self._to_host(*(self._spec_decode_chunk() if self.K
                                   else self._decode_chunk()))
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
        while (self._queue or self._pending is not None or self._prefill_job is not None
               or any(r is not None for r in self._slot_req)):
            self.step()

    def stats(self) -> dict:
        """Engine counters: decode dispatches, prefills, chunked-prefill
        chunks, per-slot live rounds and emitted tokens.
        ``tokens_per_round`` is 1.0 for plain greedy decoding and up to K+1
        under speculation (the measured acceptance)."""
        rounds = max(self._n_live_rounds, 1)
        return {
            "dispatches": self._n_dispatch,
            "prefills": self._n_prefill,
            "prefill_chunks": self._n_prefill_chunks,
            "live_rounds": self._n_live_rounds,
            "emitted": self._n_emitted,
            "tokens_per_round": self._n_emitted / rounds,
        }

    def drain(self, requests: list[Request]) -> list[list[int]]:
        """Run until the given requests complete; return their token lists."""
        while not all(r.done for r in requests):
            self.step()
        return [r.tokens for r in requests]
