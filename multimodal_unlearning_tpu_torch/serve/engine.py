"""Continuous-batching serving engine, dense or paged KV cache, in PyTorch.

Counterpart of ``multimodal_unlearning_tpu/serve/engine.py`` with the same
host semantics: a fixed pool of decode slots, each at its own sequence
position, refilled from the queue between decode chunks.

- prefill + insert: a request's prompt, left-padded to its bucket, runs
  through the model straight into its slot's columns of the stacked
  [L, B, Hkv, Smax, D] cache (a view of the slot's slab); the first token
  is the argmax of the last position (or sampled from it).
- decode chunk: ``chunk`` single-token steps for ALL slots at once.  Every
  slot sits at its own cache column (per-row cache write) and reads the
  cache through its [B, Smax] validity row, so idle slots (all-zero rows)
  decode too and their output is thrown away.  The host knows, without
  waiting on the device, the furthest column each slot can have reached
  (its write column at insert plus its budget): the decode chunk hands
  attention the validity rows narrowed to that extent, so the one-token
  kernel never walks the columns past it.
- Qwen2-VL's M-RoPE: a prompt's forward computes its [3, 1, S] positions
  and its ``rope_delta`` (text after an image continues at the image's
  extent, not at the token count); the engine folds the delta into every
  position it computes later: the slot's ``pos_next`` at insert, a
  registered prefix's suffix positions, and the chunked-prefill passes
  after the first chunk (which holds the image).  A preempted request is
  recomputed from its prompt, delta and all.
- the per-slot state (``kv_valid``, ``write_col``, ``pos_next``,
  ``token``, ``remaining``, ``live``; sampled: ``key``, ``out_idx``) lives
  on the device and is updated in place; the host reads only each chunk's
  emitted tokens (and their logprobs).  In pipelined
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
- sampled decoding (``temperature`` > 0, ``top_k``, ``top_p``;
  ``evaluation/sampling.py``): a request seeded s draws its token i with
  the key ``fold_in(fold_in(key0, s), i)``, so its stream equals its solo
  ``greedy_generate(do_sample=True)`` stream wherever it is placed.  The
  first token (at insert) takes i = ``len(req.tokens)``: 0 for a new
  request, and for one re-admitted after a preemption the index where its
  stream stopped.  (The JAX engine restarts at 0 there and repeats indices:
  ROADMAP queue 2.)  A decode chunk folds its T steps' keys at once, since
  a live row's index at step t is its index at the chunk's start plus t.
- multi-LoRA (``adapters``): the adapters are stacked into one bank
  (``models/lora.stack_adapters``, slot 0 the zero adapter, i.e. the base
  model) and each request picks one (``submit(adapter=)``).  An insert runs
  its one row through its adapter (none for the base); a decode chunk
  gathers its slots' adapters from the bank once, when the slots' adapters
  changed, and every projection applies them per row
  (``models/llama.PER_ROW``).  A registered prefix is prefilled through
  the adapter it names, and only requests on that adapter use it.
- logprobs: each emitted token's raw ``log_softmax`` (f32) of the model's
  logits, whatever the sampling settings, aligned with ``Request.tokens``
  on every route and cut with them at a stop sequence.
- paged cache (``page_size``, ``kv_pool_pages``): one pool of fixed-size
  pages [L, Hkv, NP, P, D] shared by all slots plus a host-managed block
  table [B, MP] per slot, as the JAX engine keeps it.  Page 0 is a trash
  page that retired slots' rows point at.  Admission waits (FIFO) on the
  page free list for a request's prompt pages plus a growth margin; before
  every dispatch each live slot's table is grown to cover what the next two
  chunks can write, and under pool pressure the youngest slot is preempted
  and later recomputed from its prompt and the tokens it already has.  A
  prefill runs into a contiguous slab whose pages are then scattered into
  the slot's pages; a registered prefix is written once into shared pages
  that every slot's table points at (no copy), so prefix requests and
  chunked-prefill passes run their ``chunk_decode`` forward against the
  pool itself.  The table lives on the device and is uploaded (into a new
  buffer, so a chunk already queued keeps the one it was given) only when
  it changed.  Streams equal the dense engine's on float caches.

The JAX engine runs each chunk as one compiled ``lax.scan``; here every
op of every step is launched from Python, so decode is bound by the host
(CUDA graphs are the tool for that, in later work).  Everything runs under
``torch.inference_mode()``.  Eager PyTorch needs no compiled programs, so the
JAX engine's per-shape program caches have no counterpart.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.evaluation import sampling
from multimodal_unlearning_tpu_torch.models import decoder_module
from multimodal_unlearning_tpu_torch.models.llama import PER_ROW
from multimodal_unlearning_tpu_torch.models.lora import stack_adapters
from multimodal_unlearning_tpu_torch.speculative import (
    accept_round, propose_drafts, token_logprobs)
from multimodal_unlearning_tpu_torch.utils.pytree import tree_map


@dataclass
class Request:
    """One generation request: prompt token ids -> generated token ids."""

    uid: int
    prompt_ids: list
    max_new_tokens: int
    pixel_values: np.ndarray | None = None
    draft_ref: list = field(default_factory=list)  # lookup-corpus seed tokens
    sample_seed: int = 0  # stream seed under sampled decoding
    prefix: int | None = None  # registered shared-prefix id (prefix cache)
    lora_id: int = 0  # adapter index under multi-LoRA serving (0 = base)
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)  # per emitted token (opt-in)
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
      params: the model (``models.llama.Llama``, ``models.llava.Llava`` or
        ``models.qwen2_vl.QwenVL``).
      model_cfg / kind: its config and registry kind ("llama", "llava" or
        "qwen2_vl").
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
      page_size: >0 switches the KV cache to a paged pool of pages of this
        many columns (a divisor or a multiple of 128).
      kv_pool_pages: the pool's size in pages, page 0 (the trash page)
        included; default ``num_slots * max_len / page_size + 1``, the dense
        layout's capacity.  Set lower to cap KV memory: admission then
        queues, and slots are preempted and recomputed under pressure.
      temperature / top_k / top_p: temperature > 0 samples (per-request
        ``sample_seed``, by default the request's uid); speculation verifies
        against the argmax, so the two together raise ValueError.
      adapters: ``{name: (adapter_tree, scale)}`` served from one bank;
        requests pick theirs by name (``submit(adapter=)``).
      logprobs: attach each emitted token's raw ``log_softmax`` to its
        request (``Request.logprobs``, aligned with ``tokens``).
      device: where the engine runs; the card unless "cpu" is passed.
      on_prefill: optional ``fn(request, last_logits)`` called with each
        prefill's last-position logits [V] (f32, on the device).

    The JAX engine's ``mesh`` (tensor-parallel serving) is not ported: it
    raises ``NotImplementedError``.
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
        if mesh is not None:
            raise NotImplementedError("ServingEngine option not ported yet: mesh (serving on "
                                      "one device only)")
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
        self.is_vlm = kind in ("llava", "qwen2_vl") or hasattr(model_cfg, "decoder")
        self.dec_cfg = model_cfg.decoder if self.is_vlm else model_cfg
        decoder_module(self.dec_cfg)  # raises for a family the port lacks
        self.B = num_slots
        self.smax = _bucket(max_len, 128)
        self.chunk = chunk
        self.bucket_multiple = bucket_multiple
        # paged KV cache: pool + host-managed block table; the bucket and
        # smax round to page multiples so every slab boundary is page-aligned
        self.page = int(page_size)
        if self.page:
            if self.page < 0 or not (128 % self.page == 0 or self.page % 128 == 0):
                raise ValueError(f"page_size {self.page} must divide or be a multiple of 128")
            self.bucket_multiple = math.lcm(bucket_multiple, self.page)
            self.smax = _bucket(max_len, math.lcm(128, self.page))
            self.MP = self.smax // self.page
            self.NP = int(kv_pool_pages or self.B * self.MP + 1)
            self._free_pages = list(range(1, self.NP))  # page 0: the trash page
            self._table = np.zeros((self.B, self.MP), np.int32)
            self._table_dev = None  # the device copy; None once the host table changed
            self._slot_pages: list[list[int]] = [[] for _ in range(self.B)]
            self._peak_pages = 0
            # per live slot {base, admit_toks, n_prefix, seq} (None = idle):
            # what _ensure_page_coverage grows the slot's pages from
            self._pmeta: list[dict | None] = [None] * self.B
            self._admit_seq = 0
            self._n_preempt = 0
            self._n_table_uploads = 0
        self.pad_id = pad_token_id
        self.eos = -1 if eos_token_id is None else eos_token_id
        self.cache_dtype = cache_dtype
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.K = int(speculate_k)
        self.R = int(spec_ref_len) if self.K else 0
        self.want_lp = bool(logprobs)
        self.do_sample = float(temperature) > 0.0
        self.temperature, self.top_k, self.top_p = float(temperature), int(top_k), float(top_p)
        if self.do_sample and self.K:
            raise ValueError("speculate_k verifies against greedy argmax; use temperature=0 "
                             "with speculation")
        # multi-LoRA: one bank in the compute dtype, index 0 the zero adapter
        self._adapter_ids = {None: 0}
        self._lora = None
        if adapters:
            trees, scales = [], []
            for i, (name, (tree, scale)) in enumerate(adapters.items()):
                self._adapter_ids[name] = i + 1
                trees.append(tree)
                scales.append(float(scale))
            zero = tree_map(torch.zeros_like, trees[0])
            self._lora = tree_map(lambda x: x.to(self.device, compute_dtype),
                                  stack_adapters([zero] + trees, [0.0] + scales))
        # per slot: the adapter its request runs (host copy); the decode
        # chunks' per-row gather of the bank, kept while it is unchanged
        self._slot_lora = [0] * num_slots
        self._rows_lora = None
        self.prefill_chunk = (
            _bucket(int(prefill_chunk), self.bucket_multiple) if prefill_chunk else 0)
        self._prefill_job: dict | None = None
        self._n_prefill_chunks = 0
        self._prefixes: dict[int, dict] = {}
        self.pipeline = pipeline
        self.on_prefill = on_prefill
        self._queue: list[Request] = []
        self._slot_req: list[Request | None] = [None] * self.B
        # per slot: a column past every valid column its kv_valid row can
        # hold until it is armed again (set at insert)
        self._col_cap = [0] * self.B
        self._free = list(range(self.B))
        self._uid = 0
        self._state = None
        self._n_dispatch = 0
        self._n_prefill = 0
        self._n_live_rounds = 0
        self._n_emitted = 0
        # pipelined mode: the not-yet-consumed previous chunk
        self._pending = None

    # ----------------------------------------------------------- paging
    def _eff_prompt(self, req) -> list:
        """The prompt to (re)prefill: the original prompt plus any tokens
        already generated (a queued request with tokens was preempted and
        resumes by recomputing its KV from its whole history)."""
        return req.prompt_ids + req.tokens if req.tokens else req.prompt_ids

    def _pages_for(self, cols: int) -> int:
        return -(-cols // self.page)

    def _own_bucket(self, req) -> int:
        """Bucketed columns of the request's OWN prefill region (for a prefix
        request its suffix: the prefix's pages are shared)."""
        return _bucket(max(len(self._eff_prompt(req)), 1), self.bucket_multiple)

    def _own_pages_needed(self, req) -> int:
        """The most pages the request's own region can ever span: prompt
        bucket + what is left of its budget + the speculative slack.  The
        submit-time ceiling check and the chunked-prefill reservation use
        it; admission reserves only ``_initial_own_pages``."""
        slack = self.K + 1 if self.K else 0
        return self._pages_for(self._own_bucket(req) + req.max_new_tokens - len(req.tokens)
                               + slack)

    def _initial_own_pages(self, req) -> int:
        """Pages reserved at admission: the prompt bucket plus one growth
        margin, not the whole budget (decode pages come on demand)."""
        return min(self._pages_for(self._own_bucket(req) + self._growth_margin()),
                   self._own_pages_needed(req))

    def _growth_margin(self) -> int:
        """Columns a live slot can advance before the host next grows its
        table: two dispatches' worth (pipelining delivers tokens one chunk
        late) of up to K+1 columns a round, plus the verify chunk's K+1
        overhang past its write column."""
        tpr = self.K + 1 if self.K else 1
        return 2 * self.chunk * tpr + tpr

    def _need_own_pages(self, slot: int) -> int:
        """Own pages ``slot`` must hold before the next dispatch."""
        meta, req = self._pmeta[slot], self._slot_req[slot]
        grown = len(req.tokens) - meta["admit_toks"]
        slack = self.K + 1 if self.K else 0
        cap = meta["base"] + req.max_new_tokens - meta["admit_toks"] + slack
        return self._pages_for(min(meta["base"] + grown + self._growth_margin(), cap))

    def _set_pmeta(self, slot: int, req, base: int, n_prefix: int):
        self._admit_seq += 1
        self._pmeta[slot] = dict(base=base, admit_toks=len(req.tokens), n_prefix=n_prefix,
                                 seq=self._admit_seq)

    def _admit_pages(self, req, slot: int, base: int, prefix_pages=()) -> list[int]:
        """Reserve the initial own pages of a request admitted into ``slot``
        whose own region starts with ``base`` prefill columns, behind the
        shared ``prefix_pages``; returns the own pages."""
        own = self._alloc_pages(self._initial_own_pages(req))
        self._assign_pages(slot, own, prefix_pages)
        self._set_pmeta(slot, req, base, len(prefix_pages))
        return own

    def _alloc_pages(self, n: int) -> list[int]:
        ids, self._free_pages = self._free_pages[:n], self._free_pages[n:]
        if len(ids) != n:
            raise RuntimeError("paged pool: admission must wait on the free list")
        self._peak_pages = max(self._peak_pages, self.NP - 1 - len(self._free_pages))
        return ids

    def _assign_pages(self, slot: int, own: list[int], prefix_pages=()):
        self._slot_pages[slot] = list(own)
        ids = list(prefix_pages) + list(own)
        self._table[slot] = 0
        self._table[slot, :len(ids)] = ids
        self._table_dev = None

    def _append_pages(self, slot: int, new: list[int]):
        start = self._pmeta[slot]["n_prefix"] + len(self._slot_pages[slot])
        self._slot_pages[slot].extend(new)
        self._table[slot, start:start + len(new)] = new
        self._table_dev = None

    def _release_slot_pages(self, slot: int):
        """Free a retired slot's own pages (a prefix's shared pages are never
        freed) and point its table row at the trash page, so the garbage
        writes of later chunks for the dead row land nowhere live.  A chunk
        already queued keeps its old table, but the device runs it before
        any insert that could refill the freed pages."""
        if not self.page:
            return
        self._free_pages.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._pmeta[slot] = None
        self._table[slot] = 0
        self._table_dev = None

    def _release_slot(self, slot: int):
        self._release_slot_pages(slot)
        self._slot_lora[slot] = 0  # an idle row needs no adapter
        self._free.append(slot)

    def _preempt_slot(self, slot: int):
        """Evict a live slot under pool pressure: free its pages, flip it
        dead on the device and requeue its request at the FRONT with its
        tokens kept; re-admission prefills prompt + tokens again and goes on
        with the rest of the budget (recompute preemption)."""
        req = self._slot_req[slot]
        self._n_preempt += 1
        self._slot_req[slot] = None
        self._release_slot(slot)
        self._kill_slot_device(slot)
        self._queue.insert(0, req)

    def _preempt_prefill_job(self):
        """Abort the chunked-prefill job under pool pressure: free its
        reserved pages and requeue its request at the front (its prefill
        starts again on re-admission)."""
        job, self._prefill_job = self._prefill_job, None
        self._n_preempt += 1
        self._free_pages.extend(job["pages"])
        self._free.append(job["slot"])
        self._queue.insert(0, job["req"])

    def _ensure_page_coverage(self):
        """Grow every live slot's table to cover the columns the next
        dispatch can write: a column whose entry were still 0 would send the
        token's KV to the trash page and corrupt the stream.  Oldest slots
        grow first; when the free list cannot cover a growth, the youngest
        other slot is preempted (then the chunked-prefill job) until it can.
        The submit-time ceiling check guarantees that a lone slot fits."""
        if not self.page:
            return
        order = sorted((s for s in range(self.B)
                        if self._slot_req[s] is not None and self._pmeta[s] is not None),
                       key=lambda s: self._pmeta[s]["seq"])
        for slot in order:
            if self._slot_req[slot] is None:  # preempted earlier in this pass
                continue
            while True:
                delta = self._need_own_pages(slot) - len(self._slot_pages[slot])
                if delta <= 0:
                    break
                if delta <= len(self._free_pages):
                    self._append_pages(slot, self._alloc_pages(delta))
                    break
                victims = [s for s in order if self._slot_req[s] is not None and s != slot]
                if victims:
                    self._preempt_slot(max(victims, key=lambda s: self._pmeta[s]["seq"]))
                elif self._prefill_job is not None:
                    self._preempt_prefill_job()
                else:
                    raise RuntimeError(
                        f"paged pool invariant broken: slot {slot} needs {delta} more pages, "
                        f"{len(self._free_pages)} free, nothing left to preempt")

    def _table_device(self):
        """The block table on the device, uploaded into a new buffer when the
        host table changed (a chunk already queued still reads its own)."""
        if self._table_dev is None:
            t = torch.from_numpy(self._table.copy())
            if self.device.type == "cuda":  # from pinned memory: no wait on the queue
                t = t.pin_memory().to(self.device, non_blocking=True)
            self._table_dev = t
            self._n_table_uploads += 1
        return self._table_dev

    def _row_table(self, row) -> torch.Tensor:
        """One table row [MP] as a [1, MP] int32 table on the device."""
        return torch.from_numpy(np.asarray(row, np.int32).reshape(1, -1).copy()).to(self.device)

    def _pool(self, table) -> dict:
        """The pool with a block ``table``: the cache a paged forward takes."""
        return dict(self._state["cache"], table=table)

    def _scatter_pages(self, slab, page_ids):
        """A one-row [L, 1, Hkv, n*P, D] slab's columns into pool pages
        ``page_ids`` (n of them; page-aligned buckets guarantee the
        length), one indexed assignment per tensor."""
        pool, P, n = self._state["cache"], self.page, len(page_ids)
        ids = torch.tensor(page_ids, dtype=torch.long, device=self.device)
        for name, t in pool.items():
            if name in ("k", "v"):
                L, _, H, _, D = slab[name].shape
                t[:, :, ids] = slab[name][:, 0, :, :n * P].reshape(L, H, n, P, D)
            else:  # scales [L, 1, Hkv, 1, S] -> [L, Hkv, n, 1, P]
                L, _, H = slab[name].shape[:3]
                t[:, :, ids] = slab[name][:, 0, :, 0, :n * P].reshape(L, H, n, 1, P)

    # ----------------------------------------------------------- device
    def _forward(self, ids, **kw):
        if not self.is_vlm:
            kw.pop("pixel_values", None)
        return self.params(ids, attn_impl=self.attn_impl, compute_dtype=self.compute_dtype,
                           **kw)

    def _lora_kw(self, lora_id: int) -> dict:
        """A one-row forward's LoRA arguments: the bank with its row's
        adapter, or none for the base model."""
        if not lora_id:
            return {}
        return dict(lora=self._lora, lora_scale=1.0,
                    lora_ids=torch.full((1,), lora_id, dtype=torch.long, device=self.device))

    def _rows_lora_kw(self) -> dict:
        """A decode chunk's LoRA arguments: the bank's decoder leaves
        gathered once per row (``PER_ROW``) by the slots' adapters, kept
        while those stay the same; none while every slot runs the base."""
        ids = tuple(self._slot_lora)
        if self._lora is None or not any(ids):
            return {}
        if self._rows_lora is None or self._rows_lora[0] != ids:
            idx = torch.tensor(ids, dtype=torch.long)
            if self.device.type == "cuda":  # from pinned memory: no wait on the queue
                idx = idx.pin_memory().to(self.device, non_blocking=True)
            dec = self._lora["language_model"] if self.is_vlm else self._lora
            # stacked layer leaves [L, A, in, r] gather on axis 1, flat ones on 0
            rows = tree_map(lambda x: x.index_select(1 if x.ndim == 4 else 0, idx), dec)
            self._rows_lora = (ids, {"language_model": rows} if self.is_vlm else rows)
        return dict(lora=self._rows_lora[1], lora_scale=1.0, lora_ids=PER_ROW)

    @staticmethod
    def _rope_delta(out) -> int:
        """A one-row prompt forward's M-RoPE delta (Qwen2-VL), else 0."""
        delta = out.get("rope_delta")
        return 0 if delta is None else int(delta[0])

    def _new_slab(self, n: int) -> dict:
        """A fresh one-row [L, 1, Hkv, n, D] cache of the engine's dtype."""
        return decoder_module(self.dec_cfg).init_kv_cache(
            self.dec_cfg, 1, n, dtype=self.cache_dtype, device=self.device)

    def _init_state(self):
        dev, B = self.device, self.B
        z = torch.zeros((B,), dtype=torch.long, device=dev)
        dec = decoder_module(self.dec_cfg)
        state = {
            "cache": (dec.init_paged_kv_cache(self.dec_cfg, self.NP, self.page,
                                              dtype=self.cache_dtype, device=dev)
                      if self.page else
                      dec.init_kv_cache(self.dec_cfg, B, self.smax, dtype=self.cache_dtype,
                                        device=dev)),
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
        if self.do_sample:
            state["key"] = torch.zeros((B, 2), dtype=torch.long, device=dev)  # stream key
            state["out_idx"] = z.clone()  # next output index (the fold index)
        return state

    def _pixels(self, pixel_values):
        """One image [H, W, 3] as a [1, H, W, 3] batch on the device, or None."""
        if pixel_values is None:
            return None
        return torch.from_numpy(np.asarray(pixel_values, np.float32)[None]).to(
            self.device, self.compute_dtype)

    def _first_token(self, req, slot: int, last):
        """The token an insert emits from the prompt's last logits [V] and
        its logprob (None unless asked for).  Sampled: the slot takes the
        request's stream key, and the token's fold index is
        ``len(req.tokens)``, so a re-admitted request goes on with its
        stream."""
        if self.on_prefill is not None:
            self.on_prefill(req, last)
        if self.do_sample:
            st, dev, i = self._state, self.device, len(req.tokens)
            st["key"][slot] = sampling.row_keys(
                torch.full((1,), req.sample_seed, dtype=torch.long, device=dev))[0]
            st["out_idx"][slot] = i + 1
            tok = sampling.sample_token(
                st["key"][slot:slot + 1], torch.full((1,), i, dtype=torch.long, device=dev),
                last[None], self.temperature, self.top_k, self.top_p)[0]
        else:
            tok = torch.argmax(last)
        lp = float(token_logprobs(last, tok)) if self.want_lp else None
        return int(tok), lp

    def _arm_slot(self, req, slot: int, first: int, valid_row, write_col: int, pos_next: int,
                  hist=None):
        """Slot state after an insert: validity row (the first n columns),
        next column and position, first token and budget (what is left of it
        for a preempted request); under speculation the token history
        ``hist`` (first n columns, -2 = no token) and the request's draft
        corpus."""
        st = self._state
        max_new = req.max_new_tokens - len(req.tokens)
        finished_now = self.eos >= 0 and first == self.eos
        n = valid_row.shape[-1]
        st["kv_valid"][slot].zero_()
        st["kv_valid"][slot, :n] = valid_row
        # decoding validates one column a live step from write_col on, at
        # most max_new - 1 of them; a verify round at most K + 1 past it
        self._col_cap[slot] = max(n, write_col + max_new + (self.K + 1 if self.K else 0))
        st["write_col"][slot] = write_col
        st["pos_next"][slot] = pos_next
        st["token"][slot] = first
        st["remaining"][slot] = 0 if finished_now else max_new - 1
        st["live"][slot] = (not finished_now) and max_new - 1 > 0
        self._slot_lora[slot] = req.lora_id
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

    def _prefill_insert(self, req: Request, slot: int):
        """Prefill ``req`` into ``slot``'s cache columns and arm the slot;
        returns the first token and its logprob.  Paged: into a slab, whose
        pages then land in the slot's own pages."""
        prompt = self._eff_prompt(req)
        ids_t, mask_t = self._left_padded(prompt)
        sp = ids_t.shape[1]
        if self.page:
            own = self._admit_pages(req, slot, sp)
            slab = self._new_slab(sp)
        else:
            # the slot's columns 0..sp-1 of every layer, written in place
            slab = _cols(self._state["cache"], 0, sp, slice(slot, slot + 1))
        out = self._forward(ids_t, pixel_values=self._pixels(req.pixel_values),
                            attention_mask=mask_t, kv_cache=slab, cache_offset=0,
                            kv_valid_mask=mask_t, last_logit_only=True,
                            **self._lora_kw(req.lora_id))
        if self.page:
            self._scatter_pages(slab, own[: sp // self.page])
        first, lp = self._first_token(req, slot, out["logits"][0, -1])
        hist = torch.where(mask_t[0] > 0, ids_t[0], -2) if self.K else None
        self._arm_slot(req, slot, first, mask_t[0], sp, len(prompt) + self._rope_delta(out),
                       hist)
        return first, lp

    def _prefix_fill(self, slab, ids, mask, pix=None, lora_id: int = 0):
        """A standalone prompt forward into ``slab`` (its first columns, at
        offset 0) through adapter ``lora_id``: the prefix cache's and the
        first prefill chunk's.  Returns its M-RoPE delta (0 but on
        Qwen2-VL)."""
        return self._rope_delta(self._forward(
            ids, pixel_values=pix, attention_mask=mask, kv_cache=slab, cache_offset=0,
            kv_valid_mask=mask, last_logit_only=True, **self._lora_kw(lora_id)))

    def _extend(self, slab, P: int, kv_row, plen: int, ids, table=None, lora_id: int = 0):
        """Chunked prefill: C unpadded prompt tokens run as one chunk_decode
        pass against the first P columns of ``slab`` (seen through
        ``kv_row``) and land at columns P..P+C-1; returns the validity row of
        the P+C columns.  Paged: against the pool through the one-row block
        ``table`` instead of a slab; the row is then [1, smax] wide."""
        C = ids.shape[1]
        dev = self.device
        row = torch.zeros((1, self.smax if table is not None else P + C), dtype=torch.int32,
                          device=dev)
        row[:, :P] = kv_row[:, :P]
        cache = self._pool(table) if table is not None else _cols(slab, 0, P + C)
        self._forward(ids, attention_mask=torch.ones((1, C), dtype=torch.int32, device=dev),
                      positions=plen + torch.arange(C, device=dev)[None], kv_cache=cache,
                      cache_offset=torch.full((1,), P, dtype=torch.long, device=dev),
                      kv_valid_mask=row, chunk_decode=True, last_logit_only=True,
                      **self._lora_kw(lora_id))
        row[:, P:P + C] = 1
        return row

    def _suffix_insert(self, req, slot: int, pslab, pvalid, phist, plen: int, suffix,
                       table=None):
        """The P-column slab ``pslab`` lands in ``slot``'s cache columns
        0..P-1; the RIGHT-padded suffix runs at positions ``plen`` on (the
        prefix's rope delta folded in) as one chunk_decode pass (its
        queries read the prefix through ``pvalid`` plus their own chunk
        columns causally), written at columns P..P+sp-1.  Arms the slot;
        returns the first token and its logprob.  Paged: the prefix's columns are already in
        the pool, where the one-row block ``table`` (the slot's row) points;
        the pass reads and writes the pool through it and ``pslab`` is
        unused."""
        dev = self.device
        P, n_sfx = pvalid.shape[-1], len(suffix)
        sp = _bucket(max(n_sfx, 1), self.bucket_multiple)
        ids = np.full((1, sp), self.pad_id, np.int64)
        ids[0, :n_sfx] = suffix
        ids_t = torch.from_numpy(ids).to(dev)
        if table is not None:
            slab = self._pool(table)
            row = torch.zeros((1, self.smax), dtype=torch.int32, device=dev)
        else:
            slab = _cols(self._state["cache"], 0, P + sp, slice(slot, slot + 1))
            for name, dst in _cols(slab, 0, P).items():
                dst.copy_(pslab[name])
            row = torch.zeros((1, P + sp), dtype=torch.int32, device=dev)
        row[:, :P] = pvalid
        out = self._forward(ids_t, attention_mask=torch.ones((1, sp), dtype=torch.int32,
                                                             device=dev),
                            positions=plen + torch.arange(sp, device=dev)[None], kv_cache=slab,
                            cache_offset=torch.full((1,), P, dtype=torch.long, device=dev),
                            kv_valid_mask=row, chunk_decode=True, **self._lora_kw(req.lora_id))
        # the last REAL position
        first, lp = self._first_token(req, slot, out["logits"][0, n_sfx - 1])
        row[:, P:P + n_sfx] = 1
        hist = None
        if self.K:
            hist = torch.full((P + sp,), -2, dtype=torch.long, device=dev)
            hist[:P] = phist
            hist[P:P + n_sfx] = ids_t[0, :n_sfx]
        self._arm_slot(req, slot, first, row[0, :P + sp], P + n_sfx, plen + n_sfx, hist)
        return first, lp

    # ------------------------------------------------------- prefix cache
    @torch.inference_mode()
    def register_prefix(self, prompt_ids, pixel_values=None, adapter=None) -> int:
        """Prefill a shared prompt prefix (e.g. a system prompt, or an image
        + preamble) ONCE into a reusable KV slab; requests submitted with
        ``prefix=<id>`` prefill only their suffix against it.  The slab is
        copied into the slot's columns at insert: what is saved is the
        recomputation, not cache memory.  Left-padded to its bucket like any
        prompt, so suffix columns continue contiguously.

        Paged: the slab is written ONCE into shared pool pages that are never
        freed and that every prefix request's table points at (no copy, and
        the slab is not kept).  Register prefixes before submitting requests:
        pinned pages shrink the pool that queued requests were checked
        against.  ``adapter``: the prefix is prefilled through that adapter
        and serves only requests on it (an unknown name is a KeyError)."""
        if adapter is not None and adapter not in self._adapter_ids:
            raise KeyError(f"unknown adapter {adapter!r}")
        ids_t, mask_t = self._left_padded(list(prompt_ids))
        P = ids_t.shape[1]
        if self.page and P // self.page > len(self._free_pages):
            raise ValueError(f"prefix needs {P // self.page} pool pages but only "
                             f"{len(self._free_pages)} are free (kv_pool_pages; register "
                             "prefixes before submitting requests)")
        slab = self._new_slab(P)
        delta = self._prefix_fill(slab, ids_t, mask_t, self._pixels(pixel_values),
                                  self._adapter_ids[adapter])
        pages = []
        if self.page:
            pages = self._alloc_pages(P // self.page)
            if self._state is None:
                self._state = self._init_state()
            self._scatter_pages(slab, pages)
            slab = None
        pid = len(self._prefixes)
        # plen: where the suffix's positions start (M-RoPE delta included)
        self._prefixes[pid] = dict(slab=slab, mask=mask_t, plen=len(prompt_ids) + delta, P=P,
                                   hist=torch.where(mask_t[0] > 0, ids_t[0], -2), pages=pages,
                                   adapter=adapter)
        return pid

    def _fill_with_prefix(self, req, slot):
        """Admit a request against a registered prefix: copy the cached
        slab (dense) or point the slot's table at the prefix's pages (paged),
        and prefill only the suffix."""
        pre = self._prefixes[req.prefix]
        suffix = self._eff_prompt(req)
        table = None
        if self.page:
            sp = _bucket(max(len(suffix), 1), self.bucket_multiple)
            self._admit_pages(req, slot, sp, prefix_pages=pre["pages"])
            table = self._row_table(self._table[slot])
        first, lp = self._suffix_insert(req, slot, pre["slab"], pre["mask"], pre["hist"],
                                        pre["plen"], suffix, table=table)
        self._after_insert(req, slot, first, lp)

    # ---------------------------------------------------- chunked prefill
    def _needs_chunked_prefill(self, req) -> bool:
        C = self.prefill_chunk
        prompt = self._eff_prompt(req)
        if not C or req.prefix is not None or len(prompt) <= C:
            return False
        if req.pixel_values is not None:
            # image features splice at image-token positions during the
            # pixel-carrying first chunk: an image span crossing the chunk
            # boundary prefills whole
            tid = getattr(self.model_cfg, "image_token_id", None)
            if tid is None or any(int(t) == tid for t in prompt[C:]):
                return False
        return True

    def _start_prefill_job(self, req, slot):
        """First chunk of a chunked prefill: exactly C (unpadded) prompt
        tokens (pixels ride here) into a slab that holds every column the
        prompt will need.  Paged: the job reserves every page its request
        can need up front and writes there (the first chunk through a slab,
        the others through a one-row table of those pages), but the slot's
        own table row stays on the trash page until the final insert, so the
        idle slot's decode writes cannot reach the job's pages."""
        C, prompt = self.prefill_chunk, list(self._eff_prompt(req))
        n = len(prompt)
        ids = torch.tensor([prompt[:C]], dtype=torch.long, device=self.device)
        mask = torch.ones((1, C), dtype=torch.int32, device=self.device)
        job = dict(req=req, slot=slot, P=C, pos=C, kv_row=mask, prompt=prompt, slab=None,
                   pages=None, table=None, delta=0)
        if self.page:
            job["pages"] = self._alloc_pages(self._own_pages_needed(req))
            slab = self._new_slab(C)
            job["delta"] = self._prefix_fill(slab, ids, mask, self._pixels(req.pixel_values),
                                             req.lora_id)
            self._scatter_pages(slab, job["pages"][:C // self.page])
            row = np.zeros((self.MP,), np.int32)
            row[:len(job["pages"])] = job["pages"]
            job["table"] = self._row_table(row)
        else:
            n_full = (n - 1) // C  # chunks before the final (<= C) one
            total = n_full * C + _bucket(n - n_full * C, self.bucket_multiple)
            job["slab"] = self._new_slab(total)
            job["delta"] = self._prefix_fill(_cols(job["slab"], 0, C), ids, mask,
                                             self._pixels(req.pixel_values), req.lora_id)
        self._n_prefill_chunks += 1
        self._prefill_job = job

    def _advance_prefill(self):
        """One more chunk of the in-flight chunked prefill; the final
        (right-padded) chunk lands through the suffix insert, which emits the
        first token and arms the slot."""
        job = self._prefill_job
        req, C = job["req"], self.prefill_chunk
        prompt = job["prompt"]
        self._n_prefill_chunks += 1
        if len(prompt) - job["pos"] > C:
            ids = torch.tensor([prompt[job["pos"]:job["pos"] + C]], dtype=torch.long,
                               device=self.device)
            job["kv_row"] = self._extend(job["slab"], job["P"], job["kv_row"],
                                         job["pos"] + job["delta"], ids, table=job["table"],
                                         lora_id=req.lora_id)
            job["P"] += C
            job["pos"] += C
            return
        self._prefill_job = None
        hist = (torch.tensor(prompt[:job["pos"]], dtype=torch.long, device=self.device)
                if self.K else None)
        pslab = None
        if self.page:
            # the slot takes the job's pages; growth never adds to them, since
            # the job reserved its request's whole region
            self._assign_pages(job["slot"], job["pages"])
            sp = _bucket(len(prompt) - job["pos"], self.bucket_multiple)
            self._set_pmeta(job["slot"], req, job["P"] + sp, 0)
        else:
            pslab = _cols(job["slab"], 0, job["P"])
        first, lp = self._suffix_insert(req, job["slot"], pslab, job["kv_row"][:, :job["P"]],
                                        hist, job["pos"] + job["delta"], prompt[job["pos"]:],
                                        table=job["table"])
        self._after_insert(req, job["slot"], first, lp)

    def _decode_chunk(self):
        """``chunk`` decode steps for every slot; returns the emitted tokens
        and liveness, both [chunk, B] on the device, and with ``logprobs``
        the tokens' logprobs [chunk, B]."""
        st, B, T = self._state, self.B, self.chunk
        dev = self.device
        rows = torch.arange(B, device=dev)
        ones = torch.ones((B, 1), dtype=torch.int32, device=dev)
        emits = torch.empty((T, B), dtype=torch.long, device=dev)
        lives = torch.empty((T, B), dtype=torch.bool, device=dev)
        lps = torch.empty((T, B), dtype=torch.float32, device=dev) if self.want_lp else None
        cache = self._pool(self._table_device()) if self.page else st["cache"]
        lora_kw = self._rows_lora_kw()
        # no row holds a valid column at or past `extent` in this chunk
        extent = min(self.smax, _bucket(max(max(self._col_cap), 1), 128))
        if self.do_sample:
            # a live row's fold index at step t is its index now plus t
            keys = sampling.fold_in(st["key"][None], st["out_idx"][None, :] + torch.arange(
                T, device=dev)[:, None])
        for t in range(T):
            live = st["live"] & (st["remaining"] > 0)
            cols = st["write_col"]
            st["kv_valid"][rows, cols] = torch.maximum(
                st["kv_valid"][rows, cols], live.to(torch.int32))
            out = self._forward(st["token"][:, None], attention_mask=ones,
                                positions=st["pos_next"][:, None], kv_cache=cache,
                                cache_offset=cols, kv_valid_mask=st["kv_valid"][:, :extent],
                                **lora_kw)
            logits = out["logits"][:, -1, :]
            if self.do_sample:
                nxt = sampling.sample_folded(keys[t], sampling.process_logits(
                    logits, self.temperature, self.top_k, self.top_p))
            else:
                nxt = torch.argmax(logits, dim=-1)
            emits[t] = torch.where(live, nxt, self.pad_id)
            lives[t] = live
            if lps is not None:
                lps[t] = token_logprobs(logits, nxt)
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
        if self.do_sample:  # the fold index advances on live rows only
            st["out_idx"] = st["out_idx"] + lives.sum(dim=0)
        return (emits, lives) if lps is None else (emits, lives, lps)

    def _spec_decode_chunk(self):
        """``chunk`` verify rounds for every slot (the JAX engine's
        ``_make_spec_decode``): propose K tokens, verify [token, draft] with
        one chunk_decode forward, accept the matching run.  Returns the
        emitted tokens [chunk, B, K+1], how many of them count [chunk, B]
        and whether the slot finished [chunk, B], on the device, and with
        ``logprobs`` each position's logprob [chunk, B, K+1]."""
        st, B, T, K = self._state, self.B, self.chunk, self.K
        dev = self.device
        rows = torch.arange(B, device=dev)
        ar = torch.arange(K + 1, device=dev)
        ones = torch.ones((B, K + 1), dtype=torch.int32, device=dev)
        vocab = self.dec_cfg.vocab_size
        emits = torch.empty((T, B, K + 1), dtype=torch.long, device=dev)
        n_emits = torch.empty((T, B), dtype=torch.long, device=dev)
        dones = torch.empty((T, B), dtype=torch.bool, device=dev)
        lps = (torch.empty((T, B, K + 1), dtype=torch.float32, device=dev) if self.want_lp
               else None)
        cache = self._pool(self._table_device()) if self.page else st["cache"]
        lora_kw = self._rows_lora_kw()
        for t in range(T):
            live = st["live"] & (st["remaining"] > 0)
            cur, pos, token = st["write_col"], st["pos_next"], st["token"]
            draft = propose_drafts(st["draft_ref"], st["ids_buf"], token, cur, K)
            chunk = torch.cat([token[:, None], draft], dim=1)
            # retired slots still run the forward: clamp their stale write
            # columns so the K+1-wide per-row write stays in bounds (live rows
            # satisfy cur + K < smax by the submit check)
            cur_w = torch.clamp(cur, max=self.smax - (K + 1))
            out = self._forward(torch.clamp(chunk, 0, vocab - 1), attention_mask=ones,
                                positions=pos[:, None] + ar[None, :], kv_cache=cache,
                                cache_offset=cur_w, kv_valid_mask=st["kv_valid"],
                                chunk_decode=True, **lora_kw)
            preds = torch.argmax(out["logits"], dim=-1)  # [B, K+1]
            acc = accept_round(chunk, preds, live, st["remaining"], st["ids_buf"],
                               st["kv_valid"], cur_w, self.eos,
                               logits=out["logits"] if lps is not None else None)
            a, n_emit, hit_eos = acc[:3]
            if lps is not None:
                lps[t] = acc[3]
            emits[t] = torch.where(ar[None, :] < n_emit[:, None], preds, self.pad_id)
            n_emits[t] = n_emit
            remaining = st["remaining"] - n_emit
            done = live & (hit_eos | (remaining <= 0))
            dones[t] = done
            adv = torch.where(live, a + 1, 0)
            st["write_col"] = cur + adv
            st["pos_next"] = pos + adv
            st["token"] = torch.where(live, preds[rows, a], token)
            st["remaining"] = remaining
            st["live"] = live & ~done
        return (emits, n_emits, dones) if lps is None else (emits, n_emits, dones, lps)

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
        """Queue a request.  ``adapter``: a name of ``adapters`` (an unknown
        one is a KeyError); a prefix request runs its prefix's adapter, and
        naming another raises ValueError.  ``sample_seed``: its stream's
        seed under sampling (default: its uid)."""
        if adapter is not None and adapter not in self._adapter_ids:
            raise KeyError(f"unknown adapter {adapter!r}; registered: "
                           f"{[k for k in self._adapter_ids if k]}")
        if prefix is not None:
            pre_ad = self._prefixes[prefix]["adapter"]
            if adapter is None:
                adapter = pre_ad
            elif adapter != pre_ad:
                raise ValueError(f"prefix {prefix} was prefilled with adapter {pre_ad!r}; "
                                 f"request asks for {adapter!r}")
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
        if self.page:
            own = (sp if prefix is None
                   else _bucket(max(len(prompt_ids), 1), self.bucket_multiple))
            need = self._pages_for(own + max_new_tokens + slack)
            # what a drained engine could ever free: prefix pages stay pinned
            ceiling = self.NP - 1 - sum(len(p["pages"]) for p in self._prefixes.values())
            if need > ceiling:
                raise ValueError(f"request needs {need} pages but the pool can free at most "
                                 f"{ceiling} (kv_pool_pages {self.NP}, minus pinned prefix "
                                 "pages)")
        self._uid += 1
        req = Request(self._uid, list(prompt_ids), max_new_tokens, pixel_values)
        req.prefix = prefix
        req.lora_id = self._adapter_ids[adapter]
        req.sample_seed = self._uid if sample_seed is None else int(sample_seed)
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
            # paged admission: the head request waits (strict FIFO) until the
            # free list holds its prompt pages plus one growth margin (a
            # chunked prefill reserves its whole region)
            chunked = self._needs_chunked_prefill(self._queue[0])
            if self.page and len(self._free_pages) < (
                    self._own_pages_needed(self._queue[0]) if chunked
                    else self._initial_own_pages(self._queue[0])):
                break
            # strict FIFO: a long prompt at the head waits for the active
            # chunked prefill rather than being overtaken
            if chunked:
                if self._prefill_job is not None:
                    break
                self._start_prefill_job(self._queue.pop(0), self._free.pop(0))
                continue
            req = self._queue.pop(0)
            slot = self._free.pop(0)
            if req.prefix is not None:
                self._fill_with_prefix(req, slot)
                continue
            first, lp = self._prefill_insert(req, slot)
            self._after_insert(req, slot, first, lp)

    def _apply_stop(self, req, old_len: int) -> bool:
        """Scan tokens appended since ``old_len`` for a stop sequence (which
        may reach back across the boundary); on a match, cut the stream
        before it (tokens and logprobs)."""
        if not req.stop:
            return False
        toks = req.tokens
        for end in range(old_len + 1, len(toks) + 1):
            for s in req.stop:
                n = len(s)
                if end >= n and toks[end - n: end] == s:
                    del toks[end - n:]
                    del req.logprobs[end - n:]
                    return True
        return False

    def _retire(self, req, slot: int, reason: str, *, kill_device: bool = False):
        req.done = True
        req.finish_reason = reason
        req.done_t = time.monotonic()
        if self._slot_req[slot] is req:
            self._slot_req[slot] = None
            self._release_slot(slot)
            if kill_device:
                self._kill_slot_device(slot)
        elif req in self._queue:  # finished while preempted and queued
            self._queue.remove(req)

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
            if self.page:
                self._free_pages.extend(job["pages"])
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

    def _after_insert(self, req, slot, first: int, lp0=None):
        self._n_prefill += 1
        now = time.monotonic()
        if not req.first_t:  # a preempted request keeps its first TTFT
            req.first_t = now
        if self.eos >= 0 and first == self.eos:
            req.done = True
            req.finish_reason = "eos"
            req.done_t = now
            self._release_slot(slot)
            return
        req.tokens.append(first)
        if lp0 is not None:
            req.logprobs.append(lp0)
        if self._apply_stop(req, len(req.tokens) - 1):
            # the insert armed the slot on the device; disarm it
            self._slot_req[slot] = req
            self._retire(req, slot, "stop", kill_device=True)
        elif len(req.tokens) >= req.max_new_tokens:  # a budget spans preemptions
            req.done = True
            req.finish_reason = "length"
            req.done_t = now
            self._release_slot(slot)
        else:
            self._slot_req[slot] = req

    def _free_done(self, req, b: int, reason: str):
        req.done = True
        req.finish_reason = reason
        req.done_t = time.monotonic()
        if self._slot_req[b] is req:
            self._slot_req[b] = None
            self._release_slot(b)
        elif req in self._queue:
            # preempted after this chunk was queued, then completed by its
            # tokens: never re-admit it
            self._queue.remove(req)

    def _consume(self, wait, snapshot):
        """Deliver one chunk's emissions to its dispatch-time slot mapping
        and retire finished requests, from the emission arrays alone (the
        device state may already be a chunk further)."""
        if self.K:
            return self._consume_spec(wait, snapshot)
        emits, lives, *lps = wait()  # [T, B] (and logprobs [T, B])
        lps = lps[0] if lps else None
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
                if lps is not None:
                    req.logprobs.append(float(lps[t, b]))
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
        emits, n_emits, dones, *lps = wait()  # [T, B, K+1], [T, B], [T, B] (, [T, B, K+1])
        lps = lps[0] if lps else None
        self._n_live_rounds += int((n_emits > 0).sum())
        for b, req in enumerate(snapshot):
            if req is None or req.done:
                continue
            for t in range(self.chunk):
                old = len(req.tokens)
                req.tokens.extend(int(x) for x in emits[t, b, :n_emits[t, b]])
                if lps is not None:
                    req.logprobs.extend(float(x) for x in lps[t, b, :n_emits[t, b]])
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
        self._ensure_page_coverage()
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
        under speculation (the measured acceptance).  Paged: the pool's
        usable pages, those in use now, the most ever in use, preemptions
        and block-table uploads."""
        rounds = max(self._n_live_rounds, 1)
        out = {
            "dispatches": self._n_dispatch,
            "prefills": self._n_prefill,
            "prefill_chunks": self._n_prefill_chunks,
            "live_rounds": self._n_live_rounds,
            "emitted": self._n_emitted,
            "tokens_per_round": self._n_emitted / rounds,
        }
        if self.page:
            out["pool_pages"] = self.NP - 1
            out["pool_pages_used"] = self.NP - 1 - len(self._free_pages)
            out["pool_pages_peak"] = self._peak_pages
            out["preemptions"] = self._n_preempt
            out["table_uploads"] = self._n_table_uploads
        return out

    def drain(self, requests: list[Request]) -> list[list[int]]:
        """Run until the given requests complete; return their token lists."""
        while not all(r.done for r in requests):
            self.step()
        return [r.tokens for r in requests]
