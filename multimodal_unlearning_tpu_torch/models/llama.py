"""Llama-family decoder (RMSNorm + RoPE + SwiGLU + GQA) in PyTorch.

Counterpart of ``multimodal_unlearning_tpu/models/llama.py`` for serving
and for the forget step.  Parameters keep the JAX layout
(``models/params.py``): ``[in, out]`` weights stacked on a leading L
dimension, dense, int8- or grouped-int4-quantized (``utils/quantize.py``: an
int8 leaf dequantizes per layer, W8A16, or runs W8A8 when
``enable_int8_compute`` is on; an int4 leaf runs W4A16 through
``int4_matmul``, kernel B8 for up to 1024 rows).  The forward loops over
the layers where the JAX package scans them.

Modes of ``forward``:
  no cache (training, teacher-forced evaluation): ``kv_cache=None``; causal
    attention over the padded batch with ``attention_mask`` as key validity;
    optional LoRA adapters, per-layer rematerialisation, ``capture_layer``.
  prefill: ``kv_cache`` a [L,B,Hkv,S,D] slab written at column offset 0;
    attention reads the just-computed local k/v, identical to reading the
    slab back.
  decode: one token per row; ``cache_offset`` a [B] tensor of per-row cache
    columns; attention reads the stacked cache through ``kv_valid_mask``
    (ops/decode_attention.py).
  chunk decode (``chunk_decode=True``): C > 1 tokens per row written at
    columns ``cache_offset[b] ..`` (a [B] tensor, or an int for every row);
    query c reads the cache through ``kv_valid_mask`` plus the chunk's
    columns up to its own (the speculative verify round, chunked prefill
    and prefix suffixes).

The cache is bf16/f32 ``{"k", "v"}`` or int8 ``{"k", "v", "k_s", "v_s"}``
(``init_kv_cache(dtype=torch.int8)``), quantized per position and kv-head
as it is written.  A paged cache (``init_paged_kv_cache`` plus a ``"table"``
key, ops/paged_attention.py) is written per row through its block table and
read by the paged decode and chunk kernels; a prefill into it goes through a
contiguous slab whose pages the caller scatters.

Unlike the JAX package, the cache is updated in place: the dict passed in
is the dict returned.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from multimodal_unlearning_tpu_torch.config import LlamaConfig
from multimodal_unlearning_tpu_torch.device import resolve_device
from multimodal_unlearning_tpu_torch.models.params import ParamTree
from multimodal_unlearning_tpu_torch.ops.attention import flash_attention
from multimodal_unlearning_tpu_torch.ops.decode_attention import (
    chunk_decode_attention, decode_attention)
from multimodal_unlearning_tpu_torch.ops.rope import apply_rope_bsd, mrope_select, rope_table
from multimodal_unlearning_tpu_torch.utils.quantize import (
    dequantize_leaf, embed_lookup, int4_matmul, int8_matmul, int8_matmul_group, is_int4,
    is_qtensor, qs_of)

__all__ = ["LlamaConfig", "Llama", "init_params", "rms_norm", "dense", "init_kv_cache",
           "init_paged_kv_cache", "positions_from_mask", "enable_int8_compute",
           "apply_lora_delta", "PER_ROW"]

REMAT_POLICIES = (None, "save_attn", "save_attn_ffn", "dots", "dots_no_batch")

_aten = torch.ops.aten
# the matrix products whose outputs XLA's ``checkpoint_dots`` keeps (every
# dot_general) and ``dots_with_no_batch_dims_saveable`` keeps (those without
# batch dimensions: the weight products), as the aten ops eager PyTorch runs
_DOTS = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default,
             _aten._int_mm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default, _aten._int_mm.default),
}


def _dots_context(policy):
    """``checkpoint``'s context_fn for a dots policy: the listed products'
    outputs are saved, everything else recomputed."""
    saved = _DOTS[policy]

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _promote(dtype):
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x, weight, eps):
    # upcast, normalise, cast back, then multiply by the weight (HF
    # LlamaRMSNorm order)
    x32 = x.to(_promote(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


INT8_COMPUTE = False  # set via enable_int8_compute(); W8A8 on quantized leaves


def enable_int8_compute(on: bool = True) -> bool:
    """Opt-in W8A8: quantized-weight matmuls also quantize activations
    dynamically (straight-through backward).  Noisier than the default W8A16
    dequant path.  Returns the previous value so callers can restore it; the
    flag is read at each call."""
    global INT8_COMPUTE
    prev = INT8_COMPUTE
    INT8_COMPUTE = on
    return prev


def _is_int8(w) -> bool:
    return is_qtensor(w) and not is_int4(w)


def _maybe_dequant(w, dtype):
    """A quantized leaf dequantizes here, one layer's weight at a time,
    never the whole tree."""
    if is_qtensor(w):
        return dequantize_leaf(w, dtype)
    return w.to(dtype)


# ``lora_ids`` value saying the bank leaves are already one adapter per row
# ([B, in, r] / [B, r, out]): the serving engine gathers its slots' adapters
# once per decode chunk instead of once per projection and step
PER_ROW = "per_row"


def apply_lora_delta(y, t, ll, scale, ids=None):
    """Add a LoRA delta to projection output ``y`` (input ``t`` [B, S, in]).

    ``ll`` leaves are [in, r] / [r, out] for one adapter, or an ADAPTER BANK
    [A, in, r] / [A, r, out] selected per batch row by ``ids`` [B]
    (multi-LoRA serving: each row goes through its own adapter in the same
    forward), or, with ``ids=PER_ROW``, leaves gathered per row already."""
    if ll is None:
        return y
    a, b = ll["a"].to(t.dtype), ll["b"].to(t.dtype)
    if a.ndim == 3:
        if ids is None:  # a silent [A, in, r] matmul broadcast would be wrong
            raise ValueError("multi-adapter LoRA bank applied without lora_ids")
        if not (isinstance(ids, str) and ids == PER_ROW):
            a, b = a[ids], b[ids]
    delta = (t @ a) @ b
    return y + (delta if scale == 1.0 else delta * scale)


def dense(x, w, lora_leaf=None, lora_scale: float = 0.0, lora_ids=None):
    # a grouped-int4 leaf always takes the W4A16 product (kernel B8 for
    # small M): the W8A8 route of INT8_COMPUTE is int8-only, and a dense
    # dequant here would write bf16 weights at every decode step
    if is_int4(w):
        y = int4_matmul(x, *qs_of(w))
    elif _is_int8(w) and INT8_COMPUTE:
        y = int8_matmul(x, *qs_of(w))
    else:
        y = x @ _maybe_dequant(w, x.dtype)
    return apply_lora_delta(y, x, lora_leaf, lora_scale, lora_ids)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """KV cache of [L, B, Hkv, max_len, D] zeros: {"k", "v"} in a float
    ``dtype``, or with ``dtype=torch.int8`` K/V stored quantized per (layer,
    row, head, position) plus f32 scales ``k_s``/``v_s`` shaped [L, B, Hkv,
    1, max_len] (position on the last axis, as in the JAX package)."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32, torch.int8):
        raise NotImplementedError(f"KV cache dtype {dtype} is not ported (float or int8)")
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    dev = resolve_device(device)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if dtype == torch.int8:
        sshape = shape[:3] + (1, max_len)
        cache["k_s"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
        cache["v_s"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
    return cache


def init_paged_kv_cache(cfg: LlamaConfig, n_pages: int, page: int, dtype=torch.bfloat16,
                        device=None) -> dict:
    """Paged KV pool of ``n_pages`` pages of ``page`` columns each:
    {"k", "v"} [L, Hkv, n_pages, page, D] zeros in a float ``dtype``, or
    int8 with f32 scales ``k_s``/``v_s`` [L, Hkv, n_pages, 1, page] (the
    position last, as in the dense cache).  The caller pairs it with a
    [B, MP] int32 block table under the key "table": logical column c of row
    b lives at pool page ``table[b, c // page]``, offset ``c % page``.  The
    serving engine keeps page 0 as a trash page for retired rows."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32, torch.int8):
        raise NotImplementedError(f"KV cache dtype {dtype} is not ported (float or int8)")
    shape = (cfg.num_layers, cfg.num_kv_heads, n_pages, page, cfg.head_dim)
    dev = resolve_device(device)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if dtype == torch.int8:
        sshape = shape[:3] + (1, page)
        cache["k_s"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
        cache["v_s"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
    return cache


def quantize_kv(x):
    """[..., S, D] -> (int8 [..., S, D], f32 scales [..., 1, S]): per
    position s = amax|x| / 127 over D, then round(x / max(s, 1e-12)),
    half to even, as the JAX package's ``_cache_write``."""
    x32 = x.to(torch.float32)
    s = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(x32 / torch.clamp_min(s, 1e-12)).to(torch.int8)
    return q, s.transpose(-1, -2)


def _cache_write(cache, k, v, layer, offset):
    """Write [B,H,S,D] k/v into layer ``layer`` of the stacked cache at
    column ``offset`` (an int), or per row at ``offset[b]`` (a [B] tensor);
    an int8 cache quantizes on the way in."""
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        return _cache_write_per_row(cache, k, v, layer, offset)
    if "table" in cache:
        raise ValueError("a paged cache is written per row (offset a [B] tensor); prefill into "
                         "a contiguous slab and scatter its pages instead")
    offset = int(offset)
    S = k.shape[2]
    if "k_s" in cache:
        for name, x in (("k", k), ("v", v)):
            xq, xs = quantize_kv(x)
            cache[name][layer, :, :, offset:offset + S] = xq
            cache[name + "_s"][layer, :, :, :, offset:offset + S] = xs
        return cache
    cache["k"][layer, :, :, offset:offset + S] = k.to(cache["k"].dtype)
    cache["v"][layer, :, :, offset:offset + S] = v.to(cache["v"].dtype)
    return cache


def _cache_write_per_row(cache, k, v, layer, offset):
    """Row b's C tokens land at columns offset[b] .. offset[b]+C-1 (C == 1
    is the continuous-batching decode step, C > 1 a verify or prefill
    chunk), in one scatter per tensor.  A start past Smax - C is clamped to
    it, as the JAX package's ``dynamic_update_slice`` clamps.  A paged cache
    is written through its block table (``_cache_write_paged``)."""
    if "table" in cache:
        return _cache_write_paged(cache, k, v, layer, offset)
    B, _, C, _ = k.shape
    smax = cache["k"].shape[3]
    rows = torch.arange(B, device=k.device)[:, None]
    cols = offset.to(k.device).long().clamp(0, smax - C)[:, None] + torch.arange(
        C, device=k.device)[None, :]
    if "k_s" in cache:
        for name, x in (("k", k), ("v", v)):
            xq, xs = quantize_kv(x)
            # advanced indices at dims 1 and 3: the value is laid out [B, C, ...]
            cache[name][layer, rows, :, cols] = xq.transpose(1, 2)
            cache[name + "_s"][layer, rows, :, 0, cols] = xs[:, :, 0].transpose(1, 2)
        return cache
    cache["k"][layer, rows, :, cols] = k.transpose(1, 2).to(cache["k"].dtype)
    cache["v"][layer, rows, :, cols] = v.transpose(1, 2).to(cache["v"].dtype)
    return cache


def _cache_write_paged(cache, k, v, layer, offset):
    """Row b's C tokens land at logical columns offset[b] .. offset[b]+C-1,
    i.e. at pool page ``table[b, col // P]``, offset ``col % P``; a row's
    columns may straddle a page boundary.  One advanced-index assignment per
    tensor over the [B, C] (page, offset) pairs; an int8 pool quantizes as
    the dense write does.  A start past MP*P - C is clamped to it.  Rows
    whose tables point at the same page (only the engine's trash page 0,
    for retired rows) overwrite each other there, and nothing reads it."""
    B, _, C, _ = k.shape
    table = cache["table"].to(k.device).long()
    P = cache["k"].shape[3]
    cols = offset.to(k.device).long().clamp(0, table.shape[1] * P - C)[:, None] + torch.arange(
        C, device=k.device)[None, :]
    pg = torch.gather(table, 1, cols // P)  # [B, C]
    off = cols % P
    # pool[layer] is [Hkv, NP, P, D]: the adjacent advanced indices (pg, off)
    # at dims 1 and 2 put [B, C] there, so the value is laid out [Hkv, B, C, D]
    if "k_s" in cache:
        for name, x in (("k", k), ("v", v)):
            xq, xs = quantize_kv(x)
            cache[name][layer][:, pg, off] = xq.transpose(0, 1)
            cache[name + "_s"][layer, :, :, 0][:, pg, off] = xs[:, :, 0].transpose(0, 1)
        return cache
    cache["k"][layer][:, pg, off] = k.transpose(0, 1).to(cache["k"].dtype)
    cache["v"][layer][:, pg, off] = v.transpose(0, 1).to(cache["v"].dtype)
    return cache


def positions_from_mask(attention_mask):
    """Absolute positions under left/right padding: cumsum of validity."""
    return torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)


class Llama(ParamTree):
    """Decoder parameters at the JAX tree's paths (embed_tokens, layers.*,
    norm, lm_head) plus the f32 rope tables."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=torch.float32):
        dev = resolve_device(device)
        h, i, d, L = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.num_layers
        kvh = cfg.num_kv_heads * d
        super().__init__({
            "embed_tokens": (cfg.vocab_size, h),
            "layers": {
                "input_layernorm": (L, h),
                "q_proj": (L, h, h),
                "k_proj": (L, h, kvh),
                "v_proj": (L, h, kvh),
                "o_proj": (L, h, h),
                "post_attention_layernorm": (L, h),
                "gate_proj": (L, h, i),
                "up_proj": (L, h, i),
                "down_proj": (L, i, h),
            },
            "norm": (h,),
            "lm_head": (h, cfg.vocab_size),
        }, device=dev, dtype=dtype)
        if cfg.qkv_bias:  # the Qwen2 family
            for name, width in (("q_bias", h), ("k_bias", kvh), ("v_bias", kvh)):
                self.layers.register_parameter(name, torch.nn.Parameter(
                    torch.empty((L, width), device=dev, dtype=dtype), requires_grad=False))
        self.cfg = cfg
        self._layer_weights = None
        self.make_rope_tables(dev)

    def layer_forward(self, x, layer, weights, cos_p, sin_p, kv_mask, attn_impl="plain"):
        """Layer ``layer`` of the no-cache forward with the tensors of
        ``weights`` ({name: tensor}) in place of that layer's slices of the
        stacked parameters of those names: a function of (x, weights) alone
        for ``torch.func``'s transforms (``train/grad_proj.py``'s
        Hessian-vector products, a layer at a time)."""
        self._layer_weights = {n: {layer: w} for n, w in weights.items()}
        try:
            return self._block(x, layer, cos_p, sin_p, None, 0, kv_mask, False, attn_impl)
        finally:
            self._layer_weights = None

    def _lw(self, name, layer):
        """Layer ``layer`` of stacked parameter ``name`` (the tensor given for
        it under ``layer_forward``)."""
        if self._layer_weights is not None and name in self._layer_weights:
            return self._layer_weights[name][layer]
        return getattr(self.layers, name)[layer]

    def make_rope_tables(self, device) -> None:
        """The f32 rope tables (buffers ``rope_cos`` / ``rope_sin``) on
        ``device``; a model built on the meta device makes them again on its
        real one."""
        cfg = self.cfg
        cos, sin = rope_table(cfg.max_position_embeddings, cfg.head_dim, cfg.rope_theta,
                              device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Llama":
        """Random init with the JAX package's distributions: weights
        N(0, 1/fan_in), embeddings N(0, 0.02^2), norms 1."""
        lp = self.layers
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj"):
            w = getattr(lp, name)
            w.normal_(0.0, w.shape[-2] ** -0.5, generator=generator)
        lp.input_layernorm.fill_(1.0)
        lp.post_attention_layernorm.fill_(1.0)
        if self.cfg.qkv_bias:
            for name in ("q_bias", "k_bias", "v_bias"):
                getattr(lp, name).zero_()
        self.embed_tokens.normal_(0.0, 0.02, generator=generator)
        self.norm.fill_(1.0)
        self.lm_head.normal_(0.0, self.lm_head.shape[-2] ** -0.5, generator=generator)
        return self

    def _lora_leaf(self, lora, name, layer):
        ll = None if lora is None else lora.get(name)
        return None if ll is None else {"a": ll["a"][layer], "b": ll["b"][layer]}

    def _project(self, t, names, layer, lora, lora_scale, lora_ids=None):
        """Projections ``names`` of one input ``t``.  Under W8A8 they share
        one activation quantization (q/k/v, gate/up).  A q/k/v bias (the
        Qwen2 family) is added last, after the product's rescale and the
        LoRA delta, in the output's dtype and never quantized, as in the
        JAX package."""
        ws = [self._lw(n, layer) for n in names]
        lls = [self._lora_leaf(lora, n, layer) for n in names]
        if len(names) > 1 and INT8_COMPUTE and all(_is_int8(w) for w in ws):
            ys = int8_matmul_group(t, tuple(w["q"] for w in ws), tuple(w["s"] for w in ws))
            ys = [apply_lora_delta(y, t, ll, lora_scale, lora_ids) for y, ll in zip(ys, lls)]
        else:
            ys = [dense(t, w, ll, lora_scale, lora_ids) for w, ll in zip(ws, lls)]
        if self.cfg.qkv_bias and names[0] == "q_proj":
            ys = [y + self._lw(n[0] + "_bias", layer).to(y.dtype) for y, n in zip(ys, names)]
        return ys

    def _attn_inputs(self, x, layer, cos_p, sin_p, lora, lora_scale, lora_ids=None):
        """Input norm, q/k/v projections and rope: x -> q, k, v [B, H, S, D]."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        h = rms_norm(x, self._lw("input_layernorm", layer), cfg.rms_norm_eps)
        q, k, v = self._project(h, ("q_proj", "k_proj", "v_proj"), layer, lora, lora_scale,
                                lora_ids)
        q = q.view(B, S, nh, hd).transpose(1, 2)
        k = k.view(B, S, nkv, hd).transpose(1, 2)
        v = v.view(B, S, nkv, hd).transpose(1, 2)
        return apply_rope_bsd(q, cos_p, sin_p), apply_rope_bsd(k, cos_p, sin_p), v

    def _attn_out_ffn_in(self, x, attn, layer, lora, lora_scale, lora_ids=None):
        """Output projection, residual, post norm, gate/up: -> (x, ffn_pre_down)."""
        cfg = self.cfg
        x = x + dense(attn, self._lw("o_proj", layer), self._lora_leaf(lora, "o_proj", layer),
                      lora_scale, lora_ids)
        h = rms_norm(x, self._lw("post_attention_layernorm", layer), cfg.rms_norm_eps)
        gate, up = self._project(h, ("gate_proj", "up_proj"), layer, lora, lora_scale,
                                 lora_ids)
        return x, F.silu(gate.to(_promote(gate.dtype))).to(x.dtype) * up

    def _ffn_down(self, x, ff, layer, lora, lora_scale, lora_ids=None):
        return x + dense(ff, self._lw("down_proj", layer),
                         self._lora_leaf(lora, "down_proj", layer), lora_scale, lora_ids)

    def _after_attn(self, x, attn, layer, lora, lora_scale, lora_ids=None):
        x, ff = self._attn_out_ffn_in(x, attn, layer, lora, lora_scale, lora_ids)
        return self._ffn_down(x, ff, layer, lora, lora_scale, lora_ids)

    def _attend(self, q, k, v, layer, kv_cache, cache_offset, kv_mask, decoding, attn_impl,
                chunk_decode=False):
        B, _, S, _ = q.shape
        if kv_cache is not None:
            # the cache is written BEFORE attention: decode reads it back
            _cache_write(kv_cache, k, v, layer, cache_offset)
        if chunk_decode:
            attn = chunk_decode_attention(q, kv_cache, layer, kv_mask, cache_offset,
                                          impl=attn_impl)
        elif decoding:
            attn = decode_attention(q, kv_cache, layer, kv_mask, impl=attn_impl)
        else:
            attn = flash_attention(
                q, k.to(q.dtype), v.to(q.dtype),
                kv_mask if kv_mask.shape[1] == S else kv_mask[:, :S],
                causal=True, impl=attn_impl)
        return attn.transpose(1, 2).reshape(B, S, -1)

    def _block(self, x, layer, cos_p, sin_p, kv_cache, cache_offset, kv_mask, decoding,
               attn_impl, lora=None, lora_scale=0.0, chunk_decode=False, lora_ids=None):
        q, k, v = self._attn_inputs(x, layer, cos_p, sin_p, lora, lora_scale, lora_ids)
        attn = self._attend(q, k, v, layer, kv_cache, cache_offset, kv_mask, decoding,
                            attn_impl, chunk_decode)
        return self._after_attn(x, attn, layer, lora, lora_scale, lora_ids)

    def _block_remat(self, x, layer, cos_p, sin_p, kv_mask, attn_impl, lora, lora_scale,
                     policy):
        """One layer under rematerialisation (no cache).  ``policy``:
          None: the whole layer is recomputed in the backward pass; only its
            input x is kept (the attention forward runs again).
          "save_attn": the part before attention and the part after it are
            recomputed separately and the attention call stands between them,
            outside both, so it keeps q, k, v, o and lse and its backward runs
            without a second forward.
          "save_attn_ffn": as "save_attn", and the down projection stands
            outside too, which keeps its input ``ffn_pre_down``.
          "dots" / "dots_no_batch": the whole layer under a selective
            checkpoint that keeps the outputs of its matrix products (all of
            them, or those without batch dimensions: the weight products) and
            recomputes the rest, XLA's ``checkpoint_dots`` and
            ``dots_with_no_batch_dims_saveable``.  The attention kernels' call
            is no product of aten's, as it is no dot in the JAX package's
            kernel route: it runs again."""
        def ckpt(fn, *args, **kw):
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

        if policy is None or policy in _DOTS:
            return ckpt(lambda t: self._block(t, layer, cos_p, sin_p, None, 0, kv_mask, False,
                                              attn_impl, lora, lora_scale), x,
                        **({"context_fn": _dots_context(policy)} if policy else {}))
        q, k, v = ckpt(lambda t: self._attn_inputs(t, layer, cos_p, sin_p, lora, lora_scale), x)
        attn = self._attend(q, k, v, layer, None, 0, kv_mask, False, attn_impl)
        if policy == "save_attn":
            return ckpt(lambda t, a: self._after_attn(t, a, layer, lora, lora_scale), x, attn)
        x, ff = ckpt(lambda t, a: self._attn_out_ffn_in(t, a, layer, lora, lora_scale), x, attn)
        return self._ffn_down(x, ff, layer, lora, lora_scale)

    def forward(self, input_ids=None, *, inputs_embeds=None, attention_mask=None,
                positions=None, kv_cache=None, cache_offset=0, kv_valid_mask=None,
                lora: dict | None = None, lora_scale: float = 0.0, lora_ids=None,
                capture_layer: int | None = None, remat: bool = False,
                remat_policy: str | None = None, attn_impl: str = "auto",
                compute_dtype=torch.bfloat16, logits_dtype=None, return_hidden: bool = False,
                last_logit_only: bool = False, chunk_decode: bool = False) -> dict:
        """Decoder forward (modes: see the module docstring).

        ``lora``: adapter tree ``{"layers": {proj: {"a", "b"}}, "lm_head": ...}``
        applied with ``lora_scale``; a bank (``models/lora.stack_adapters``)
        with ``lora_ids`` [B], one adapter per row (``apply_lora_delta``).
        ``capture_layer``: also return the f32 hidden state after that layer.
        ``remat``: recompute each layer in the
        backward pass instead of keeping its activations (no-cache mode with
        gradients on; it changes memory, never values); ``remat_policy`` says
        what is kept, see ``_block_remat``.

        Returns {"logits": [B, S or 1, V], "kv_cache": the cache or None,
        "captured": [B, S, H] f32 or None, "hidden": final normed states or
        None}."""
        cfg = self.cfg
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got "
                             f"{remat_policy!r}")
        if logits_dtype is None:
            logits_dtype = _promote(compute_dtype)
        if inputs_embeds is None:
            et = self.embed_tokens
            inputs_embeds = embed_lookup(et, input_ids) if is_qtensor(et) else et[input_ids]
        x = inputs_embeds.to(compute_dtype)
        B, S, _ = x.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=x.device)
        if positions is None:
            if kv_cache is None:
                # HF plain-forward convention: arange regardless of padding
                positions = torch.arange(S, device=x.device).expand(B, S)
            else:
                # generation: mask-aware positions, as HF generate
                positions = positions_from_mask(attention_mask)
        positions = positions.long()
        if positions.ndim == 3:  # M-RoPE [3, B, S] (Qwen2-VL)
            cos_p, sin_p = mrope_select(self.rope_cos, self.rope_sin, positions,
                                        cfg.mrope_section, cfg.head_dim)
        else:
            cos_p, sin_p = self.rope_cos[positions], self.rope_sin[positions]  # [B, S, D]

        decoding = kv_cache is not None and S == 1
        # verify/prefill chunk: C > 1 tokens read the WHOLE cache (accepted
        # prefix + per-row in-chunk causal) at per-row columns
        chunk_decode = chunk_decode and kv_cache is not None and not decoding
        if chunk_decode:
            cache_offset = torch.as_tensor(cache_offset, device=x.device).reshape(-1).expand(B)
        elif kv_cache is not None and not decoding and not (
                isinstance(cache_offset, int) and cache_offset == 0):
            raise ValueError(
                "a multi-token pass into the cache starts at column 0 unless it is a "
                "chunk_decode pass")
        kv_mask = kv_valid_mask if kv_valid_mask is not None else attention_mask
        layer_lora = None if lora is None else lora.get("layers")
        use_remat = remat and kv_cache is None and torch.is_grad_enabled()
        captured = None
        for layer in range(cfg.num_layers):
            if use_remat:
                x = self._block_remat(x, layer, cos_p, sin_p, kv_mask, attn_impl, layer_lora,
                                      lora_scale, remat_policy)
            else:
                x = self._block(x, layer, cos_p, sin_p, kv_cache, cache_offset, kv_mask,
                                decoding, attn_impl, layer_lora, lora_scale, chunk_decode,
                                lora_ids)
            if capture_layer is not None and layer == capture_layer:
                captured = x.to(torch.float32)
        return self._epilogue(x, lora, lora_scale, logits_dtype, last_logit_only,
                              return_hidden, captured, kv_cache, lora_ids)

    def _epilogue(self, x, lora, lora_scale, logits_dtype, last_logit_only, return_hidden,
                  captured, kv_cache, lora_ids=None):
        """Final norm + LM head (LoRA on ``lm_head`` included); logits cast
        to ``logits_dtype`` after a head in the compute dtype."""
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        lm_lora = lora.get("lm_head") if lora is not None else None
        xh = x[:, -1:] if last_logit_only else x
        logits = dense(xh, self.lm_head, lm_lora, lora_scale, lora_ids).to(logits_dtype)
        return {"logits": logits, "kv_cache": kv_cache, "captured": captured,
                "hidden": x if return_hidden else None}


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None, *,
                device=None, dtype=torch.float32) -> Llama:
    """A randomly initialised decoder on ``device`` (the card by default)."""
    model = Llama(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=model.norm.device).manual_seed(0)
    return model.init_params(generator)
