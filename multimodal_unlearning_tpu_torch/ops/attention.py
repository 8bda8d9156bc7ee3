"""Flash attention, forward and backward: kernels B1, B2, B3 and their plain
PyTorch versions.

Counterpart of ``multimodal_unlearning_tpu/ops/attention.py``.  The plain
forward is ``mha_reference`` (that module's :77-109), the plain backward
``attention_bwd_reference`` (the arithmetic of its ``_bwd`` :323-385).  On a
CUDA tensor ``flash_attention`` launches the hand-written kernels
``csrc/flash_fwd.cu`` and, in the backward pass, ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkv.cu``; on a CPU tensor it runs the plain versions.  An
f32 forward on a CUDA tensor (ECO's attacked model, ``methods/eco``) runs
B1's f32 instance ``csrc/flash_fwd_f32.cu``; it has no backward, and the
backward kernels take bf16 only.  There
is no other route, and no 128-alignment fallback: the kernels take any
sequence length (the ViT's 577 too) and head dims 64, 80 (the Qwen2-VL
towers, 1280 / 16) and 128, forward and backward.

``impl="auto"`` goes through ``FlashAttention`` (a ``torch.autograd.Function``:
gradients for q, k and v from the saved o and lse); ``impl="plain"`` is the
plain forward under ordinary autograd, the reference of the tests.

Masking rules, the same on both routes: ``kv_mask`` [B, Sk] (1 = attend)
handles left or right padding; ``causal`` places query i at absolute
position ``q_offset + i``; GQA gives q-head h the kv-head h // group; a
row with no visible key gives o = 0 and lse = -1e30.
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.ops import kernels

NEG_INF = -1e30
IMPLS = ("auto", "plain")


def _reference(q, k, v, kv_mask, causal, q_offset, sm_scale):
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    # promote, never demote: bf16 runs in f32, f64 stays f64
    acc_t = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc_t), k.to(acc_t)) * sm_scale
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :].bool()
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        mask = mask & (qi >= ki)[None, None]
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=acc_t, device=q.device))
    any_valid = mask.any(dim=-1, keepdim=True)
    p = torch.where(any_valid, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc_t)).to(q.dtype)
    lse = torch.where(any_valid, torch.logsumexp(s, dim=-1, keepdim=True), NEG_INF)
    return out, lse.to(torch.float32)


def mha_reference(q, k, v, kv_mask=None, *, causal=False, q_offset=0, sm_scale=None):
    """Plain attention with the kernel's masking semantics.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D]; kv_mask: [B, Sk] (1 = valid).
    Runs in f32 (f64 for f64 inputs) and returns q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _reference(q, k, v, kv_mask, causal, q_offset, sm_scale)[0]


def _rows(t):
    """t itself if the kernel can read it through strides (last dim
    contiguous, 16-byte aligned rows), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _flash_fwd_cuda(q, k, v, kv_mask, causal, q_offset, sm_scale):
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    # bf16 runs B1 on the tensor cores, f32 its f32 instance on the CUDA cores
    name = {torch.bfloat16: "flash_fwd", torch.float32: "flash_fwd_f32"}.get(q.dtype)
    if name is None or any(t.dtype != q.dtype for t in (k, v)):
        raise TypeError(f"flash_fwd kernel takes bf16 or f32 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one device")
    if (Bk, Dk) != (B, D) or v.shape != k.shape or Hq % Hkv or D not in (64, 80, 128):
        raise ValueError(f"flash_fwd: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (head dim 64, 80 or 128, Hq % Hkv == 0)")
    q, k, v = _rows(q), _rows(k), _rows(v)
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, Sk) or kv_mask.device != q.device:
            raise ValueError(f"kv_mask must be [B, Sk] = {(B, Sk)} on {q.device}")
        mask = kv_mask.to(torch.int32).contiguous()
    # o is laid out [B, Sq, Hq, D] so that the caller's transpose back to
    # [B, Sq, Hq*D] is free
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, Sq, 1), dtype=torch.float32, device=q.device)
    fn = kernels.launcher(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B, Hq, Hkv, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], float(sm_scale), int(bool(causal)), int(q_offset), stream)
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return o, lse


def _bwd_p_ds(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale):
    """What both backward kernels recompute per tile: p = exp(s - lse),
    masked after the exponent and 0 on a row whose lse is -1e30, and
    ds = p (do.v - delta); both rounded to the inputs' dtype as the kernels
    round them to bf16.  Returns them with q, k, v, do in the accumulation
    type (k and v repeated over each GQA group)."""
    B, Hq, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    acc_t = torch.promote_types(q.dtype, torch.float32)
    qf, dof = q.to(acc_t), do.to(acc_t)
    kf = k.to(acc_t).repeat_interleave(group, dim=1) if group > 1 else k.to(acc_t)
    vf = v.to(acc_t).repeat_interleave(group, dim=1) if group > 1 else v.to(acc_t)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :].bool()
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        mask = mask & (qi >= ki)[None, None]
    lse = lse.reshape(B, Hq, Sq, 1)
    live = lse > NEG_INF / 2
    p = torch.where(mask & live, torch.exp(s - lse.to(acc_t)), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta.reshape(B, Hq, Sq, 1).to(acc_t))).to(q.dtype).to(acc_t)
    return p.to(q.dtype).to(acc_t), ds, qf, kf, dof


def bwd_dq_reference(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale):
    """Plain version of kernel B2: dq = sm_scale * ds @ k."""
    _, ds, _, kf, _ = _bwd_p_ds(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale).to(q.dtype)


def bwd_dkv_reference(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale):
    """Plain version of kernel B3: dk = sm_scale * ds^T @ q, dv = p^T @ do,
    summed over each GQA group in the accumulation type and rounded once."""
    B, Hkv, Sk, D = k.shape
    p, ds, qf, _, dof = _bwd_p_ds(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    group = q.shape[1] // Hkv
    if group > 1:
        dk = dk.view(B, Hkv, group, Sk, D).sum(dim=2)
        dv = dv.view(B, Hkv, group, Sk, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(do, o):
    """delta_i = sum_d do_id o_id in f32, [B, Hq, Sq]: a plain reduction
    outside the kernels, as in the JAX package."""
    acc_t = torch.promote_types(do.dtype, torch.float32)
    return (do.to(acc_t) * o.to(acc_t)).sum(dim=-1)


def attention_bwd_reference(q, k, v, kv_mask, do, o, lse, causal, q_offset, sm_scale):
    """Plain version of the whole backward pass: (dq, dk, dv) from the saved
    o and lse with the kernels' arithmetic in f32 (f64 for f64 inputs)."""
    delta = _delta(do, o)
    dq = bwd_dq_reference(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale)
    dk, dv = bwd_dkv_reference(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale)
    return dq, dk, dv


def _bwd_cuda_args(name, q, k, v, kv_mask, do, lse, delta):
    """Check and lay out the inputs the backward kernels share."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, do)):
        raise TypeError(f"{name} kernel takes bf16 q/k/v/do, got "
                        f"{[str(t.dtype) for t in (q, k, v, do)]}")
    if any(t.device != q.device for t in (k, v, do, lse, delta)):
        raise ValueError("q, k, v, do, lse and delta must be on one device")
    if (do.shape != q.shape or v.shape != k.shape or k.shape[0] != B or k.shape[3] != D
            or Hq % Hkv or D not in (64, 80, 128) or lse.numel() != B * Hq * Sq
            or delta.numel() != B * Hq * Sq):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"do {tuple(do.shape)} lse {tuple(lse.shape)} "
                         f"delta {tuple(delta.shape)} (head dim 64, 80 or 128, Hq % Hkv == 0)")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, Sk) or kv_mask.device != q.device:
            raise ValueError(f"kv_mask must be [B, Sk] = {(B, Sk)} on {q.device}")
        mask = kv_mask.to(torch.int32).contiguous()
    return (_rows(q), _rows(k), _rows(v), _rows(do), mask,
            lse.to(torch.float32).contiguous(), delta.to(torch.float32).contiguous())


def _check_impl(q, impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
    return False


def flash_bwd_dq(q, k, v, kv_mask, do, lse, delta, *, causal=False, q_offset=0,
                 sm_scale=None, impl="auto"):
    """dq [B, Hq, Sq, D]: kernel B2 on CUDA tensors, its plain version on CPU
    tensors (or with ``impl="plain"``).  ``delta`` = rowsum(do * o)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _check_impl(q, impl):
        return bwd_dq_reference(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    q, k, v, do, mask, lse, delta = _bwd_cuda_args("flash_bwd_dq", q, k, v, kv_mask, do, lse,
                                                   delta)
    # laid out [B, S, H, D] like o, so that the transposes around the
    # projections stay free
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = kernels.launcher("flash_bwd_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                 *dq.stride()[:3], float(sm_scale), int(bool(causal)), int(q_offset), stream)
    kernels.check("flash_bwd_dq", err)
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, *, causal=False, q_offset=0,
                  sm_scale=None, impl="auto"):
    """(dk, dv) [B, Hkv, Sk, D]: kernel B3 on CUDA tensors, its plain version
    on CPU tensors (or with ``impl="plain"``)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _check_impl(q, impl):
        return bwd_dkv_reference(q, k, v, kv_mask, do, lse, delta, causal, q_offset, sm_scale)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    q, k, v, do, mask, lse, delta = _bwd_cuda_args("flash_bwd_dkv", q, k, v, kv_mask, do, lse,
                                                   delta)
    dk = torch.empty((B, Sk, Hkv, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Sk, Hkv, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = kernels.launcher("flash_bwd_dkv")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                 *dk.stride()[:3], *dv.stride()[:3], float(sm_scale), int(bool(causal)),
                 int(q_offset), stream)
    kernels.check("flash_bwd_dkv", err)
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, kv_mask, do, o, lse, *, causal=False, q_offset=0,
                        sm_scale=None, impl="auto"):
    """(dq, dk, dv) of ``flash_attention`` from its saved o and lse: kernels
    B2 and B3 on CUDA tensors, their plain versions on CPU tensors (or with
    ``impl="plain"`` on any device)."""
    kw = dict(causal=causal, q_offset=q_offset, sm_scale=sm_scale, impl=impl)
    delta = _delta(do, o)
    dq = flash_bwd_dq(q, k, v, kv_mask, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, kv_mask, do, lse, delta, **kw)
    return dq, dk, dv


def _flash_fwd(q, k, v, kv_mask, causal, q_offset, sm_scale):
    if q.device.type == "cpu":
        return _reference(q, k, v, kv_mask, causal, q_offset, sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
    return _flash_fwd_cuda(q, k, v, kv_mask, causal, q_offset, sm_scale)


class FlashAttention(torch.autograd.Function):
    """(o, lse) with gradients for q, k and v (counterpart of the JAX
    package's ``_flash`` custom_vjp).  The forward keeps q, k, v, the mask, o
    and lse; the backward runs B2 and B3 on CUDA tensors and their plain
    version on CPU tensors.  lse is not differentiable.  The backward is
    differentiable once: the kernels' outputs carry no graph, so a backward
    that builds a graph for a second derivative (``create_graph=True``: grad
    mode on inside the backward) raises rather than losing terms.
    ``torch.autograd.function.once_differentiable`` would not do: it raises
    only where autograd runs its error node, which ``autograd.grad`` with
    ``inputs`` prunes (no edge leads from it to the inputs).
    ``impl="plain"`` is the route for second order."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, q_offset, sm_scale):
        o, lse = _flash_fwd(q, k, v, kv_mask, causal, q_offset, sm_scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.args = (causal, q_offset, sm_scale)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        if torch.is_grad_enabled():  # only under create_graph=True
            raise RuntimeError("FlashAttention's backward is differentiable once (the kernels' "
                               "outputs carry no graph): take second derivatives through "
                               "impl='plain'")
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        causal, q_offset, sm_scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, do, o, lse, causal=causal,
                                         q_offset=q_offset, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None, None


def _flash(q, k, v, kv_mask, causal, q_offset, sm_scale, impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if impl == "plain":
        return _reference(q, k, v, kv_mask, causal, q_offset, sm_scale)
    return FlashAttention.apply(q, k, v, kv_mask, causal, q_offset, sm_scale)


def flash_attention(q, k, v, kv_mask=None, *, causal: bool = False, q_offset: int = 0,
                    sm_scale: float | None = None, impl: str = "auto"):
    """Fused multi-head attention, differentiable in q, k and v.

    Args:
      q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] with Hq % Hkv == 0 (GQA).
      kv_mask: [B, Sk] validity mask (1 = attend).
      causal: causal masking with absolute positions (see q_offset).
      q_offset: absolute position of q[0].
      impl: "auto" (the kernel on CUDA, the plain version on the CPU) or
        "plain" (the plain version on any device).
    Returns o: [B, Hq, Sq, D] in q's dtype.
    """
    return _flash(q, k, v, kv_mask, causal, q_offset, sm_scale, impl)[0]


def flash_attention_lse(q, k, v, kv_mask=None, *, causal: bool = False, q_offset: int = 0,
                        sm_scale: float | None = None, impl: str = "auto"):
    """``flash_attention`` that also returns the natural-log logsumexp of
    each row's scores, [B, Hq, Sq, 1] f32 (-1e30 for a fully-masked row) --
    what the backward kernels read.  lse carries no gradient."""
    return _flash(q, k, v, kv_mask, causal, q_offset, sm_scale, impl)
