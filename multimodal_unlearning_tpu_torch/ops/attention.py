"""Flash attention forward: kernel B1 and its plain PyTorch version.

Counterpart of ``multimodal_unlearning_tpu/ops/attention.py``.  The plain
version is ``mha_reference`` (that module's :77-109).  On a CUDA tensor
``flash_attention`` launches the hand-written kernel
``csrc/flash_fwd.cu``; on a CPU tensor it runs the plain version.  There is
no other route, and no 128-alignment fallback: the kernel takes any
sequence length (the ViT's 577 too) and head dims 64 and 128.

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
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_fwd kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one device")
    if (Bk, Dk) != (B, D) or v.shape != k.shape or Hq % Hkv or D not in (64, 128):
        raise ValueError(f"flash_fwd: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (head dim 64 or 128, Hq % Hkv == 0)")
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
    fn = kernels.launcher("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B, Hq, Hkv, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], float(sm_scale), int(bool(causal)), int(q_offset), stream)
    kernels.check("flash_fwd", err)
    kernels.LAUNCHES["flash_fwd"] += 1
    return o, lse


def _flash(q, k, v, kv_mask, causal, q_offset, sm_scale, impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if impl == "plain" or q.device.type == "cpu":
        return _reference(q, k, v, kv_mask, causal, q_offset, sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
    return _flash_fwd_cuda(q, k, v, kv_mask, causal, q_offset, sm_scale)


def flash_attention(q, k, v, kv_mask=None, *, causal: bool = False, q_offset: int = 0,
                    sm_scale: float | None = None, impl: str = "auto"):
    """Fused multi-head attention forward.

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
    what the backward kernels read."""
    return _flash(q, k, v, kv_mask, causal, q_offset, sm_scale, impl)
