"""Flash-decode: kernel B4 and its plain PyTorch version.

Counterpart of ``multimodal_unlearning_tpu/ops/decode_attention.py``,
dense bf16 cache only.  One query token per row attends layer ``layer`` of
the stacked [L, B, Hkv, Smax, D] cache.  On a CUDA tensor the kernel
``csrc/flash_decode.cu`` indexes the layer inside the stacked cache (no
slab is copied out); on a CPU tensor the plain version -- the JAX
package's XLA branch: the layer's slab through ``mha_reference`` -- runs.

A row whose ``kv_valid`` is all 0 gives 0 on both routes (the documented
rule for fully-masked rows).  The JAX Pallas kernel returns the mean of V
there instead; the serving engine decodes idle slots with such rows and
throws their output away, so no token depends on it.
"""

from __future__ import annotations

import torch

from multimodal_unlearning_tpu_torch.ops import kernels
from multimodal_unlearning_tpu_torch.ops.attention import IMPLS, mha_reference


def _decode_cuda(q, k_cache, v_cache, layer, kv_valid, sm_scale):
    B, Hq, _, D = q.shape
    L, Bc, Hkv, Smax, Dc = k_cache.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k_cache, v_cache)):
        raise TypeError("flash_decode kernel takes a bf16 query and a bf16 cache")
    if any(t.device != q.device for t in (k_cache, v_cache, kv_valid)):
        raise ValueError("q, the cache and kv_valid must be on one device")
    if (Bc, Dc) != (B, D) or v_cache.shape != k_cache.shape or Hq % Hkv \
            or Hq // Hkv not in (1, 2, 4, 8) or D not in (64, 128):
        raise ValueError(f"flash_decode: unsupported shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)} (head dim 64 or 128, GQA group 1/2/4/8)")
    if tuple(kv_valid.shape) != (B, Smax):
        raise ValueError(f"kv_valid must be [B, Smax] = {(B, Smax)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode reads the stacked cache in place: it must be contiguous")
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for a {L}-layer cache")
    q = q.contiguous()
    valid = kv_valid.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    fn = kernels.launcher("flash_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
                 o.data_ptr(), L, B, Hq, Hkv, Smax, D, layer, float(sm_scale), stream)
    kernels.check("flash_decode", err)
    kernels.LAUNCHES["flash_decode"] += 1
    return o


def decode_attention(q, cache, layer, kv_valid, *, sm_scale: float | None = None,
                     impl: str = "auto"):
    """One-token attention against layer ``layer`` of the stacked KV cache.

    Args:
      q: [B, Hq, 1, D] query (RoPE already applied).
      cache: {"k", "v"} -- [L, B, Hkv, Smax, D] stacked cache, the current
        token already written.
      layer: int -- which layer's slab to attend against.
      kv_valid: [B, Smax] validity mask (1 = attend).
      impl: "auto" (the kernel on CUDA, the plain version on the CPU) or
        "plain".
    Returns [B, Hq, 1, D] in q's dtype.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if set(cache) != {"k", "v"}:
        raise NotImplementedError(
            "decode_attention takes the dense cache {'k','v'}; int8 and paged caches "
            "are not ported yet")
    k_cache, v_cache = cache["k"], cache["v"]
    if q.shape[2] != 1:
        raise ValueError("decode_attention is single-token")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if impl == "plain" or q.device.type == "cpu":
        return mha_reference(q, k_cache[layer].to(q.dtype), v_cache[layer].to(q.dtype),
                             kv_valid, causal=False, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention has no kernel for device {q.device}")
    return _decode_cuda(q, k_cache, v_cache, layer, kv_valid, sm_scale)
