"""ctypes bridge to the host-pipeline library ``native/libmmu_native.so``.

The port's copy of ``multimodal_unlearning_tpu/utils/native.py``: the
collator's pad-and-mask and the CLIP image preprocess in C++, with numpy
versions beside them.  Host code, not a device kernel.  The port loads the
committed library and never builds it (``native/`` belongs to the JAX
package); when it cannot be loaded, ``pad_and_mask`` runs its numpy version
and ``clip_preprocess_batch`` returns None (the caller then takes the PIL
path).  ``available()`` says which path is live.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libmmu_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    i64, i32p, i64p, f32p, u8p = (
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8))
    lib.pad_and_mask.argtypes = [i32p, i64p, i32p, i64, i64, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int32, i32p, i32p, i32p]
    lib.pad_and_mask.restype = None
    lib.clip_preprocess_batch.argtypes = [u8p, i64, i64, i64, f32p, i64, f32p, f32p]
    lib.clip_preprocess_batch.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the C++ library is loaded (else the numpy / PIL paths run)."""
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pad_and_mask_numpy(token_rows, n_question, seq_len, pad_id, *, pad_left=True,
                       ignore_index=-100):
    """The numpy version of ``pad_and_mask``."""
    B = len(token_rows)
    ids = np.full((B, seq_len), pad_id, np.int32)
    attn = np.zeros((B, seq_len), np.int32)
    labels = np.full((B, seq_len), ignore_index, np.int32)
    for r, row in enumerate(token_rows):
        row = row[:seq_len]
        n = len(row)
        start = seq_len - n if pad_left else 0
        ids[r, start:start + n] = row
        attn[r, start:start + n] = 1
        q = min(n_question[r], n)
        labels[r, start + q:start + n] = row[q:]
    return ids, attn, labels


def pad_and_mask(token_rows, n_question, seq_len, pad_id, *, pad_left=True, ignore_index=-100):
    """Batched pad + mask: token_rows (lists of ids) -> (ids, attention
    mask, labels), int32 [B, seq_len]; labels are ``ignore_index`` on the
    first ``n_question[r]`` tokens of row r and on the padding."""
    lib = _load()
    if lib is None:
        return pad_and_mask_numpy(token_rows, n_question, seq_len, pad_id, pad_left=pad_left,
                                  ignore_index=ignore_index)
    B = len(token_rows)
    offsets = np.zeros(B + 1, np.int64)
    for r, row in enumerate(token_rows):
        offsets[r + 1] = offsets[r] + len(row)
    tokens = np.asarray([t for row in token_rows for t in row], np.int32)
    if tokens.size == 0:
        tokens = np.zeros(1, np.int32)
    nq = np.asarray(n_question, np.int32)
    ids = np.empty((B, seq_len), np.int32)
    attn = np.empty((B, seq_len), np.int32)
    labels = np.empty((B, seq_len), np.int32)
    lib.pad_and_mask(
        _ptr(tokens, ctypes.c_int32), _ptr(offsets, ctypes.c_int64), _ptr(nq, ctypes.c_int32),
        B, seq_len, pad_id, ignore_index, 1 if pad_left else 0,
        _ptr(ids, ctypes.c_int32), _ptr(attn, ctypes.c_int32), _ptr(labels, ctypes.c_int32))
    return ids, attn, labels


def clip_preprocess_batch(images_u8: np.ndarray, out_hw: int, mean, std) -> np.ndarray | None:
    """CLIPImageProcessor's preprocess (shortest-edge bicubic resize, center
    crop, normalize): [B, H, W, 3] uint8 -> [B, out_hw, out_hw, 3] float32;
    None when the library is not loaded."""
    lib = _load()
    if lib is None:
        return None
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"expected [B, H, W, 3] uint8 images, got {images_u8.shape}")
    B, H, W, _ = images_u8.shape
    out = np.empty((B, out_hw, out_hw, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.clip_preprocess_batch(_ptr(images_u8, ctypes.c_uint8), B, H, W,
                              _ptr(out, ctypes.c_float), out_hw,
                              _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float))
    return out
