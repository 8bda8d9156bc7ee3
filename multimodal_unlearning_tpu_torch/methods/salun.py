"""SalUn saliency masks: the port's counterpart of
``multimodal_unlearning_tpu/methods/salun.py`` (reference:
methods/salun/generate_mask.py).

Accumulates |sum of gradients| of the forget-set CE over the model, then
emits binary masks keeping the top-t fraction of weights per tensor for the
thresholds 0.1..1.0 (generate_mask.py:52-85), saved as ``with_{t}.npz``.
Trees are nested dicts of tensors at the JAX tree's paths; an ``.npz`` holds
one float32 array per leaf under its ``"/"``-joined path, so a file written
by either package loads in the other.

``save_saliency_masks`` writes the files without building every threshold's
masks at once, as the JAX package does (a model's ten masks at full size
would not fit anywhere: ~270 GB for Llama-2-7B): it ranks each leaf once and
writes one threshold, and one layer, at a time.  ``apply_salun_mask(grads,
mask)`` zeroes the non-salient gradient entries.
"""

from __future__ import annotations

import zipfile
from pathlib import Path

import numpy as np
import torch

from multimodal_unlearning_tpu_torch.data.prefetch import PrefetchLoader
from multimodal_unlearning_tpu_torch.utils.pytree import (
    tree_get, tree_leaves_with_path, tree_map, tree_map_with_path)

__all__ = ["THRESHOLDS", "accumulate_saliency", "rank_tree", "save_saliency_masks",
           "load_mask", "apply_salun_mask", "kept"]

THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def accumulate_saliency(grad_fn, trainable, batches) -> dict:
    """|sum of grads| over the forget batches; ``grad_fn(trainable, batch)``
    returns a tree of gradients.  The reference sums the SIGNED per-batch
    gradients and takes the absolute value once at the end
    (generate_mask.py:41-49), not the sum of |g|: gradients that cancel
    across batches rank low.  Sums in f32, in place."""
    acc = None
    for batch in batches:
        g = grad_fn(trainable, batch)
        if acc is None:
            acc = tree_map(lambda x: x.to(torch.float32, copy=True), g)
        else:
            tree_map(lambda a, x: a.add_(x.to(torch.float32)), acc, g)
        del g
    return tree_map(lambda a: a.abs_(), acc)


def _is_stacked(path) -> bool:
    """True for leaves under the stacked-layers subtree (leading dim = L)."""
    return "layers" in path


def _rows(path, x):
    """The leaf as [R, n]: one row per layer for a stacked leaf (the
    reference ranks per ``model.parameters()`` tensor, which is a layer
    here), one row otherwise."""
    if _is_stacked(path) and x.ndim >= 2:
        return x.reshape(x.shape[0], -1)
    return x.reshape(1, -1)


def _rank_rows(flat):
    """Each entry's place [R, n] (int32) in its row's order of magnitude,
    ranked in FLOAT16 (the reference casts the accumulated |grad| to half
    before sorting, generate_mask.py:49), descending, ties by the lower
    index (a stable sort, as ``jnp.argsort(-x)``).  A row at a time, so that
    the sort's temporaries are one layer's."""
    rank = torch.empty(flat.shape, dtype=torch.int32, device=flat.device)
    place = torch.arange(flat.shape[1], dtype=torch.int32, device=flat.device)
    for r in range(flat.shape[0]):
        order = torch.argsort(-flat[r].to(torch.float16).to(torch.float32), stable=True)
        rank[r].scatter_(0, order, place)
    return rank


def rank_tree(saliency) -> dict:
    """Per-leaf ranks (``_rank_rows``, [R, n] int32) of a saliency tree.  It
    consumes the tree: each saliency leaf is freed once it is ranked, so that
    the ranks take its place in memory."""
    out = {}
    for path in [p for p, _ in tree_leaves_with_path(saliency)]:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        parent = tree_get(saliency, path[:-1])
        node[path[-1]] = _rank_rows(_rows(path, parent[path[-1]]))
        parent[path[-1]] = None
    return out


def kept(t: float, n: int) -> int:
    """Entries a row of n keeps at threshold t: ``int(t * n)``, truncated,
    so a small tensor at a small threshold can keep none."""
    return int(t * n)


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _write_npz(path, pieces) -> None:
    """An uncompressed ``.npz`` of float32 arrays, written a block at a time:
    what ``np.savez`` writes (a version 1.0 ``.npy`` header, then the array's
    bytes).  ``pieces`` yields (key, shape, block): an array's blocks of rows
    in order, a new key starting the next array.  Each block's bytes are
    handed over whole (``write_array`` copies them out in 16 MiB pieces)."""
    descr = np.lib.format.dtype_to_descr(np.dtype(np.float32))
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        f, last = None, None
        try:
            for key, shape, block in pieces:
                if key != last:
                    if f is not None:
                        f.close()
                    f, last = zf.open(key + ".npy", mode="w", force_zip64=True), key
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": descr, "fortran_order": False, "shape": shape})
                f.write(memoryview(np.ascontiguousarray(block, np.float32).reshape(-1)).cast("B"))
        finally:
            if f is not None:
                f.close()


def save_saliency_masks(saliency, out_dir: str) -> dict:
    """``with_{t}.npz`` per threshold: per tensor (per layer of a stacked
    leaf) the f32 0/1 mask of exactly ``int(t * n)`` entries, the largest in
    f16, ties by index.  Ranks each leaf once, consuming ``saliency``, then
    writes one threshold's file after the other, a layer's mask at a time: a
    thread makes the next masks on the leaves' device and copies them to the
    host while the last ones are written.  Returns {t: {path: kept entries
    per row}}."""
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    shapes = tree_map(lambda x: tuple(x.shape), saliency)
    ranks = rank_tree(saliency)
    counts = {t: {} for t in THRESHOLDS}

    def pieces(t):
        for path, rank in tree_leaves_with_path(ranks):
            k = counts[t][_key(path)] = kept(t, rank.shape[1])
            for row in rank:
                yield _key(path), tree_get(shapes, path), (row < k).to(torch.float32).cpu().numpy()

    for t in THRESHOLDS:
        _write_npz(p / f"with_{t}.npz", PrefetchLoader(pieces(t)))
    return counts


def load_mask(path: str, template) -> dict:
    """The mask tree of ``with_{t}.npz`` at ``template``'s paths (f32, on
    each template leaf's device)."""
    z = np.load(path)
    return tree_map_with_path(
        lambda k, leaf: torch.from_numpy(z[_key(k)]).to(leaf.device), template)


def apply_salun_mask(grads, mask):
    """Zero non-salient gradient entries (the mask consumer the reference
    never shipped)."""
    return tree_map(lambda g, m: g * m.to(g.dtype), grads, mask)
