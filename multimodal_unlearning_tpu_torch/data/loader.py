"""Host-side batching: the port's copy of
``multimodal_unlearning_tpu/data/loader.py``.

A seeded shuffle per epoch (``random.Random(seed + epoch)``), collation into
numpy arrays, and the [accum, micro, ...] reshape the train step's gradient
accumulation loops over.  The order is the JAX package's, batch for batch.
"""

from __future__ import annotations

import random

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn, *, shuffle=False, seed=0,
                 drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        if hasattr(self.dataset, "set_epoch"):
            # per-(seed, epoch, idx) sample randomness: a resumed run replays it
            self.dataset.set_epoch(self.epoch)
        self.epoch += 1
        bs = self.batch_size
        end = len(order) - (len(order) % bs) if self.drop_last else len(order)
        for i in range(0, end, bs):
            idxs = order[i : i + bs]
            if self.drop_last and len(idxs) < bs:
                break
            yield self.collate_fn([self.dataset[j] for j in idxs])


def stack_microbatches(batch: dict, accum: int) -> dict:
    """[A*micro, ...] -> [A, micro, ...] on every array of a (nested) batch."""

    def r(x):
        return np.asarray(x).reshape(accum, x.shape[0] // accum, *x.shape[1:])

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else r(v) for k, v in d.items()}

    return walk(batch)
