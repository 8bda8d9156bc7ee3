"""Prefetching data pipeline: the port's copy of
``multimodal_unlearning_tpu/data/prefetch.py``.

A bounded background thread keeps ``depth`` collated batches ready while the
card computes, so host collation overlaps the device steps.  The loader
counts the seconds its thread spends producing batches (sampling and
collation) and the seconds the consumer waits on the queue: a consumer that
waits is held back by the host.
"""

from __future__ import annotations

import queue
import threading
import time


class PrefetchLoader:
    """Wraps any iterable-of-batches loader with a depth-N prefetch thread."""

    _END = object()

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth
        self.collate_seconds = 0.0  # producer thread: time to make the batches
        self.wait_seconds = 0.0     # consumer: time blocked on the queue
        self.batches = 0

    def __len__(self):
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    @property
    def batch_size(self):
        return self.loader.batch_size

    @property
    def epoch(self):
        return self.loader.epoch

    @epoch.setter
    def epoch(self, value):
        # the resume path (train/loop.py) restores the shuffle's epoch counter
        self.loader.epoch = value

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                it = iter(self.loader)
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, self._END)
                    self.collate_seconds += time.perf_counter() - t0
                    if batch is self._END:
                        break
                    # bounded put, so that an abandoned consumer (a break, an
                    # exception upstream) releases this thread
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                while True:
                    try:
                        q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is self._END:
                    if err:
                        raise err[0]
                    return
                self.batches += 1
                yield item
        finally:
            stop.set()
