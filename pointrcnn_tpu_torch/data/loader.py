"""Host-side data loading with background prefetch.

Replaces the reference's torch DataLoader worker-process pool
(train_rcnn.py:71-85) with a prefetcher in one of two modes:

- thread pool (default): samples are built by the (numpy, GIL-releasing)
  dataset pipeline on background threads while the TPU executes the
  previous step.  Right on small hosts and when the pipeline is
  numpy-dominated.
- process pool (``use_processes=True``): fork-based workers, one dataset
  copy inherited copy-on-write per worker — the reference's
  ``DataLoader(num_workers=8)`` shape (train_rcnn.py:71-73).  Right on
  multi-core hosts where Python-level sections (collate, label objects,
  list handling) would contend on the GIL.

``num_workers=None`` resolves to ``min(8, os.cpu_count())`` — the
reference's worker count, scaled down on small hosts.
"""

from __future__ import annotations

import multiprocessing
import os
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# fork-inherited state for process workers: (dataset, seed).  Set by
# DataLoader.__iter__ immediately before pool creation; children inherit it
# through fork, so the dataset (incl. the gt-database pickle) is never
# serialized per task.
_FORK_STATE: list = [None]


def _proc_make_sample(args):
    dataset, seed = _FORK_STATE[0]
    epoch, idx = args
    rng = np.random.RandomState((seed + 100003 * epoch + 31 * int(idx)) % (2**31 - 1))
    return dataset.getitem(int(idx), rng)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int | None = 2,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        use_processes: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        if num_workers is None:
            num_workers = min(8, os.cpu_count() or 1)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        end = n - n % self.batch_size if self.drop_last else n
        for s in range(0, end, self.batch_size):
            yield order[s : s + self.batch_size]

    def _make_sample(self, idx: int):
        # Per-sample RNG derived from (seed, epoch, idx) only, so sample
        # construction is order-independent and safe to run on any worker.
        rng = np.random.RandomState(
            (self.seed + 100003 * self.epoch + 31 * int(idx)) % (2**31 - 1)
        )
        return self.dataset.getitem(int(idx), rng)

    def __iter__(self):
        batch_iter = self._batches()
        # Per-sample jobs fan out over num_workers; up to `prefetch` whole
        # batches are in flight ahead of the consumer, so sample building for
        # batch k+1..k+prefetch overlaps the device step on batch k.
        if self.use_processes and hasattr(multiprocessing, "get_context"):
            _FORK_STATE[0] = (self.dataset, self.seed)
            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("fork"),
            )
            submit = lambda i: pool.submit(_proc_make_sample, (self.epoch, int(i)))
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            submit = lambda i: pool.submit(self._make_sample, int(i))
        pending: deque = deque()

        def fill():
            while len(pending) < self.prefetch + 1:
                indices = next(batch_iter, None)
                if indices is None:
                    return
                pending.append([submit(int(i)) for i in indices])

        try:
            fill()
            while pending:
                futures = pending.popleft()
                samples = [f.result() for f in futures]
                fill()
                yield self.dataset.collate_batch(samples)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
