"""Threaded prefetching data loader (port of anyref_tpu/data/loader.py).

Worker threads run dataset __getitem__ and the collator (numpy and IO
release the GIL) while the card consumes earlier batches. Batches come out
in order; a worker may only start a batch within ``prefetch + num_workers``
of the next one to emit, so out-of-order results never pile up. Shuffling
is deterministic per epoch from ``seed``. On a mesh each data rank loads a
disjoint shard, as each host of the reference does: every rank shuffles
the whole index list with the same seed and takes the strided slice
``[process_index::process_count]``.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterator, Sequence


class DataLoader:
    def __init__(self, dataset, collate_fn: Callable, batch_size: int = 1,
                 shuffle: bool = False, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        """``process_index`` / ``process_count``: this rank's "data"
        coordinate and the "data" axis's size (ranks that share a data
        coordinate load the same rows); ``batch_size`` is this rank's."""
        self.dataset = dataset
        self.collate = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.epoch = 0

    def __len__(self):
        n = len(range(self.process_index, len(self.dataset),
                      self.process_count))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Sequence[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.process_index::self.process_count]
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                return
            yield b

    def __iter__(self):
        if self.num_workers == 0:
            for b in self._batches():
                yield self.collate([self.dataset[i] for i in b])
            self.epoch += 1
            return

        batches = list(self._batches())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        next_emit = [0]
        lock = threading.Lock()
        work = iter(enumerate(batches))
        done = threading.Event()
        window = self.prefetch + self.num_workers
        gate = threading.Condition()

        def worker():
            while not done.is_set():
                with lock:
                    try:
                        bi, b = next(work)
                    except StopIteration:
                        return
                with gate:
                    while bi >= next_emit[0] + window and not done.is_set():
                        gate.wait(0.1)
                if done.is_set():
                    return
                try:
                    batch = self.collate([self.dataset[i] for i in b])
                except Exception as e:  # surface errors to the consumer
                    batch = e
                out_q.put((bi, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        emitted = 0
        pending = {}   # bounded by `window` thanks to the handout gate
        try:
            while emitted < len(batches):
                if next_emit[0] in pending:
                    batch = pending.pop(next_emit[0])
                else:
                    bi, batch = out_q.get()
                    if bi != next_emit[0]:
                        pending[bi] = batch
                        continue
                if isinstance(batch, Exception):
                    raise batch
                yield batch
                with gate:
                    next_emit[0] += 1
                    gate.notify_all()
                emitted += 1
        finally:
            done.set()
            with gate:
                gate.notify_all()
            self.epoch += 1
