"""Shard-aware prefetching loader (the JAX package's
``repro.data.loader``; the batches are numpy, so nothing here is
framework-specific)."""
from __future__ import annotations

import queue
import threading


def shard_for_host(indices, host_id: int, n_hosts: int):
    """Static round-robin shard of a batch's example indices."""
    return indices[host_id::n_hosts]


class PrefetchLoader:
    """Background-thread prefetch of deterministic batches.

    ``batch_fn(step) -> batch`` must be pure; the loader owns no data
    state, so resuming from step k is just ``PrefetchLoader(batch_fn,
    start_step=k)``.  Call :meth:`close` when done: it stops the thread.
    """

    def __init__(self, batch_fn, start_step: int = 0, prefetch: int = 2):
        self.batch_fn = batch_fn
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.batch_fn(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
