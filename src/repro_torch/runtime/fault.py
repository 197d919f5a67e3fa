"""Fault tolerance: restart-from-checkpoint orchestration (the JAX
package's ``repro.runtime.fault``, unchanged: it is plain Python).

At thousand-node scale the failure model is "some host dies every few
hours"; the recovery contract is (1) checkpoints are atomic and frequent,
(2) the training loop is a pure function of (state, step) — deterministic
noise streams, checkpointed clip/accountant state — so recovery = reload
the latest valid ``DPTrainState`` and replay the deterministic step
stream from there.  ``run_with_restarts`` implements that loop with a
configurable catchable-exception set, jittered exponential backoff, and
a sliding restart-budget window; ``ChaosMonkey`` injects failures for
tests and ``train.py --chaos`` drills.
"""
from __future__ import annotations

import logging
import random
import time
from collections import deque

log = logging.getLogger("repro_torch.runtime")


class WorkerFailure(RuntimeError):
    """Simulated/propagated node failure."""


class ChaosMonkey:
    """Deterministic failure injection: trip at fixed steps and/or with
    per-step probability ``p`` (seeded, so a chaos drill is replayable).
    ``exc`` picks what is raised — pair it with ``run_with_restarts``'s
    ``catch`` set to drill both recoverable faults and hard kills."""

    def __init__(self, fail_at_steps=(), seed: int = 0, p: float = 0.0,
                 exc=WorkerFailure):
        self.fail_at = set(fail_at_steps)
        self.p = p
        self.exc = exc
        self._rng = random.Random(seed)
        self.tripped = 0

    def maybe_fail(self, step: int):
        if step in self.fail_at or (self.p and self._rng.random() < self.p):
            self.fail_at.discard(step)
            self.tripped += 1
            raise self.exc(f"injected failure at step {step}")


def backoff_delay(attempt: int, *, base_s: float, cap_s: float = 60.0,
                  jitter: float = 0.5, rng=None) -> float:
    """Jittered exponential backoff: ``min(cap, base·2^(attempt-1))``
    stretched by up to ``jitter``× (decorrelates a fleet of restarting
    workers so they don't stampede the checkpoint store in lockstep)."""
    if base_s <= 0.0:
        return 0.0
    d = min(cap_s, base_s * (2.0 ** max(attempt - 1, 0)))
    if jitter:
        d *= 1.0 + jitter * (rng.random() if rng is not None
                             else random.random())
    return d


def run_with_restarts(train_segment, *, max_restarts: int = 3,
                      catch=(WorkerFailure,), backoff_s: float = 0.0,
                      backoff_cap_s: float = 60.0, jitter: float = 0.5,
                      restart_window_s: float | None = None,
                      seed: int = 0, sleep=time.sleep,
                      clock=time.monotonic):
    """``train_segment(restart_count) -> result`` runs until completion or
    raises; on a *caught* failure we restart (the segment is responsible
    for restoring from its checkpointer).  Returns (result, restarts_used).

    ``catch``            exception types that trigger a restart; anything
                         else propagates immediately (a hard kill).
    ``backoff_s``        base of the jittered exponential backoff between
                         restarts (0 = restart immediately).
    ``restart_window_s`` budget the restarts over a sliding window: only
                         failures within the last window count against
                         ``max_restarts``, so a long healthy run doesn't
                         die on its (max_restarts+1)-th lifetime fault —
                         ``None`` budgets over the whole run.
    ``sleep``/``clock``  injectable for tests.
    """
    catch = tuple(catch) if isinstance(catch, (tuple, list)) else (catch,)
    rng = random.Random(seed)
    restarts = 0
    window: deque[float] = deque()
    while True:
        try:
            return train_segment(restarts), restarts
        except catch as e:
            restarts += 1
            now = clock()
            window.append(now)
            if restart_window_s is not None:
                while window and window[0] < now - restart_window_s:
                    window.popleft()
            used = len(window) if restart_window_s is not None else restarts
            log.warning("worker failure: %s (restart %d, budget %d/%d%s)",
                        e, restarts, used, max_restarts,
                        f" in {restart_window_s:g}s window"
                        if restart_window_s is not None else "")
            if used > max_restarts:
                raise
            delay = backoff_delay(used, base_s=backoff_s,
                                  cap_s=backoff_cap_s, jitter=jitter,
                                  rng=rng)
            if delay > 0:
                sleep(delay)
