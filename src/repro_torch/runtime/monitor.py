"""Step-time monitoring + straggler detection (the JAX package's
``repro.runtime.monitor``, unchanged: it is plain Python).  The port has
no mispredict re-plan loop yet (ROADMAP.md item 13), so nothing calls
``record_replan`` in this package; the replan history still round-trips
through the state dict, so checkpoints keep one schema."""
from __future__ import annotations

import time


class StepMonitor:
    """EMA of step wall-time; flags stragglers (steps slower than
    ``threshold``× the EMA).  On a real cluster each host reports its step
    time through a heartbeat store and the controller compares across
    hosts; here the same logic runs per process and is unit-tested."""

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ema: float | None = None
        self.stragglers: list[tuple[int, float]] = []
        self.replans: list[tuple[int, float]] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self.observe(step, dt)
        return dt

    def observe(self, step: int, dt: float):
        if self.ema is None:
            self.ema = dt
            return
        if dt > self.threshold * self.ema:
            # flagged steps do not poison the EMA baseline
            self.stragglers.append((step, dt))
            return
        self.ema = (1 - self.alpha) * self.ema + self.alpha * dt

    def is_straggler(self, dt: float) -> bool:
        return self.ema is not None and dt > self.threshold * self.ema

    def record_replan(self, step: int, ratio: float):
        """A mispredict re-plan fired (see PrivacyEngine.observe_step_time):
        record (step, measured/predicted ratio) and reset the EMA — the
        new plan's step time is a new baseline, and carrying the old one
        over would flag every post-re-plan step as a straggler (or mask
        a regression) against a dead plan's timings."""
        self.replans.append((int(step), float(ratio)))
        self.ema = None

    # -- checkpoint (de)serialization -----------------------------------
    # The monitor rides along in DPTrainState so straggler history and the
    # EMA baseline survive restarts instead of resetting to cold-start
    # (where the first post-restore step would re-seed the EMA and mask
    # a genuinely degraded host).

    def state_dict(self) -> dict:
        return {"alpha": self.alpha, "threshold": self.threshold,
                "ema": self.ema,
                "stragglers": [[int(s), float(dt)]
                               for s, dt in self.stragglers],
                "replans": [[int(s), float(r)] for s, r in self.replans]}

    def load_state_dict(self, state: dict):
        self.alpha = float(state["alpha"])
        self.threshold = float(state["threshold"])
        self.ema = None if state["ema"] is None else float(state["ema"])
        self.stragglers = [(int(s), float(dt))
                           for s, dt in state["stragglers"]]
        # pre-calibration checkpoints carry no replan history
        self.replans = [(int(s), float(r))
                        for s, r in state.get("replans", [])]
        self._t0 = None

    @classmethod
    def from_state(cls, state: dict) -> "StepMonitor":
        mon = cls()
        mon.load_state_dict(state)
        return mon
