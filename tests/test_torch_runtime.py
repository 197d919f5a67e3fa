"""The port's runtime layer and loader (``repro_torch.runtime``,
``repro_torch.data.loader``): straggler monitor, chaos/restart
orchestration, elastic degree computation, prefetch and host sharding,
held to the JAX package's ``tests/test_runtime.py`` and
``tests/test_data.py`` cases.  Free of JAX."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.data import (PrefetchLoader, SyntheticLMDataset,  # noqa
                              shard_for_host)
from repro_torch.runtime import (ChaosMonkey, StepMonitor,  # noqa: E402
                                 WorkerFailure, backoff_delay,
                                 elastic_data_degree, elastic_mesh_axes,
                                 run_with_restarts)


def test_monitor_flags_stragglers():
    mon = StepMonitor(alpha=0.5, threshold=2.0)
    for s in range(10):
        mon.observe(s, 0.1)
    mon.observe(10, 1.0)
    assert mon.stragglers and mon.stragglers[-1][0] == 10
    assert mon.is_straggler(1.0)
    assert not mon.is_straggler(0.11)


def test_monitor_state_survives_restart():
    """The checkpointed monitor restores EMA + straggler history, so the
    first post-restore step is judged against the pre-kill baseline
    instead of re-seeding the EMA."""
    mon = StepMonitor(alpha=0.5, threshold=2.0)
    for s in range(10):
        mon.observe(s, 0.1)
    mon.observe(10, 1.0)
    fresh = StepMonitor.from_state(mon.state_dict())
    assert fresh.ema == mon.ema
    assert fresh.stragglers == mon.stragglers
    assert fresh.alpha == 0.5 and fresh.threshold == 2.0
    # a straggler right after restore is flagged, not absorbed as baseline
    fresh.observe(11, 1.0)
    assert fresh.stragglers[-1] == (11, 1.0)
    # round-trips through JSON (the checkpoint meta sidecar)
    import json
    assert StepMonitor.from_state(
        json.loads(json.dumps(mon.state_dict()))).ema == mon.ema


def test_monitor_state_roundtrip_cold():
    """A never-observed monitor (ema=None) serializes too."""
    mon = StepMonitor.from_state(StepMonitor().state_dict())
    assert mon.ema is None and mon.stragglers == []


def test_chaos_and_restarts():
    chaos = ChaosMonkey(fail_at_steps=[3, 7])
    state = {"restarts": []}

    def segment(restart):
        state["restarts"].append(restart)
        for step in range(10):
            chaos.maybe_fail(step)
        return "done"

    out, restarts = run_with_restarts(segment, max_restarts=5)
    assert out == "done"
    assert restarts == 2
    assert chaos.tripped == 2


def test_restart_budget_exhausted():
    chaos = ChaosMonkey(p=1.0)

    def segment(restart):
        chaos.maybe_fail(0)

    with pytest.raises(WorkerFailure):
        run_with_restarts(segment, max_restarts=2)


def test_configurable_catch_set():
    """Only exceptions in ``catch`` trigger a restart; anything else is a
    hard kill and propagates immediately."""
    calls = {"n": 0}

    def flaky(restart):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("nfs blipped")
        return "ok"

    out, restarts = run_with_restarts(flaky, catch=(OSError,))
    assert out == "ok" and restarts == 1
    calls["n"] = 0
    with pytest.raises(OSError):
        run_with_restarts(flaky, catch=(WorkerFailure,), max_restarts=5)
    assert calls["n"] == 1  # no restart attempted


def test_backoff_is_exponential_jittered_capped():
    delays = [backoff_delay(a, base_s=1.0, cap_s=8.0, jitter=0.0)
              for a in (1, 2, 3, 4, 5)]
    assert delays == [1.0, 2.0, 4.0, 8.0, 8.0]   # doubles, then caps
    assert backoff_delay(3, base_s=0.0) == 0.0   # disabled
    import random
    rng = random.Random(0)
    jittered = [backoff_delay(2, base_s=1.0, jitter=0.5, rng=rng)
                for _ in range(100)]
    assert all(2.0 <= d <= 3.0 for d in jittered)
    assert len(set(jittered)) > 1                # actually jittered


def test_run_with_restarts_sleeps_with_backoff():
    slept = []
    chaos = ChaosMonkey(fail_at_steps=[0, 1, 2])
    state = {"step": 0}

    def segment(restart):
        chaos.maybe_fail(state["step"])
        state["step"] += 1
        if state["step"] < 3:
            raise WorkerFailure("again")
        return "done"

    out, _ = run_with_restarts(segment, max_restarts=10, backoff_s=0.01,
                               jitter=0.0, sleep=slept.append)
    assert out == "done"
    assert slept[:3] == [0.01, 0.02, 0.04]       # exponential


def test_restart_window_budget():
    """Failures older than the window don't count against the budget: a
    long-lived run survives more than max_restarts lifetime faults as
    long as they're spread out."""
    t = {"now": 0.0}

    def segment(restart):
        t["now"] += 100.0             # 100s of healthy progress per life
        if restart < 5:
            raise WorkerFailure(f"fault {restart}")
        return "done"

    # budget 2 restarts / 150s window: 5 spread-out faults survive ...
    out, restarts = run_with_restarts(
        segment, max_restarts=2, restart_window_s=150.0,
        clock=lambda: t["now"], sleep=lambda s: None)
    assert out == "done" and restarts == 5
    # ... but the same faults in one burst exhaust it
    t["now"] = 0.0

    def bursty(restart):
        t["now"] += 1.0
        raise WorkerFailure("crash loop")

    with pytest.raises(WorkerFailure):
        run_with_restarts(bursty, max_restarts=2, restart_window_s=150.0,
                          clock=lambda: t["now"], sleep=lambda s: None)


def test_chaos_monkey_custom_exception():
    class Preemption(SystemExit):
        pass

    chaos = ChaosMonkey(fail_at_steps=[2], exc=Preemption)
    chaos.maybe_fail(1)
    with pytest.raises(Preemption):
        chaos.maybe_fail(2)
    # seeded probabilistic chaos replays identically
    a = ChaosMonkey(p=0.5, seed=13)
    b = ChaosMonkey(p=0.5, seed=13)
    for step in range(50):
        fa = fb = False
        try:
            a.maybe_fail(step)
        except WorkerFailure:
            fa = True
        try:
            b.maybe_fail(step)
        except WorkerFailure:
            fb = True
        assert fa == fb
    assert a.tripped > 0


def test_elastic_degree():
    assert elastic_data_degree(256, 16, 256) == 16
    assert elastic_data_degree(240, 16, 256) == 8  # 15 doesn't divide 256
    assert elastic_data_degree(32, 16, 64) == 2
    with pytest.raises(ValueError):
        elastic_data_degree(8, 16, 64)


def test_elastic_degree_indivisible_batch():
    # prime global batch: only degree 1 (or the batch itself) divides it
    assert elastic_data_degree(8, 1, 7) == 7
    assert elastic_data_degree(6, 1, 7) == 1
    assert elastic_data_degree(8, 1, 1) == 1
    # model_par consumes devices before the data split
    assert elastic_data_degree(12, 4, 9) == 3
    assert elastic_data_degree(16, 16, 64) == 1   # exactly model_par left


def test_elastic_degree_microbatch_interaction():
    # the data degree must divide the *per-microbatch* global batch
    assert elastic_data_degree(8, 1, 64, microbatches=1) == 8
    assert elastic_data_degree(8, 1, 64, microbatches=8) == 8
    assert elastic_data_degree(8, 1, 64, microbatches=16) == 4
    assert elastic_data_degree(8, 1, 24, microbatches=2) == 6
    with pytest.raises(ValueError):
        elastic_data_degree(2, 4, 64, microbatches=2)


def test_elastic_mesh_axes():
    # data-only mesh shrinks to the surviving feasible degree
    assert elastic_mesh_axes((("data", 8),), 4, 8) == (("data", 4),)
    assert elastic_mesh_axes((("data", 8),), 8, 8) == (("data", 8),)
    # model parallelism is preserved, data absorbs the loss
    assert elastic_mesh_axes((("data", 4), ("model", 2)), 4, 8) == \
        (("data", 2), ("model", 2))
    # degree-1 data axis drops away (resume unsharded)
    assert elastic_mesh_axes((("data", 8),), 1, 8) == ()
    assert elastic_mesh_axes((("data", 2), ("model", 2)), 2, 8) == \
        (("model", 2),)
    # multiple data axes collapse into one at the first data position
    assert elastic_mesh_axes((("pod", 2), ("data", 4), ("model", 2)),
                             8, 16) == (("pod", 4), ("model", 2))
    # unsharded checkpoints stay unsharded
    assert elastic_mesh_axes((), 8, 64) == ()
    # fewer devices than model_par is not elastically recoverable
    with pytest.raises(ValueError):
        elastic_mesh_axes((("data", 4), ("model", 4)), 2, 8)


def test_shard_for_host():
    idx = np.arange(12)
    parts = [shard_for_host(idx, h, 3) for h in range(3)]
    assert sorted(np.concatenate(parts).tolist()) == idx.tolist()


def test_prefetch_resume():
    ds = SyntheticLMDataset(100, 8)

    def batch_fn(step):
        return ds.batch([step, step + 1])

    l1 = PrefetchLoader(batch_fn, start_step=0)
    s0, b0 = next(l1)
    s1, b1 = next(l1)
    l1.close()
    l2 = PrefetchLoader(batch_fn, start_step=1)
    s1b, b1b = next(l2)
    l2.close()
    assert (s0, s1, s1b) == (0, 1, 1)
    np.testing.assert_array_equal(b1["tokens"], b1b["tokens"])
