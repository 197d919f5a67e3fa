"""Measured-cost calibration in the port (``repro_torch.calibrate`` and the
calibrated planning of ``core/costmodel.py`` and ``core/engine.py``): the
single-device claims of ``tests/test_calibration.py``, plus the
cross-package ones.

* **Round-trip** — a :class:`Calibration` survives the JSON file format
  and the plan store bit-identically, and a blob written by either
  package reads in the other with equal rates and digest.
* **Plan identity** — the digest keys the plan cache, the fingerprint
  and the store: a store written under measured constants misses in an
  analytic process, and a plan priced under other constants fails at
  engine init, naming the calibration.
* **Mispredict loop** — a step time 10x off the calibrated prediction
  fires exactly one re-plan (retiming the FLOP rate; the realizations do
  not change), and training stays bitwise equal to the run that never
  re-planned; an accurate prediction, one observation, no calibration or
  a disabled loop never re-plan.
* **Fail-safe** — absent or corrupt blobs degrade to the analytic
  constants with a named warning; every tampered blob raises a named
  ``CalibrationError``.
* **Parity** — under the same injected constants, the port plans the toy
  CNN and full-width AlexNet and VGG16 (by shape) exactly as the JAX
  package does, with the same predicted step FLOPs.
* **Harness and CLI** — the quick harness on the CPU; the tile-sweep
  winner reaches ``ops.pe_conv_tile_rows``; ``launch.train
  --calibration <blob>`` re-plans and still resumes bitwise.

Mesh cases wait for sharding (ROADMAP.md item 14).
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import calibrate as jcal  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import (DPConfig, PrivacyAccountant,  # noqa: E402
                              PrivacyEngine, costmodel)
from repro_torch.core.tapper import STATS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import StepMonitor  # noqa: E402
from test_torch_planner import ARCHS, _decisions, _shapes  # noqa: E402
from test_torch_resume import (CLI_CASES, _batch_fn,  # noqa: E402
                               _bitwise_equal, _to_torch, toy_apply)

RUN_SEED = 7
NOISE = 0.9
STEPS = 5


@pytest.fixture(autouse=True)
def _fresh_calibration_state():
    # Registered calibrations are process-global and folded into plan
    # fingerprints; leakage across tests would re-price every later plan.
    calibrate.clear_registry()
    costmodel.clear_plan_cache()
    costmodel.clear_plan_store()
    yield
    calibrate.clear_registry()
    costmodel.clear_plan_cache()
    costmodel.clear_plan_store()


@pytest.fixture(scope="module")
def port_toy(toy_model):
    _, params, batch = toy_model
    return toy_apply, _to_torch(params), _to_torch(batch)


def _cpu_calib(**kw):
    return calibrate.injected(device="cpu", **kw)


def _engine(toy, *, calibration=None, threshold=0.5, monitor=None,
            strategy="auto"):
    apply_fn, params, batch0 = toy
    dp = DPConfig(l2_clip=0.1, noise_multiplier=NOISE, strategy=strategy)
    acct = PrivacyAccountant(sampling_rate=1 / 128, noise_multiplier=NOISE)
    return PrivacyEngine(apply_fn, params, batch0, dp=dp, lr=1e-2,
                         accountant=acct, run_seed=RUN_SEED, device="cpu",
                         calibration=calibration,
                         mispredict_threshold=threshold, monitor=monitor)


def _drive(engine, params0, batch_fn, steps=STEPS, feed_seconds=None):
    """Step to ``steps`` on the deterministic noise stream, optionally
    feeding a fixed measured step time into the mispredict loop."""
    params, opt = params0, adamw_init(params0)
    engine.accountant.reset()
    for step in range(steps):
        params, opt, _, _ = engine.private_step(params, opt,
                                                batch_fn(step), step=step)
        if feed_seconds is not None:
            engine.observe_step_time(feed_seconds, step=step)
    return params, opt


# ---------------------------------------------------------------------------
# Round-trip: file format and plan store, bit-identical.


def test_calibration_file_round_trip_bit_identical(tmp_path):
    calib = _cpu_calib(kernels={"pe_conv_grad": {
        "tile_rows": 64, "sweep": {"0": {"seconds": 2e-3},
                                   "64": {"seconds": 1e-3}}}})
    path = str(tmp_path / "c.json")
    calibrate.save_calibration(path, calib)
    got = calibrate.load_calibration(path, device="cpu")
    assert got == calib                      # every field, bit-identical
    assert got.digest() == calib.digest()
    # the digest is content identity: it ignores the measurement time
    assert dataclasses.replace(calib, measured_at=0.0).digest() \
        == calib.digest()


def test_plan_store_round_trips_calibration(port_toy, tmp_path):
    calib = _cpu_calib()
    eng = _engine(port_toy, calibration=calib)
    plan = eng.plan()
    assert plan.calibration == calib.digest()
    path = str(tmp_path / "plans.json")
    eng.save_plan(path)

    # a fresh process: nothing registered, nothing cached
    calibrate.clear_registry()
    costmodel.clear_plan_cache()
    costmodel.clear_plan_store()
    assert costmodel.load_plan_store(path) >= 1
    # the persisted calibration came back bit-identically and registered
    assert calibrate.lookup(device="cpu") == calib
    # a fresh engine resolves the stored plan by fingerprint, no probe
    STATS.reset()
    eng2 = _engine(port_toy)
    assert eng2.calibration == calib
    assert eng2.plan().to_payload() == plan.to_payload()
    assert STATS.probes == 0


def test_store_written_under_calibration_misses_analytic_process(
        port_toy, tmp_path):
    """A store written under measured constants does not resolve for a
    process planning under other constants: the digest is folded into
    the fingerprint, so stale constants miss (and re-plan) instead of
    executing a stale costing."""
    apply_fn, params, batch = port_toy
    calib = _cpu_calib(flops_per_second=2e12)
    other = _cpu_calib(flops_per_second=3e12)
    fps = {costmodel.plan_fingerprint(apply_fn, params, batch,
                                      calibration=c)
           for c in (calib, "analytic", other)}
    assert len(fps) == 3
    path = str(tmp_path / "plans.json")
    _engine(port_toy, calibration=calib).save_plan(path)
    calibrate.clear_registry()
    costmodel.clear_plan_cache()
    costmodel.clear_plan_store()
    costmodel.load_plan_store(path)
    calibrate.clear_registry()            # the analytic process
    STATS.reset()
    plan = _engine(port_toy, calibration="analytic").plan()
    assert STATS.probes == 1              # the stored plan missed
    assert plan.calibration == ""


def test_cache_key_carries_the_calibration(port_toy):
    """get_plan never hands back a plan priced under other constants."""
    apply_fn, params, batch = port_toy
    p0 = costmodel.get_plan(apply_fn, params, batch)
    p1 = costmodel.get_plan(apply_fn, params, batch,
                            calibration=_cpu_calib())
    assert p0.calibration == "" and p1.calibration != ""
    assert len(costmodel._PLAN_CACHE) == 2
    # the registered calibration is what calibration=None prices under
    calibrate.register(_cpu_calib())
    assert costmodel.get_plan(apply_fn, params, batch).calibration \
        == p1.calibration
    assert costmodel.get_plan(apply_fn, params, batch,
                              calibration="analytic") is p0


# ---------------------------------------------------------------------------
# The mispredict loop: exactly one re-plan, bitwise-equal training.


def test_mispredict_triggers_exactly_one_replan_bitwise_equal(port_toy):
    params0, batch_fn = port_toy[1], _batch_fn(port_toy[2])
    calib = _cpu_calib()
    mon = StepMonitor()

    ref = _engine(port_toy, calibration=calib)
    ref_p, ref_o = _drive(ref, params0, batch_fn)

    eng = _engine(port_toy, calibration=calib, monitor=mon)
    bad = eng.predicted_step_seconds() * 10        # constant 10x miss
    got_p, got_o = _drive(eng, params0, batch_fn, feed_seconds=bad)

    # exactly one re-plan: the retimed calibration closes the gap
    assert len(eng.replan_events) == 1
    ev = eng.replan_events[0]
    assert ev.ratio == pytest.approx(10.0, rel=1e-6)
    assert ev.old_calibration == calib.digest()
    assert ev.new_calibration != calib.digest()
    assert ev.new_fingerprint != ev.old_fingerprint
    assert ev.plan_changed is False
    assert eng.predicted_step_seconds() == pytest.approx(bad, rel=1e-6)
    assert eng.calibration.flops_per_second == pytest.approx(
        calib.flops_per_second / 10, rel=1e-6)
    assert calibrate.lookup(device="cpu").source == "replan"
    # the mechanism's fingerprint did not move
    assert eng.fingerprint(calibration="analytic") \
        == ref.fingerprint(calibration="analytic")

    # params, optimizer state and ledger are bit-identical to the run
    # that never re-planned
    assert _bitwise_equal(ref_p, got_p)
    assert _bitwise_equal(ref_o, got_o)
    assert eng.accountant.state_dict() == ref.accountant.state_dict()
    assert eng.accountant.steps == STEPS

    assert mon.replans == [(ev.step, pytest.approx(ev.ratio))]
    assert StepMonitor.from_state(mon.state_dict()).replans == mon.replans


def test_accurate_prediction_never_replans(port_toy):
    params0, batch_fn = port_toy[1], _batch_fn(port_toy[2])
    eng = _engine(port_toy, calibration=_cpu_calib())
    _drive(eng, params0, batch_fn,
           feed_seconds=eng.predicted_step_seconds() * 1.2)   # within ±50%
    assert eng.replan_events == []


@pytest.mark.parametrize("case", ["analytic", "disabled", "fixed"])
def test_observe_is_inert_without_calibration(port_toy, case):
    params0, batch_fn = port_toy[1], _batch_fn(port_toy[2])
    eng = {"analytic": lambda: _engine(port_toy),
           "disabled": lambda: _engine(port_toy, calibration=_cpu_calib(),
                                       threshold=None),
           "fixed": lambda: _engine(port_toy, calibration=_cpu_calib(),
                                    strategy="bk")}[case]()
    assert (eng.calibration is None) == (case == "analytic")
    _drive(eng, params0, batch_fn, steps=3, feed_seconds=1e3)
    assert eng.replan_events == []


def test_single_observation_cannot_replan(port_toy):
    """One build-tainted step must not fire the loop."""
    eng = _engine(port_toy, calibration=_cpu_calib())
    assert eng.observe_step_time(eng.predicted_step_seconds() * 100,
                                 step=0) is None
    assert eng.replan_events == []


def test_explain_surfaces_calibration_and_replans(port_toy):
    assert "analytic fallback" in _engine(port_toy).explain()
    calib = _cpu_calib()
    eng = _engine(port_toy, calibration=calib)
    text = eng.explain()
    assert f"calibration: {calib.digest()}" in text
    assert "source=injected" in text
    assert "mispredict threshold" in text
    assert f"measured calibration {calib.digest()}" in text
    bad = eng.predicted_step_seconds() * 10
    eng.observe_step_time(bad, step=0)
    eng.observe_step_time(bad, step=1)
    assert "re-plan @ step 1" in eng.explain()


# ---------------------------------------------------------------------------
# Fail-safe: absent or corrupt blobs degrade with a named warning.


def test_absent_calibration_warns_and_falls_back(tmp_path):
    with pytest.warns(calibrate.CalibrationFallbackWarning,
                      match="FileNotFoundError"):
        assert calibrate.load_or_fallback(str(tmp_path / "nope.json"),
                                          device="cpu") is None


def test_corrupt_calibration_warns_and_engine_plans_analytic(
        port_toy, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"format": 1, "hardware"')    # truncated mid-key
    with pytest.warns(calibrate.CalibrationFallbackWarning,
                      match="CalibrationFormatError"):
        eng = _engine(port_toy, calibration=str(bad))
    assert eng.calibration is None
    assert eng.plan().calibration == ""
    _drive(eng, port_toy[1], _batch_fn(port_toy[2]), steps=1)


def test_check_plan_matches_names_calibration_field(port_toy):
    apply_fn, params, batch = port_toy
    plan = costmodel.get_plan(apply_fn, params, batch)   # analytic
    calib = _cpu_calib()
    with pytest.raises(ValueError, match="calibration mismatch"):
        costmodel.check_plan_matches(plan, calibration=calib)
    costmodel.check_plan_matches(plan, calibration="")
    cal_plan = costmodel.get_plan(apply_fn, params, batch,
                                  calibration=calib)
    costmodel.check_plan_matches(cal_plan, calibration=calib)
    costmodel.check_plan_matches(cal_plan, calibration=calib.digest())
    with pytest.raises(ValueError, match="calibration mismatch"):
        costmodel.check_plan_matches(cal_plan, calibration="")


def test_injecting_plan_from_other_constants_fails_at_init(port_toy):
    """A plan priced under measured constants, injected into an analytic
    engine, is refused at construction, naming the calibration."""
    apply_fn, params, batch = port_toy
    plan = costmodel.get_plan(apply_fn, params, batch,
                              calibration=_cpu_calib())
    with pytest.raises(ValueError, match="calibration mismatch"):
        PrivacyEngine(apply_fn, params, batch, dp=DPConfig(l2_clip=0.1),
                      plan=plan, device="cpu", calibration="analytic")


# ---------------------------------------------------------------------------
# Mutation harness: every tampered blob is rejected by name.


def _write(tmp_path, payload):
    path = tmp_path / "c.json"
    path.write_text(json.dumps(payload))
    return str(path)


def test_mutation_wrong_hardware_signature(tmp_path):
    calib = calibrate.injected(hardware="cuda:NVIDIA H100 80GB HBM3:1")
    path = str(tmp_path / "c.json")
    calibrate.save_calibration(path, calib)
    with pytest.raises(calibrate.CalibrationHardwareMismatch,
                       match="NVIDIA H100"):
        calibrate.load_calibration(path, device="cpu")
    # only the hardware check was waived, nothing else
    assert calibrate.load_calibration(path, expect_hardware=False) == calib


def test_mutation_truncated_payload(tmp_path):
    blob = _cpu_calib().to_json()
    path = tmp_path / "c.json"
    path.write_text(blob[: len(blob) // 2])
    with pytest.raises(calibrate.CalibrationFormatError,
                       match="not valid JSON"):
        calibrate.load_calibration(str(path), device="cpu")


@pytest.mark.parametrize("field", ["flops_per_second",
                                   "hbm_bytes_per_second"])
@pytest.mark.parametrize("value", [float("nan"), 0.0, -1.0, float("inf")])
def test_mutation_unusable_rate(tmp_path, field, value):
    p = _cpu_calib().to_payload()
    p[field] = value
    with pytest.raises(calibrate.CalibrationValueError, match=field):
        calibrate.load_calibration(_write(tmp_path, p), device="cpu")


def test_mutation_missing_field(tmp_path):
    p = _cpu_calib().to_payload()
    del p["hbm_bytes_per_second"]
    with pytest.raises(calibrate.CalibrationFormatError,
                       match="hbm_bytes_per_second"):
        calibrate.load_calibration(_write(tmp_path, p), device="cpu")


def test_mutation_foreign_format_version(tmp_path):
    p = _cpu_calib().to_payload()
    p["format"] = 99
    with pytest.raises(calibrate.CalibrationFormatError, match="format 99"):
        calibrate.load_calibration(_write(tmp_path, p), device="cpu")


def test_mutation_tampered_plan_store_calibration(port_toy, tmp_path):
    """A plan store whose embedded calibration was tampered (NaN rate)
    is refused whole: nothing is half-loaded."""
    eng = _engine(port_toy, calibration=_cpu_calib())
    path = str(tmp_path / "plans.json")
    eng.save_plan(path)
    doc = json.load(open(path))
    assert doc["calibrations"], "the store must persist its calibration"
    doc["calibrations"][0]["flops_per_second"] = float("nan")
    json.dump(doc, open(path, "w"))
    costmodel.clear_plan_store()
    calibrate.clear_registry()
    with pytest.raises(calibrate.CalibrationValueError):
        costmodel.load_plan_store(path)
    assert costmodel._PLAN_STORE == {}
    assert calibrate.registered() == []


def test_mutation_every_error_is_a_named_calibration_error():
    for cls in (calibrate.CalibrationFormatError,
                calibrate.CalibrationValueError,
                calibrate.CalibrationHardwareMismatch,
                calibrate.CalibrationMeshMismatch):
        assert issubclass(cls, calibrate.CalibrationError)
    for w in (calibrate.CalibrationFallbackWarning,
              calibrate.CalibrationAxisFallbackWarning):
        assert issubclass(w, UserWarning)
        assert not issubclass(w, calibrate.CalibrationError)


def test_mesh_waits_for_sharding(tmp_path):
    with pytest.raises(NotImplementedError, match="item 14"):
        calibrate.Calibration(hardware="h", mesh="data:2",
                              flops_per_second=1.0,
                              hbm_bytes_per_second=1.0)
    p = _cpu_calib().to_payload()
    p["mesh"] = [["data", 2]]
    with pytest.raises(NotImplementedError, match="item 14"):
        calibrate.load_calibration(_write(tmp_path, p), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        calibrate.measure("data:2", quick=True, device="cpu")


# ---------------------------------------------------------------------------
# Across the packages: one blob format, one plan under one set of constants.


def test_blob_reads_across_packages(tmp_path):
    """A blob written by ``repro.calibrate`` loads into the port (and the
    port's into the JAX package) with equal rates, kernels and digest."""
    kernels = {"pe_conv_grad": {"vmem_budget": 1 << 20, "bd": 16}}
    jc = jcal.injected(flops_per_second=4.5e13,
                       hbm_bytes_per_second=2.9e12, kernels=kernels,
                       hardware="cpu:x86_64:1")
    jpath = str(tmp_path / "jax.json")
    jcal.save_calibration(jpath, jc)
    tc = calibrate.load_calibration(jpath, expect_hardware=False)
    assert tc.flops_per_second == jc.flops_per_second
    assert tc.hbm_bytes_per_second == jc.hbm_bytes_per_second
    assert tc.kernels == kernels and tc.source == "injected"
    assert tc.hbm_flops_per_byte() == jc.hbm_flops_per_byte()
    assert tc.digest() == jc.digest()
    # the JAX package's blob names no tile: the port keeps its rule
    calibrate.register(dataclasses.replace(
        tc, hardware=calibrate.hardware_signature("cpu")))
    assert ops.pe_conv_tile_rows("cpu") == 0

    tpath = str(tmp_path / "port.json")
    calibrate.save_calibration(tpath, tc)
    back = jcal.load_calibration(tpath, expect_hardware=False)
    assert back == jc


# Injected constants: an H100-like card (f32 SGEMM 50 TFLOP/s, HBM
# 3 TB/s; ~17 FLOP/B), and one whose memory is nearly free (1 FLOP/B).
CONSTANTS = {"h100_like": (5.0e13, 3.0e12), "one_flop_per_byte": (1e13,
                                                                   1e13)}


@pytest.mark.parametrize("constants", list(CONSTANTS))
@pytest.mark.parametrize("mode", ["flat", "stale"])
@pytest.mark.parametrize("arch", ["toy", "alexnet", "vgg16"])
def test_calibrated_plans_match_reference(arch, mode, constants):
    flops, hbm = CONSTANTS[constants]
    jc = jcal.injected(flops_per_second=flops, hbm_bytes_per_second=hbm,
                       hardware="h")
    tc = calibrate.injected(flops_per_second=flops,
                            hbm_bytes_per_second=hbm, hardware="h")
    assert tc.digest() == jc.digest()
    jm, tm, (jp, jb), (tp, tb) = _shapes(arch)
    B = ARCHS[arch][2]
    jplan = jcm.get_plan(jm.apply, jp, jb, clip_mode=mode, calibration=jc)
    tplan = costmodel.get_plan(tm.apply, tp, tb, clip_mode=mode,
                               calibration=tc)
    assert _decisions(costmodel, tplan, B) == _decisions(jcm, jplan, B)
    assert tplan.calibration == jplan.calibration == tc.digest()
    np.testing.assert_allclose(costmodel.predicted_step_flops(tplan),
                               jcm.predicted_step_flops(jplan), rtol=1e-9)
    np.testing.assert_allclose(
        costmodel.predicted_step_seconds(tplan, tc),
        jcm.predicted_step_seconds(jplan, jc), rtol=1e-9)


# ---------------------------------------------------------------------------
# The kernel sweep's winner and the harness.


def test_tile_rows_precedence():
    assert ops.pe_conv_tile_rows("cpu") == 0               # the shape rule
    calibrate.register(_cpu_calib(kernels={"pe_conv_grad": {
        "tile_rows": 64, "sweep": {}}}))
    assert ops.pe_conv_tile_rows("cpu") == 64              # measured winner
    # a winner measured on other hardware never applies here
    calibrate.clear_registry()
    calibrate.register(calibrate.injected(
        hardware="cuda:NVIDIA H100 80GB HBM3:1",
        kernels={"pe_conv_grad": {"tile_rows": 128}}))
    assert ops.pe_conv_tile_rows("cpu") == 0
    # the rule, as csrc/pe_conv_grad.cu's tile_rows states it
    assert [ops.pe_conv_tile_rule(d) for d in (64, 192, 256, 384, 512)] \
        == [64, 64, 128, 128, 128]
    x, dy = torch.zeros(1, 2, 5, 5), torch.zeros(1, 3, 3, 3)
    with pytest.raises(ValueError, match="tile_rows"):
        ops.pe_conv_grad_2d(x, dy, KH=3, KW=3, tile_rows=32)
    # on the CPU every tile takes the plain version
    for rows in ops.PE_TILE_ROWS:
        assert ops.pe_conv_grad_2d(x, dy, KH=3, KW=3,
                                   tile_rows=rows).shape == (1, 3, 2, 3, 3)


def test_quick_harness_measures_live_hardware(port_toy):
    calib = calibrate.measure(quick=True, kernels=False, device="cpu")
    assert calib.hardware == calibrate.hardware_signature("cpu")
    assert calib.hardware.startswith("cpu:")
    for rate in (calib.flops_per_second, calib.hbm_bytes_per_second):
        assert math.isfinite(rate) and rate > 0
    assert calib.kernels == {}
    assert calibrate.measure(quick=True, device="cpu").kernels == {}
    assert calib.source == "measured"
    assert calibrate.Calibration.from_json(calib.to_json()) == calib
    with pytest.raises(ValueError, match="plain versions"):
        calibrate.measure(quick=True, kernels=True, device="cpu")
    # "measure" at engine init measures once per device and registers
    eng = _engine(port_toy, calibration="measure")
    assert eng.calibration is calibrate.lookup(device="cpu")
    assert _engine(port_toy, calibration="measure").calibration \
        is eng.calibration


# ---------------------------------------------------------------------------
# The CLI: --calibration <blob>, the [replan] line, bitwise resume.


def _cli_run(tmp_path, name, extra, steps=6):
    d = str(tmp_path / name)
    calibrate.clear_registry()           # each run is its own process
    costmodel.clear_plan_cache()
    cli.main(CLI_CASES["alexnet_stale"] + [
        "--device", "cpu", "--steps", str(steps), "--noise", "1.0",
        "--ckpt-dir", d, "--ckpt-every", "2"] + extra)
    with np.load(os.path.join(d, f"step_{steps - 1:09d}",
                              "arrays.npz")) as z:
        return dict(z), Checkpointer(d).read_meta(steps - 1)


def test_cli_calibrated_replans_and_resumes_bitwise(tmp_path, capsys):
    """A blob whose FLOP rate is 1e6x too fast makes the first observed
    steps diverge: the loop re-plans (realizations kept), and the run
    killed at step 3 ends bitwise equal to the straight one and to the
    uncalibrated run."""
    blob = str(tmp_path / "calib.json")
    calibrate.save_calibration(blob, _cpu_calib(flops_per_second=1e18,
                                                hbm_bytes_per_second=1e17))
    straight, ms = _cli_run(tmp_path, "straight", ["--calibration", blob])
    out = capsys.readouterr().out
    assert "[calibrate]" in out and "source=injected" in out
    assert "[replan] step 2" in out and "plan kept" in out
    assert "replans=" in out and "replans=0" not in out
    killed, mk = _cli_run(tmp_path, "killed", ["--calibration", blob,
                                               "--fail-at", "3"])
    assert "[restore] resuming from step 2" in capsys.readouterr().out
    plain, mp = _cli_run(tmp_path, "plain", [])
    assert sorted(straight) == sorted(killed) == sorted(plain)
    for k in straight:
        np.testing.assert_array_equal(straight[k], killed[k], err_msg=k)
        np.testing.assert_array_equal(straight[k], plain[k], err_msg=k)
    assert ms["plan_fingerprint"] == mk["plan_fingerprint"] \
        == mp["plan_fingerprint"]
    assert ms["ledger"] == mk["ledger"] == mp["ledger"]
