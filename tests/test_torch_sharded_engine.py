"""Data-parallel sharding in the port (ROADMAP item 14, part 1).

Two groups, as ``tests/test_sharded_engine.py``:

* Mesh-aware *planning*, against the JAX package, with no devices: the
  port's plan for a mesh spec equals the JAX package's by decision,
  per-layer ``coll_bytes`` and ``coll_bytes_by_axis`` (rtol 1e-9) and
  totals, on the suite's toy model at ``data:8`` and ``data:4,model:2``,
  reduced Llama-3.2-1B (the tied group synced once), and full-width
  AlexNet and Llama-3.2-1B by meta shapes; the mesh in the fingerprint,
  the cache key, the JSON and ``explain()``; named stale-plan mismatches;
  the plan store across topologies; ``launch.sharding``'s param specs
  against the JAX package's ``PartitionSpec``s.
* Sharded *execution* on gloo over the CPU: one process group of 4 ranks
  and one of 2, each spawned once for the module
  (``tests/torch_shard_worker.py``).  The sharded step equals the
  single-device step within 1e-6 after 2 steps (σ = 0 and σ = 1.3, flat,
  per_layer with auto budgets, stale), equals the JAX package's at σ = 0
  (rtol 1e-4, atol 1e-6, the parity tests' tolerance), passes the naive
  oracle, keeps its ranks bitwise equal, resumes bitwise after a kill on
  data:2 and within 1e-6 from data:4 onto data:2 with no ledger gap; an
  indivisible batch and a live model axis raise.
"""
import functools
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_shard_worker as sw  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import DPConfig as JDPConfig  # noqa: E402
from repro.core import PrivacyEngine as JPrivacyEngine  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import PrivacyEngine, costmodel as tcm  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_host_mesh  # noqa
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402

_TDT = {jnp.dtype(jnp.float32): torch.float32,
        jnp.dtype(jnp.bfloat16): torch.bfloat16,
        jnp.dtype(jnp.int32): torch.int32}


def _batch8(batch):
    return {k: torch.cat([v, v]) for k, v in batch.items()}


@pytest.fixture(scope="module")
def toys(toy_model):
    """(JAX apply, params, batch) and the port's, the suite's toy model."""
    japply, jp, jb = toy_model
    return (japply, jp, jb), (sw.toy_apply, sw.to_torch(jp),
                              sw.to_torch(jb))


def _leaves(tree):
    return [get_subtree(tree, p) for p in leaf_paths(tree)]


def _maxdiff(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)))


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


# ---------------------------------------------------------------------------
# Planning, against the JAX package (no devices)


def _assert_plans_equal(j, t):
    assert set(j.layers) == set(t.layers)
    for n, a in j.layers.items():
        b = t.layers[n]
        assert (a.kind, a.norm_method, a.stash, a.fused, a.model_shards) \
            == (b.kind, b.norm_method, b.stash, b.fused, b.model_shards), n
        for f in ("norm_flops", "contrib_flops", "wgrad_flops",
                  "stash_bytes", "param_bytes", "ex_per_dev", "coll_bytes"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-9, err_msg=f"{n} {f}")
        assert [x for x, _ in a.coll_bytes_by_axis] \
            == [x for x, _ in b.coll_bytes_by_axis], n
        np.testing.assert_allclose([v for _, v in b.coll_bytes_by_axis],
                                   [v for _, v in a.coll_bytes_by_axis],
                                   rtol=1e-9, err_msg=n)
    assert j.sum_methods() == t.sum_methods()
    assert [(g.path, g.members, g.norm_mode) for g in j.groups] \
        == [(g.path, g.members, g.norm_mode) for g in t.groups]
    assert j.needs_backward == t.needs_backward
    assert tuple(j.mesh) == tuple(t.mesh)
    for f in ("total_coll_bytes", "capture_bytes", "total_norm_flops",
              "total_contrib_flops"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-9,
                                   err_msg=f)
    assert [a for a, _ in j.total_coll_bytes_by_axis] \
        == [a for a, _ in t.total_coll_bytes_by_axis]
    np.testing.assert_allclose([v for _, v in t.total_coll_bytes_by_axis],
                               [v for _, v in j.total_coll_bytes_by_axis],
                               rtol=1e-9)


def test_mesh_axes_normalization():
    assert tcm.mesh_axes(None) == ()
    assert tcm.mesh_axes("data:8") == (("data", 8),)
    assert tcm.mesh_axes("data:4, model:2") == (("data", 4), ("model", 2))
    assert tcm.mesh_axes({"data": 8}) == (("data", 8),)
    assert tcm.mesh_axes((("pod", 2), ("data", 4))) == (("pod", 2),
                                                         ("data", 4))
    with pytest.raises(ValueError, match="bad mesh spec"):
        tcm.mesh_axes("data=8")
    assert tcm.mesh_data_size((("data", 8), ("model", 2))) == 8
    assert tcm.mesh_data_size((("pod", 2), ("data", 4))) == 8
    # size-1 axes drop, as in the JAX package
    for spec in ("data:8,model:1", {"data": 8, "model": 1},
                 (("data", 8), ("model", 1))):
        assert tcm.mesh_axes(spec) == (("data", 8),) == jcm.mesh_axes(spec)
    assert tcm.mesh_axes("data:1") == ()
    axes = (("data", 4), ("model", 2))
    assert tcm.mesh_data_axes(axes) == (("data", 4),)
    assert tcm.mesh_model_axes(axes) == (("model", 2),)
    assert tcm.mesh_model_size(axes) == 2
    assert tcm.mesh_model_axes((("pod", 2), ("data", 4))) == ()
    assert tcm.format_mesh(axes) == jcm.format_mesh(axes)
    assert [tcm._ring(d) for d in (1, 2, 8)] == [jcm._ring(d)
                                                 for d in (1, 2, 8)]


def test_live_mesh_and_spec_plan_identically(toys):
    """A live DeviceMesh (here over a fake group of 8) normalizes, keys
    and fingerprints like its spec."""
    from torch.distributed.device_mesh import init_device_mesh
    _, (tapply, tp, tb) = toys
    with fake_world(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        assert tcm.mesh_axes(mesh) == (("data", 8),)
        fp_live = tcm.plan_fingerprint(tapply, tp, _batch8(tb), mesh=mesh)
        # make_host_mesh's unit model axis normalizes away; two data
        # axes shard the batch over their flattened group.
        assert tcm.mesh_axes(make_host_mesh(1)) == (("data", 8),)
        pod = init_device_mesh("cpu", (2, 4),
                               mesh_dim_names=("pod", "data"))
        eng = PrivacyEngine(tapply, tp, _batch8(tb), mesh=pod, device="cpu",
                            calibration="analytic")
        assert (eng._shard.rank, eng._shard.size) == (0, 8)
        assert eng.plan().mesh == (("pod", 2), ("data", 4))
    assert fp_live == tcm.plan_fingerprint(tapply, tp, _batch8(tb),
                                           mesh="data:8")


@pytest.mark.parametrize("mode", ("flat", "per_layer", "stale"))
@pytest.mark.parametrize("mesh", ("data:8", "data:4,model:2", "pod:2,data:4"))
def test_toy_mesh_plans_match_reference(toys, mesh, mode):
    (japply, jp, jb), (tapply, tp, tb) = toys
    j = jcm.get_plan(japply, jp, jb, mesh=mesh, clip_mode=mode)
    t = tcm.get_plan(tapply, tp, tb, mesh=mesh, clip_mode=mode)
    _assert_plans_equal(j, t)
    assert t.total_coll_bytes > 0


def test_mesh_flips_planner_decisions(toys):
    """The collective-bytes terms change the plan: a stash whose
    per-example grads would cross the ring loses its free sum."""
    _, (tapply, tp, tb) = toys
    p0 = tcm.get_plan(tapply, tp, tb)
    p8 = tcm.get_plan(tapply, tp, tb, mesh="data:8")

    def dec(p):
        return {n: (lp.norm_method, p.sum_methods()[n])
                for n, lp in p.layers.items()}
    assert dec(p0) != dec(p8)
    assert p8.total_coll_bytes > 0 and p0.total_coll_bytes == 0
    assert p8.mesh == (("data", 8),)


def test_mesh_explain_has_collective_column(toys):
    _, (tapply, tp, tb) = toys
    engine = PrivacyEngine(tapply, tp, tb, mesh="data:8", device="cpu",
                           calibration="analytic")
    text = engine.explain()
    assert "coll MB" in text and "mesh=data=8" in text
    assert "mesh: data=8" in text
    plan = engine.plan()
    assert all(lp.coll_bytes > 0 for lp in plan.layers.values()
               if lp.param_bytes > 0)
    assert "per axis:" in plan.explain()


def test_mesh_in_fingerprint_and_cache_key(toys):
    _, (tapply, tp, tb) = toys
    fp0 = tcm.plan_fingerprint(tapply, tp, tb)
    fp8 = tcm.plan_fingerprint(tapply, tp, tb, mesh="data:8")
    assert fp0 != fp8
    assert fp8 == tcm.plan_fingerprint(tapply, tp, tb, mesh={"data": 8})
    assert tcm.get_plan(tapply, tp, tb).fingerprint == fp0
    assert tcm.get_plan(tapply, tp, tb, mesh="data:8").fingerprint == fp8
    eng = PrivacyEngine(tapply, tp, tb, mesh="data:8", device="cpu",
                        calibration="analytic")
    assert eng.fingerprint() != eng.fingerprint(mesh="data:4")
    assert eng.fingerprint(mesh=()) == PrivacyEngine(
        tapply, tp, tb, device="cpu", calibration="analytic").fingerprint()


@pytest.mark.parametrize("mesh", ("data:8", "data:4,model:2"))
def test_mesh_survives_json_roundtrip(toys, mesh):
    _, (tapply, tp, tb) = toys
    plan = tcm.get_plan(tapply, tp, tb, mesh=mesh)
    back = tcm.ExecPlan.from_json(plan.to_json())
    assert back == plan
    assert back.mesh == tcm.mesh_axes(mesh)
    assert back.total_coll_bytes_by_axis == plan.total_coll_bytes_by_axis
    for n, lp in plan.layers.items():
        assert back.layers[n].coll_bytes_by_axis == lp.coll_bytes_by_axis
        assert back.layers[n].model_shards == lp.model_shards


def test_stale_plan_mismatches_named(toys):
    _, (tapply, tp, tb) = toys
    plan = tcm.ExecPlan.from_json(
        tcm.get_plan(tapply, tp, tb, mesh="data:8").to_json())
    with pytest.raises(ValueError,
                       match=r"mesh shape mismatch.*data=8.*data=4"):
        tcm.check_plan_matches(plan, mesh="data:4")
    with pytest.raises(ValueError,
                       match=r"mesh shape mismatch.*data=8.*\(no mesh\)"):
        tcm.check_plan_matches(plan, mesh=())
    tcm.check_plan_matches(plan, mesh="data:8,model:1")
    with pytest.raises(ValueError, match="mesh shape mismatch"):
        tcm.check_plan_matches(plan, mesh="data:8,model:2")
    with pytest.raises(ValueError, match="mesh shape mismatch"):
        PrivacyEngine(tapply, tp, tb, plan=plan, device="cpu",
                      calibration="analytic")


def test_plan_store_across_topologies(toys, tmp_path):
    """A store written on data:8 refuses to plan this request on data:4,
    and ignores a stored plan of other knobs sharing the batch shape."""
    _, (tapply, tp, tb) = toys
    path = str(tmp_path / "plans.json")
    tcm.save_plan_store(path, [tcm.get_plan(tapply, tp, tb,
                                            mesh="data:8")])
    other = str(tmp_path / "other.json")
    tcm.save_plan_store(other, [tcm.get_plan(tapply, tp, tb, mesh="data:8",
                                             norm_method="gram")])
    try:
        tcm.clear_plan_cache()
        tcm.clear_plan_store()
        tcm.load_plan_store(path)
        with pytest.raises(ValueError, match="mesh shape mismatch"):
            tcm.get_plan(tapply, tp, tb, mesh="data:4")
        tcm.clear_plan_cache()
        tcm.clear_plan_store()
        tcm.load_plan_store(other)
        assert tcm.get_plan(tapply, tp, tb).mesh == ()
    finally:
        tcm.clear_plan_store()
        tcm.clear_plan_cache()


def _lm_specs(arch, B, T, reduced):
    jcfg, tcfg = jget(arch), tget(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=_TDT[jnp.dtype(s.dtype)], device="meta"), jp)
    if jcfg.family == "cnn":
        S = jcfg.img_size
        jb = {"img": jax.ShapeDtypeStruct((B, 3, S, S), jnp.float32),
              "label": jax.ShapeDtypeStruct((B,), jnp.int32)}
        tb = {"img": torch.empty(B, 3, S, S, device="meta"),
              "label": torch.empty(B, dtype=torch.int32, device="meta")}
    else:
        jb = {k: jax.ShapeDtypeStruct((B, T), jnp.int32)
              for k in ("tokens", "labels")}
        tb = {k: torch.empty((B, T), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
    return (jm.apply, jp, jb), (tm.apply, tp, tb)


def test_shared_param_sync_charged_once():
    """The tied embed/head group of reduced Llama-3.2-1B syncs one
    gradient, split over its two taps, as in the JAX package."""
    (ja, jp, jb), (ta, tp, tb) = _lm_specs("llama3.2-1b", 8, 16, True)
    jplan = jcm.get_plan(ja, jp, jb, mesh="data:8")
    plan = tcm.get_plan(ta, tp, tb, mesh="data:8")
    _assert_plans_equal(jplan, plan)
    tied = [g for g in plan.groups if len(g.members) > 1]
    assert tied
    g = tied[0]
    ring = 2.0 * 7 / 8
    pb = max(plan.layers[n].param_bytes for n in g.members)
    norm = sum((plan.layers[n].stash_bytes if plan.layers[n].stash
                else plan.layers[n].ex_per_dev * 8 * 4) * ring
               for n in g.members)
    got = sum(plan.layers[n].coll_bytes for n in g.members)
    assert got == pytest.approx(norm + pb * ring)


def test_2d_per_axis_collective_pricing_hand_computed():
    """data:4,model:2 on reduced Llama-3.2-1B: each tensor-sharded
    layer's bytes are the per-axis sum — scalar norms and the sync on the
    data ring, partial norms on the model ring — equal to the JAX
    package's; the predicted step prices each axis at its own rate."""
    (ja, jp, jb), (ta, tp, tb) = _lm_specs("llama3.2-1b", 8, 16, True)
    jplan = jcm.get_plan(ja, jp, jb, mesh="data:4,model:2",
                         calibration=None)
    plan = tcm.get_plan(ta, tp, tb, mesh="data:4,model:2",
                        calibration="analytic")
    _assert_plans_equal(jplan, plan)
    sharded = {n: lp for n, lp in plan.layers.items() if lp.model_shards > 1}
    assert sharded
    ring_d, ring_m = 2.0 * 3 / 4, 2.0 * 1 / 2
    by_group = {m: g for g in plan.groups for m in g.members}
    for name, lp in sharded.items():
        g = by_group[name]
        pb = max(plan.layers[m].param_bytes for m in g.members)
        sync = pb * (2.0 if g.sum_method == "backward" else 1.0) \
            / len(g.members)
        norm = lp.stash_bytes if lp.stash else lp.ex_per_dev * 4 * 4
        want = {"data": (norm + sync) * ring_d,
                "model": lp.ex_per_dev * 4 * 4 * ring_m}
        assert dict(lp.coll_bytes_by_axis) == pytest.approx(want), name
        assert lp.coll_bytes == pytest.approx(sum(want.values())), name
    # Per-axis prices (data 16e9, model 2e9 B/s at 1e12 FLOP/s), as the
    # JAX package's injected calibration resolves them.
    jc = jcm.resolve_cost_constants(
        __import__("repro.calibrate", fromlist=["injected"]).injected(
            mesh="data:4,model:2", flops_per_second=1e12,
            collective_bytes_per_second={"data": 16e9, "model": 2e9}),
        jplan.mesh)
    cc = tcm.CostConstants(
        collective_flops_per_byte=jc.collective_flops_per_byte,
        hbm_flops_per_byte=jc.hbm_flops_per_byte,
        flops_per_second=jc.flops_per_second,
        collective_flops_per_byte_by_axis=jc.
        collective_flops_per_byte_by_axis)
    assert cc.coll_price("data") == pytest.approx(1e12 / 16e9)
    assert cc.coll_price("model") == pytest.approx(1e12 / 2e9)
    import dataclasses
    no_coll = dataclasses.replace(plan, total_coll_bytes=0.0,
                                  total_coll_bytes_by_axis=())
    wire = tcm.predicted_step_flops(plan, cc) \
        - tcm.predicted_step_flops(no_coll, cc)
    want_wire = sum(cc.coll_price(a) * b
                    for a, b in plan.total_coll_bytes_by_axis)
    assert wire == pytest.approx(want_wire)
    assert want_wire < cc.collective_flops_per_byte * plan.total_coll_bytes
    np.testing.assert_allclose(tcm.predicted_step_flops(plan, cc),
                               jcm.predicted_step_flops(jplan, jc),
                               rtol=1e-9)


@pytest.mark.parametrize("mesh", ("data:8", "data:4,model:2"))
@pytest.mark.parametrize("arch,B,T", (("alexnet", 32, 0),
                                      ("llama3.2-1b", 8, 1024)))
def test_full_width_meta_plans_match_reference(arch, B, T, mesh):
    (ja, jp, jb), (ta, tp, tb) = _lm_specs(arch, B, T, False)
    _assert_plans_equal(jcm.get_plan(ja, jp, jb, mesh=mesh),
                        tcm.get_plan(ta, tp, tb, mesh=mesh,
                                     calibration="analytic"))


def test_calibration_per_mesh(monkeypatch, toys):
    """Calibrations are keyed by (hardware, mesh); a multi-axis one
    warns on an axis-less price; a planning-only spec never measures and
    a pure-data mesh keeps the analytic constants by default."""
    c = calibrate.injected(mesh="pod:2,data:4", device="cpu",
                           flops_per_second=1e12,
                           collective_bytes_per_second={"pod": 2e9,
                                                        "data": 16e9})
    with pytest.warns(calibrate.CalibrationAxisFallbackWarning):
        assert c.collective_flops_per_byte() == pytest.approx(1e12 / 2e9)
    assert c.collective_flops_per_byte("data") == pytest.approx(1e12 / 16e9)
    with pytest.raises(calibrate.CalibrationMeshMismatch):
        c.collective_flops_per_byte("model")
    with pytest.raises(calibrate.CalibrationMeshMismatch):
        c.validate_for(calibrate.hardware_signature("cpu"), "data:8")
    c8 = calibrate.injected(mesh="data:8", device="cpu",
                            collective_bytes_per_second=8e9)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert c8.collective_flops_per_byte() == pytest.approx(1e12 / 8e9)
    back = calibrate.Calibration.from_json(c8.to_json())
    assert back == c8 and back.mesh == (("data", 8),)
    retimed = c8.retimed(predicted_s=1.0, measured_s=2.0, coll_bytes=1e9,
                         coll_bytes_by_axis=(("data", 1e9),))
    assert retimed.flops_per_second == c8.flops_per_second
    assert retimed.collective_bytes_per_second["data"] < 8e9

    def boom(*a, **k):
        raise AssertionError("measure() ran for a planning-only engine")

    monkeypatch.setattr(calibrate, "measure", boom)
    calibrate.clear_registry()
    try:
        _, (tapply, tp, tb) = toys
        assert PrivacyEngine(tapply, tp, tb, mesh="data:4,model:2",
                             device="cpu").calibration is None
        assert PrivacyEngine(tapply, tp, tb, mesh="data:8",
                             device="cpu").calibration is None
        calibrate.register(c8)
        assert calibrate.lookup("cpu", mesh="data:8") is c8
        assert calibrate.lookup("cpu") is None
        eng = PrivacyEngine(tapply, tp, tb, mesh="data:8", device="cpu")
        assert eng.calibration is c8
        assert eng.plan().calibration == c8.digest()
        from repro_torch.calibrate import harness
        with pytest.raises(calibrate.CalibrationMeshMismatch,
                           match="no process group"):
            harness.measure_collective_bytes_per_second("data", 2,
                                                        device="cpu")
    finally:
        calibrate.clear_registry()
        tcm.clear_plan_cache()


# ---------------------------------------------------------------------------
# launch.sharding against the JAX package's PartitionSpecs


def _jax_specs(axes_tree, params, fsdp):
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 4, "model": 2})
    rules = jsh.FSDP_PARAM_RULES if fsdp else jsh.PARAM_RULES
    return jax.tree.map(
        lambda a, leaf: tuple(jsh._axes_to_spec(a, rules, mesh,
                                                tuple(leaf.shape))),
        axes_tree, params, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("arch", ("llama3.2-1b", "granite-moe-1b-a400m",
                                  "alexnet"))
def test_param_specs_match_reference(arch, fsdp):
    jm, tm = jbuild(jget(arch).reduced()), tbuild(tget(arch).reduced())
    box = {}

    def init(k):
        p, box["axes"] = jm.init(k)
        return p
    jp = jax.eval_shape(init, jax.random.PRNGKey(0))
    jaxes = box["axes"]
    tp, taxes = tm.init(0, device="cpu")
    want = _jax_specs(jaxes, jp, fsdp)
    got = tsh.param_sharding(taxes, "data:4,model:2", fsdp=fsdp,
                             shapes_tree=tp)
    assert leaf_paths(got) == leaf_paths(want)
    for p in leaf_paths(want):
        assert get_subtree(got, p) == get_subtree(want, p), p
    assert any(get_subtree(got, p) for p in leaf_paths(got))
    assert tsh.param_sharding(taxes, "data:4,model:2", fsdp=fsdp) \
        is not None
    assert tsh.ACT_RULES == jsh.ACT_RULES


def test_batch_sharding_requires_a_data_axis():
    with pytest.raises(ValueError, match="no data-parallel axis"):
        tsh.batch_sharding({"x": torch.zeros(4, 2)}, "model:1")
    assert tsh.batch_sharding({"x": torch.zeros(4, 2)}, "batch:1") \
        == {"x": ("batch",)}
    assert tsh.batch_sharding({"x": 0}, "pod:2,data:4,model:2") \
        == {"x": (("pod", "data"),)}


# ---------------------------------------------------------------------------
# Execution: gloo on the CPU, 4 ranks then 2


@pytest.fixture(scope="module")
def runs(toys, tmp_path_factory):
    _, (_, tp, tb) = toys
    base = tmp_path_factory.mktemp("shard")
    data = {"params": tp, "batch": _batch8(tb)}
    out = {4: sw.run_world(4, str(base), data)}
    out[2] = sw.run_world(2, str(base), data)
    out["dir"] = base
    return out


def _single(toys, **kw):
    _, (_, tp, tb) = toys
    batch = _batch8(tb)
    return sw.run_steps(sw.make_engine(tp, batch, **kw), tp, batch)


@pytest.mark.parametrize("sigma", (0.0, 1.3))
@pytest.mark.parametrize("mode", ("flat", "per_layer", "stale"))
def test_sharded_step_matches_single_device(runs, toys, mode, sigma):
    p1, _, l1 = _single(toys, mode=mode, sigma=sigma)
    r0, r1 = (r[f"step_{mode}_{sigma}"] for r in runs[2])
    assert _bitwise(r0[0], r1[0]) and _bitwise(r0[1], r1[1])
    assert _maxdiff(r0[0], p1) < 1e-6
    np.testing.assert_allclose(r0[2], l1, rtol=1e-5)


def test_four_ranks_and_repeat_runs(runs, toys):
    p1 = _single(toys)[0]
    r = [x["sigma0_flat"] for x in runs[4]]
    assert all(_bitwise(r[0], x) for x in r[1:])
    assert _maxdiff(r[0], p1) < 1e-6
    for x in runs[2]:
        assert _bitwise(x["repeat_flat_1.3"], runs[2][0]["step_flat_1.3"][0])


def test_sharded_step_matches_jax_package(runs, toys):
    (japply, jp, jb), _ = toys
    jbatch = jax.tree.map(lambda a: jnp.concatenate([a, a]), jb)
    jeng = JPrivacyEngine(
        japply, jp, jbatch, dp=JDPConfig(l2_clip=0.1), lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    params, opt, losses = jp, jadamw_init(jp), []
    for s in range(2):
        b = jax.tree.map(lambda a: jnp.roll(a, s, 0), jbatch)
        params, opt, loss, _ = jeng.private_step(params, opt, b)
        losses.append(float(loss))
    got_p, _, got_l = runs[2][0]["jax_parity"]
    np.testing.assert_allclose(got_l, losses, rtol=1e-4)
    want = jax.tree.map(np.asarray, params)
    for p in leaf_paths(want):
        np.testing.assert_allclose(get_subtree(got_p, p).numpy(),
                                   get_subtree(want, p), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))


def _oracle(toys, mode):
    """Σ_b clip(g_b) / B from the naive per-example gradients; per_layer
    clips each group at its uniform budget C/√G."""
    _, (tapply, tp, tb) = toys
    batch = _batch8(tb)
    _, pe = tstrat.naive_per_example_grads(tapply, tp, batch)
    C, B = 0.1, 8
    groups = [("conv1",), ("emb",), ("blocks", "fc"), ("blocks", "nrm"),
              ("head",)]

    def sq(paths):
        return sum(get_subtree(pe, p).reshape(B, -1).square().sum(1)
                   for p in paths)
    paths = leaf_paths(pe)
    out = {}
    if mode == "per_layer":
        for g in groups:
            mine = [p for p in paths if p[:len(g)] == g]
            coef = torch.clamp(C / len(groups) ** 0.5
                               / (sq(mine).sqrt() + 1e-12), max=1.0)
            for p in mine:
                out[p] = torch.einsum("b...,b->...", get_subtree(pe, p),
                                      coef) / B
    else:
        coef = torch.clamp(C / (sq(paths).sqrt() + 1e-12), max=1.0)
        for p in paths:
            out[p] = torch.einsum("b...,b->...", get_subtree(pe, p),
                                  coef) / B
    return out


@pytest.mark.parametrize("mode", ("flat", "per_layer", "stale"))
def test_sharded_step_passes_oracle(runs, toys, mode):
    want = _oracle(toys, mode)
    scale = max(float(w.abs().max()) for w in want.values())
    got = [runs[2][0][f"oracle_{mode}"]]
    if mode == "stale":
        got.append(runs[2][0]["oracle_stale_steady"])
    for g in got:
        for p, w in want.items():
            np.testing.assert_allclose(get_subtree(g, p).numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=str(p))
    aux = runs[2][0][f"oracle_{mode}_aux"]
    assert aux["per_example_norms"].shape == (8,)
    if mode == "per_layer":
        assert aux["per_layer_norms"].shape == (5, 8)
    for r in runs[2][1:]:
        assert _bitwise(r[f"oracle_{mode}"], runs[2][0][f"oracle_{mode}"])


@pytest.mark.parametrize("mode", ("flat", "stale"))
def test_kill_and_resume_bit_identical_sharded(runs, mode):
    for r in runs[2]:
        ref_p, ref_o, got_p, got_o, steps = r[f"resume_{mode}"]
        assert _bitwise(ref_p, got_p) and _bitwise(ref_o, got_o)
        assert steps == sw.STEPS


def test_elastic_resume_replans_onto_smaller_mesh(runs):
    assert all(r["elastic_killed"] for r in runs[4])
    r0 = runs[2][0]
    assert r0["elastic_axes"] == ((("data", 4),), (("data", 2),))
    ckpt_fp, live_fp, rekeyed_fp = r0["elastic_fingerprints"]
    assert ckpt_fp != live_fp and ckpt_fp == rekeyed_fp
    got_p, steps, ledger = r0["elastic_resumed"]
    assert steps == sw.STEPS                       # no ledger gap
    assert _maxdiff(got_p, runs[4][0]["elastic_ref"]) < 1e-6
    assert _bitwise(got_p, runs[2][1]["elastic_resumed"][0])


def _final_arrays(d, step):
    import os
    from repro_torch.checkpoint import Checkpointer
    ck = Checkpointer(d)
    assert ck.latest_step() == step
    with np.load(os.path.join(d, f"step_{step:09d}", "arrays.npz")) as z:
        return dict(z), ck.read_meta(step)


def test_cli_mesh_kill_resume_and_elastic(runs, tmp_path_factory):
    """``launch.train --mesh data:2 --backend gloo`` on two ranks: killed
    before step 2, it resumes to the straight run's checkpoint bitwise,
    which records the mesh; a data:4 run's checkpoint resumes with no
    ``--mesh`` on two ranks, collapsed by ``elastic_mesh_axes``."""
    base = runs["dir"]
    outs = runs[2][0]["cli_out"]
    assert "[restore] resuming from step 2" in outs["cli_killed"]
    a, ma = _final_arrays(str(base / "cli_straight"), 3)
    b, mb = _final_arrays(str(base / "cli_killed"), 3)
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ma["mesh_axes"] == [["data", 2]] and ma["ledger"] == mb["ledger"]
    assert "[elastic] checkpoint mesh data=4 -> data=2" in outs["cli_elastic"]
    assert "[restore] resuming from step 2" in outs["cli_elastic"]
    e, me = _final_arrays(str(base / "cli_elastic"), 3)
    assert me["mesh_axes"] == [["data", 2]] and me["ledger"]["steps"] == 4
    assert "['clip']['prev_norms_sq']" in e
    assert e["['clip']['prev_norms_sq']"].shape == (8,)


def test_live_mesh_verifies_its_own_rank(runs):
    for r, x in enumerate(runs[2]):
        ok, sharding = x["live_verify"]
        assert ok and f"rank(s) [{r}] of 2" in sharding


def test_collective_calibration_over_the_group(runs):
    """``calibrate.measure("data:2")`` times the ring all-reduce over the
    gloo group; the ranks hold one calibration, keyed by the mesh."""
    cals = [calibrate.Calibration.from_payload(r["calibration"])
            for r in runs[2]]
    assert cals[0].digest() == cals[1].digest()
    assert cals[0].mesh == (("data", 2),)
    assert cals[0].collective_bytes_per_second["data"] > 0


def test_indivisible_batch_and_model_axis_raise(runs):
    """An indivisible batch still raises.  A live model axis runs (item
    14 parts 2 and 3, ``tests/test_torch_model_axis.py``,
    ``tests/test_torch_moe_model_axis.py``, ``tests/
    test_torch_attn_model_axis.py`` and ``tests/
    test_torch_recurrent_model_axis.py``); what it leaves out raises
    naming item 14 part 3: block taps (MLA's, GQA's) beside sliced
    heads, serving against a latent, KV or cross cache or a recurrent
    state there.  ``fsdp=True`` runs now: one FSDP step on the live
    ``data:2`` mesh keeps each rank's data slices and equals the
    replicated step (``tests/test_torch_fsdp.py`` holds the rest)."""
    r0 = runs[2][0]
    assert "not divisible" in r0["indivisible"]
    assert "degree 2" in r0["indivisible"]
    got = r0["model_axis"]
    assert sorted(got) == sorted(
        tuple(sw.DP_ATTN_ARCHS) + tuple(sw.RECURRENT_SERVE)
        + ("mla-cache", "gqa-cache", "cross-cache", "fsdp"))
    for case, msg in got.items():
        if case != "fsdp":
            assert "item 14 part 3" in msg, (case, msg)
    assert "MLA with block taps (dp_attn)" in got["mla-dp_attn"]
    assert "block taps (dp_attn) on a model axis" in got["gqa-dp_attn"]
    assert "MLA with a latent cache" in got["mla-cache"]
    assert "a KV cache beside sliced heads" in got["gqa-cache"]
    assert "self and cross caches beside sliced heads" in \
        got["cross-cache"]
    assert "serving the ssm family on a model axis" in got["ssm-serve"]
    assert "serving the hybrid family on a model axis" in \
        got["hybrid-serve"]
    assert got["fsdp"] == "ran"
