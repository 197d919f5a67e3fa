"""FSDP on a live mesh in the port (ROADMAP item 14 part 3).

``PrivacyEngine(mesh=<live data:D[,model:M]>, param_axes=axes,
fsdp=True)`` slices every ``embed`` dimension over the data axes too
(``launch.sharding.FSDP_PARAM_RULES``): between steps each rank holds
the ``(data, model)`` slice of such a leaf and of its moments; the step
gathers each over the data group at its start, sums each clipped
gradient over data keeping the rank's slice, and adds the rank's slice
of the one full noise draw.

Execution on gloo over the CPU: one ``data:2,model:2`` world (4 ranks)
and one ``data:2`` world (2 ranks), started together (``tests/
torch_fsdp_worker.py``); the 2-rank world computes the single-device
references too, the parent the JAX package's.  Reduced GLM-4-9B,
StableLM-12B, Chameleon-34B and DeepSeek-V3 (the four configs that set
``fsdp``).  Checked:

* 2 steps at σ = 1 (AdamW) under every strategy but ``multi`` and every
  clipping mode, on each mesh: FSDP equals the replicated step on the
  same mesh within 1e-7 of each leaf's largest coordinate (params and
  moments gathered, losses), two FSDP runs are bitwise equal, and the
  moments are within 1e-6 of one device's (the params as far as the
  replicated step's);
* each rank's persistent params and moments are its slices, 1/D of its
  model slice wherever D divides ``embed``; a leaf it does not divide
  stays replicated over data (a toy of widths 6 and 5);
* σ = 0 on data:2,model:2 under FSDP equals the JAX package's step;
* kill and resume under FSDP is bitwise; a resume crosses FSDP on /
  off, data degree 2 -> 1 -> 2 and model degree 1 -> 2 -> 1;
* ``verify()`` is clean on the live FSDP lanes, and the data-slice
  half flags three mutants: every data rank keeping rank 0's slice
  (``fsdp_slice_mismatch``), every data rank adding rank 0's noise slice
  (``noise_slice_mismatch``), a leaf skipping its sum over data
  (``grad_sync_missing``);
* the plans and the fingerprint do not change with ``fsdp``;
  checkpoints record the writer's ``fsdp``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_fsdp_worker as fw  # noqa: E402
import torch_moe_model_axis_worker as xw  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import DPConfig as JDPConfig  # noqa: E402
from repro.core import PrivacyEngine as JPrivacyEngine  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import sgdm_init as jsgdm_init  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.train import make_batch_fn, to_device  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = fw.ARCHS
B, T = 8, 16
MESHES = {4: "data:2,model:2", 2: "data:2"}


def _leaves(tree):
    return [get_subtree(tree, p) for p in leaf_paths(tree)]


def _rel_each(a, b):
    """The largest |a - b| of each leaf over that leaf's largest |b|."""
    return max(float((x.float() - y.float()).abs().max()
                     / y.float().abs().max().clamp_min(1e-30))
               for x, y in zip(_leaves(a), _leaves(b)))


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(arch):
    cfg = jget(arch).reduced()
    jparams, _ = jbuild(cfg).init(jax.random.PRNGKey(0))
    like, axes = fw.lm_model(arch).init(0, device="cpu")
    params = params_from_numpy(_np(jparams), like=like, device="cpu")
    bf = make_batch_fn(cfg, B, T)
    return {"params": params, "axes": axes,
            "batches": [to_device(bf(s), "cpu") for s in range(2)]}, \
        (jparams, [bf(s) for s in range(2)])


def _toy():
    g = torch.Generator().manual_seed(0)
    params = {"a": {"w": torch.randn(6, 4, generator=g)},
              "b": {"w": torch.randn(5, 3, generator=g)}}
    batches = [{"x": torch.randn(B, 6, generator=g),
                "z": torch.randn(B, 5, generator=g)} for _ in range(2)]
    return {"params": params, "axes": fw.TOY_AXES, "batches": batches}


def _jax_steps(arch, jparams, jbatches):
    jmodel = jbuild(jget(arch).reduced())
    eng = JPrivacyEngine(jmodel.apply, jparams, jbatches[0],
                         dp=JDPConfig(l2_clip=1.0, noise_multiplier=0.0),
                         optimizer="sgdm", lr=1e-2, calibration="analytic")
    p, o, losses = jparams, jsgdm_init(jparams), []
    for b in jbatches:
        p, o, loss, _ = eng.private_step(p, o, b)
        losses.append(float(loss))
    return _np(p), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("fsdp")
    data, jin = {"toy": _toy()}, {}
    for arch in ARCHS:
        data[arch], jin[arch] = _inputs(arch)
    w4, w2 = base / "w4", base / "w2"
    ctx4 = fw.start(4, str(w4), data)
    ctx2 = fw.start(2, str(w2), data)
    ref = {"jax": {a: _jax_steps(a, *jin[a]) for a in ARCHS}}
    out = {4: xw.join(ctx4, 4, str(w4)), 2: xw.join(ctx2, 2, str(w2))}
    ref["single"] = {**out[2][0]["single"], **out[2][1]["single"]}
    out.update(ref=ref, data=data)
    return out


def _lane_id(lane):
    return "-".join(str(x) for x in lane)


ALL_LANES = [(w,) + lane for w in (4, 2) for lane in fw.lanes_of(w)]


# ---------------------------------------------------------------------------
# FSDP against the replicated step and one device


@pytest.mark.parametrize("lane", ALL_LANES, ids=_lane_id)
def test_fsdp_matches_replicated_step(runs, lane):
    """σ = 1, 2 AdamW steps: FSDP's gathered params and moments within
    1e-7 of each leaf's largest coordinate of the replicated step's on
    the same mesh, the losses equal; the two FSDP runs bitwise equal."""
    world, lane = lane[0], lane[1:]
    for r in runs[world]:
        rep = r["steps"][lane + ("replicated",)]
        got = r["steps"][lane + ("fsdp",)]
        again = r["steps"][lane + ("fsdp_again",)]
        assert _rel_each(got["params"], rep["params"]) <= 1e-7
        assert _rel_each(got["opt"]["m"], rep["opt"]["m"]) <= 1e-7
        assert _rel_each(got["opt"]["v"], rep["opt"]["v"]) <= 1e-7
        assert got["losses"] == rep["losses"]
        assert _bitwise(got["params"], again["params"])
        assert _bitwise(got["opt"], again["opt"])


@pytest.mark.parametrize("lane", ALL_LANES, ids=_lane_id)
def test_fsdp_matches_one_device(runs, lane):
    """The FSDP step against one device's: the AdamW moments, which carry
    the released gradients, within 1e-6 of each leaf's largest
    coordinate, the losses within 1e-5.  AdamW's params divide by
    √v, which magnifies the sum order's rounding where a gradient is near
    zero (up to 2.4e-6 of a leaf's largest here): the replicated step on
    the same mesh is as far from one device, and FSDP adds nothing to
    that distance.  Both stay within 1e-5 of one device, so a drift the
    two mesh paths share cannot pass."""
    world, lane = lane[0], lane[1:]
    want = runs["ref"]["single"][lane]
    got = runs[world][0]["steps"][lane + ("fsdp",)]
    rep = runs[world][0]["steps"][lane + ("replicated",)]
    assert _rel_each(got["opt"]["m"], want["opt"]["m"]) < 1e-6
    assert _rel_each(got["opt"]["v"], want["opt"]["v"]) < 1e-6
    assert _rel_each(got["params"], want["params"]) <= \
        _rel_each(rep["params"], want["params"]) + 1e-7
    assert _rel_each(got["params"], want["params"]) < 1e-5
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)


@pytest.mark.parametrize("world", (4, 2), ids=MESHES.get)
def test_persistent_leaves_are_data_slices(runs, world):
    """Each rank's persistent params are its (data, model) slices: every
    leaf with an ``embed`` dimension (all even in the reduced configs)
    has it halved beside the model slicing, and the AdamW moments are
    f32 slices of the same shapes."""
    for arch, strategy, mode in fw.lanes_of(world):
        d = runs["data"][arch]
        specs = sh.param_sharding(d["axes"], MESHES[world], fsdp=True,
                                  shapes_tree=d["params"])
        m = 2 if world == 4 else 1
        for p in leaf_paths(specs):
            assert bool(sh.data_dims(get_subtree(specs, p))) == (
                "embed" in get_subtree(d["axes"], p)), p
        for r in runs[world]:
            lane = r["steps"][(arch, strategy, mode, "fsdp")]
            rep = r["steps"][(arch, strategy, mode, "replicated")]
            numel = 0
            for p, got in lane["shapes"].items():
                spec = get_subtree(specs, p)
                full = tuple(get_subtree(d["params"], p).shape)
                assert got == sh.local_shape(full, spec, m, 2), p
                numel += int(np.prod(got))
            assert lane["bytes"][0] == numel * 4          # f32 params
            assert lane["bytes"][1] == 2 * numel * 4 + 4  # m, v, step
            assert lane["bytes"][0] < rep["bytes"][0]


def test_indivisible_leaf_stays_replicated(runs):
    """The toy on data:2: ``a`` (embed 6) sliced to 3 rows a rank, ``b``
    (embed 5) whole on both ranks; FSDP equals the replicated step."""
    for r in runs[2]:
        rep, got = r["toy"][False], r["toy"][True]
        assert got["shapes"] == {("a", "w"): (3, 4), ("b", "w"): (5, 3)}
        assert _rel_each(got["params"], rep["params"]) <= 1e-7
        assert _rel_each(got["opt"]["v"], rep["opt"]["v"]) <= 1e-7
    specs = sh.param_sharding(fw.TOY_AXES, "data:2", fsdp=True,
                              shapes_tree=runs["data"]["toy"]["params"])
    assert specs == {"a": {"w": ("data",)}, "b": {"w": ()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_sigma0_matches_jax_package(runs, arch):
    """σ = 0 under FSDP on data:2,model:2: the gathered params equal the
    JAX package's single-device step from the same params and
    batches."""
    want_p, want_l = runs["ref"]["jax"][arch]
    got_p, got_l = runs[4][0]["jax"][arch]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for p in leaf_paths(want_p):
        np.testing.assert_allclose(get_subtree(got_p, p).float().numpy(),
                                   get_subtree(want_p, p), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))
    for r in runs[4][1:]:
        assert _bitwise(got_p, r["jax"][arch][0])


# ---------------------------------------------------------------------------
# Checkpoints


def test_kill_and_resume_bitwise(runs):
    """data:2,model:2 under FSDP: killed before step 2 and resumed from
    the whole-array checkpoint, every rank ends bitwise where the
    straight run ends, on its slices."""
    for r in runs[4]:
        assert _bitwise(r["resumed"]["params"], r["straight"]["params"])
        assert _bitwise(r["resumed"]["opt"], r["straight"]["opt"])
        assert r["resumed"]["shapes"] == r["straight"]["shapes"]


def test_resume_across_fsdp_and_degrees(runs):
    """A checkpoint resumes across FSDP off (data:2,model:2, within 1e-7
    of each leaf's largest), data degree 2 -> 1 -> 2 and model degree 1
    -> 2 -> 1 (data:2 -> data:1,model:2 -> data:2, within 1e-6)."""
    for r in runs[4]:
        assert _rel_each(r["resumed_fsdp_off"]["params"],
                         r["straight"]["params"]) <= 1e-7
        assert _rel_each(r["resumed_fsdp_off"]["opt"]["m"],
                         r["straight"]["opt"]["m"]) <= 1e-7
    for r in runs[2]:
        assert r["on_model2"]["died"]
        whole = {p: tuple(get_subtree(runs["data"][fw.RESUME_ARCH]["params"],
                                      p).shape)
                 for p in r["on_model2"]["shapes"]}
        assert r["on_model2"]["shapes"] != whole   # sliced over model
        assert _rel_each(r["back_on_data2"]["params"],
                         r["straight"]["params"]) < 1e-6
        assert _rel_each(r["back_on_data2"]["opt"]["v"],
                         r["straight"]["opt"]["v"]) < 1e-6


def test_checkpoint_records_fsdp(tmp_path):
    """``DPTrainState.fsdp`` round-trips (the arrays are whole either
    way); an older checkpoint without it reads as ``False``."""
    from repro_torch.checkpoint import Checkpointer, DPTrainState
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.ones(2, 3)}
    for step, flag in ((0, True), (1, False)):
        ck.save_state(step, DPTrainState(params=tree, opt={}, fsdp=flag))
        st, at = ck.restore_state(tree, {}, step=step)
        assert (st.fsdp, at) == (flag, step)
        assert torch.equal(st.params["w"], tree["w"])


# ---------------------------------------------------------------------------
# The verifier


@pytest.mark.parametrize(
    "world,rank", [(w, r) for w in (4, 2) for r in range(w)],
    ids=[f"{MESHES[w]}-{_lane_id(fw.VERIFY_LANES[w][r])}"
         for w in (4, 2) for r in range(w)])
def test_verify_fsdp_clean(runs, world, rank):
    """Each rank's live FSDP trace reports the one-device verdict, and
    the sharding pass read its data-slice half: no finding, but for
    DeepSeek-V3's gather dispatch, whose slot competition is an
    ``unclipped_batch_reduction`` on one device too (``tests/
    test_torch_dpcheck.py``, ``tests/test_torch_moe_model_axis.py``)."""
    codes, sharding = runs[world][rank]["verify"]
    arch = fw.VERIFY_LANES[world][rank][0]
    assert codes == (["unclipped_batch_reduction"]
                     if arch == "deepseek-v3-671b" else []), codes
    assert "FSDP:" in sharding


def _fake_codes(mesh="data:2"):
    """Error codes of the toy's bk step under FSDP on a mesh spec (the
    verifier traces data ranks 0 and 1 of a fake group; on the 2D mesh
    the last model rank too)."""
    from repro_torch.core import costmodel
    costmodel.clear_plan_cache()
    eng = fw.engine(fw.toy_apply, _toy(), strategy="bk", mesh=mesh,
                    fsdp=True)
    rep = eng.verify()
    return sorted({f.code for f in rep.errors}), rep.checked["sharding"]


def _keep_rank0_slice(t, dim, ds):
    return sh._own(sh.all_reduce(t, ds.group, axis="data"), dim,
                   dataclasses.replace(ds, rank=0)).clone()


def _no_data_sum(t, dim, ds):
    return sh._own(t, dim, ds).clone()


def _rank0_noise(real):
    def add_noise(*a, data=None, **kw):
        return real(*a, data=None if data is None
                    else dataclasses.replace(data, rank=0), **kw)
    return add_noise


@pytest.mark.parametrize("mesh", ("data:2", "data:2,model:2"))
def test_verify_fake_world_clean(mesh):
    """Traced over a fake world (data ranks 0 and 1, and on the 2D mesh
    the last model rank), the FSDP step reports no finding."""
    codes, sharding = _fake_codes(mesh)
    assert codes == [], codes
    assert "traced as data rank(s) [0, 1]" in sharding


@pytest.mark.parametrize("name,code", (
    ("rank0_slice", "fsdp_slice_mismatch"),
    ("rank0_noise", "noise_slice_mismatch"),
    ("no_data_sum", "grad_sync_missing")))
def test_verify_flags_fsdp_mutants(monkeypatch, name, code):
    """Every data rank keeping rank 0's slice of the sum, every data
    rank adding rank 0's noise slice, and a leaf released without its
    sum over data: each reported under its own finding, and only it."""
    from repro_torch.core import clipping
    if name == "rank0_slice":
        monkeypatch.setattr(sh, "reduce_scatter_to_data", _keep_rank0_slice)
    elif name == "no_data_sum":
        monkeypatch.setattr(sh, "reduce_scatter_to_data", _no_data_sum)
    else:
        monkeypatch.setattr(clipping, "add_noise",
                            _rank0_noise(clipping.add_noise))
    codes, _ = _fake_codes()
    assert codes == [code], codes


# ---------------------------------------------------------------------------
# Plans and fingerprints


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_fingerprint_unchanged_by_fsdp(arch):
    """The plan on data:2,model:2 (its layers and collective bytes by
    axis) and the fingerprint are the same with and without FSDP: the
    step does the same work, and its param gathers are unpriced, as in
    the JAX package."""
    from repro_torch.core import costmodel
    model = fw.lm_model(arch)
    params, axes = model.init(0, device="meta")
    batch = {k: torch.zeros((B, T), dtype=torch.int32)
             for k in ("tokens", "labels")}
    d = {"params": params, "axes": axes, "batches": [batch]}
    plans = []
    for fsdp in (False, True):
        costmodel.clear_plan_cache()
        eng = fw.engine(model.apply, d, mesh="data:2,model:2", fsdp=fsdp)
        assert eng.fsdp is fsdp
        plans.append((eng.fingerprint(), eng.plan()))
    (f0, p0), (f1, p1) = plans
    assert f0 == f1
    assert p0.realizations() == p1.realizations()
    assert p0.total_coll_bytes_by_axis == p1.total_coll_bytes_by_axis


def test_fsdp_needs_param_axes():
    d = fw.lm_model("glm4-9b")
    params, _ = d.init(0, device="meta")
    batch = {k: torch.zeros((B, T), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="fsdp=True needs param_axes"):
        fw.engine(d.apply, {"params": params, "axes": None,
                            "batches": [batch]}, mesh="data:2", fsdp=True)
