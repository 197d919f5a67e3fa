"""The MoE family on a model axis in the port (ROADMAP item 14, part 3).

``PrivacyEngine(mesh=<live data:D,model:M>, param_axes=axes)`` runs
reduced Granite-3.0-1B-A400M (GQA, 4 experts top-2) and reduced
DeepSeek-V3-671B (MLA, 4 experts top-2, a shared expert) with the routed
experts sliced over ``model`` by the ``"expert"`` rule, the router's
columns with them, MLA's per-head projections by ``"heads"`` beside its
replicated latent path, and the shared expert by ``"mlp"``.

Execution on gloo over the CPU: one ``data:2,model:2`` world (4 ranks)
and one world of 2 ranks (``model:2``, and ``data:2`` over the same
processes), each spawned once for the module (``tests/
torch_moe_model_axis_worker.py``); the parent computes every
single-device and JAX reference while a world runs.  Checked:

* 2 steps at σ = 0.8 on data:2,model:2 equal the port's single-device
  step within 1e-6 for every strategy but ``multi`` under flat,
  per_layer and stale clipping (the gather dispatch), and for three
  lanes each of the einsum and sort dispatches; the ranks of one model
  slot are bitwise equal; the expert leaves are slices;
* at σ = 0 on model:2 the gathered params equal the JAX package's
  single-device step (rtol 1e-4, atol 1e-6): einsum and gather against
  the JAX package's, sort against the port's gather (the JAX package's
  sort dispatch is its gather's semantics);
* the global capacity on a data axis (fault F6): reduced Granite on
  ``data:2`` at a capacity factor where entries drop, under gather and
  sort, equals the JAX package's single-device gather step at σ = 0;
* mutants: the combine weights' cotangent left unsummed over ``model``
  (the router's gradient), MLA's ``cq``, ``ckv`` or ``k_rope`` without
  their copy to ``model``, an expert group's partial norm² not summed:
  each released gradient misses one device's by far more than the
  clean lane's 1e-6;
* the plans on data:2,model:2 equal the JAX package's ``get_plan``
  (decisions, ``model_shards``, collective bytes);
* a data:2,model:2 checkpoint holds whole arrays and resumes on one
  device within 1e-6 of the 2D run;
* the verifier's live data:2,model:2 trace (each rank one lane): no
  model-half finding, the one finding the one-device run's; an unsummed
  expert norm² flagged (``model_norm_sum_missing``).  ``dpcheck --mesh
  data:2,model:2`` on both archs is in ``tests/test_torch_dpcheck.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_model_axis_worker as mw  # noqa: E402
import torch_moe_model_axis_worker as xw  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import DPConfig as JDPConfig  # noqa: E402
from repro.core import PrivacyEngine as JPrivacyEngine  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import sgdm_init as jsgdm_init  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.train import make_batch_fn, to_device  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = xw.ARCHS
MODEL_CODES = ("model_norm_sum_missing", "model_norm_sum_repeated",
               "model_norm_overcount", "model_contrib_reduced",
               "noise_slice_mismatch")


def _leaves(tree):
    return [get_subtree(tree, p) for p in leaf_paths(tree)]


def _maxdiff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)))


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(arch):
    cfg = jget(arch).reduced()
    jmodel = jbuild(cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    like, axes = xw.lm_model(arch).init(0, device="cpu")
    params = params_from_numpy(_np(jparams), like=like, device="cpu")
    bf = make_batch_fn(cfg, 8, 32)
    return {"params": params, "axes": axes,
            "batches": [to_device(bf(s), "cpu") for s in range(2)]}, \
        (jparams, [bf(s) for s in range(2)])


def _jax_steps(arch, jparams, jbatches, **cfg_kw):
    jmodel = jbuild(jget(arch).reduced().replace(**cfg_kw))
    eng = JPrivacyEngine(jmodel.apply, jparams, jbatches[0],
                         dp=JDPConfig(l2_clip=1.0, noise_multiplier=0.0),
                         optimizer="sgdm", lr=1e-2, calibration="analytic")
    p, o, losses = jparams, jsgdm_init(jparams), []
    for b in jbatches:
        p, o, loss, _ = eng.private_step(p, o, b)
        losses.append(float(loss))
    return _np(p), losses


def _stale_engine(d, model):
    return mw.engine(model.apply, d["params"], d["batches"][0],
                     strategy="auto", mode="stale", sigma=mw.NOISE,
                     accountant=True, optimizer="adamw")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("moe_model_axis")
    data, jin = {}, {}
    for arch in ARCHS:
        data[arch], jin[arch] = _inputs(arch)
    w4, w2 = base / "w4", base / "w2"
    # Both worlds at once; the 2-rank one computes the single-device
    # references too, the parent the JAX package's meanwhile.
    ctx4 = xw.start(4, str(w4), data)
    ctx2 = xw.start(2, str(w2), data)
    ref = {"jax": {}, "capacity": {}}
    for arch in ARCHS:
        for impl in ("einsum", "gather"):
            ref["jax"][(arch, impl)] = _jax_steps(arch, *jin[arch],
                                                  moe_impl=impl)
    for cf in xw.CAPACITY_FACTORS:
        ref["capacity"][cf] = (
            ref["jax"][(ARCHS[0], "gather")]
            if cf == jget(ARCHS[0]).capacity_factor else
            _jax_steps(ARCHS[0], *jin[ARCHS[0]], moe_impl="gather",
                       capacity_factor=cf))
    out = {4: xw.join(ctx4, 4, str(w4))}
    # One device resumes the 2D run's checkpoint of step 1.
    d, model = data[ARCHS[0]], xw.lm_model(ARCHS[0])
    full = d["params"]
    from repro_torch.optim import adamw_init
    st, at = Checkpointer(str(w4 / "ck_2d")).restore_state(
        full, adamw_init(full), step=1)
    eng = _stale_engine(d, model)
    eng.load_clip_state(st.clip_state)
    eng.accountant.load_state_dict(st.ledger)
    p, o = st.params, st.opt
    for step in range(at + 1, mw.STEPS):
        p, o, _, _ = eng.private_step(p, o, mw.batch_at(d["batches"], step),
                                      step=step)
    ref["resumed"] = (st, at, p, eng.accountant.steps)
    out[2] = xw.join(ctx2, 2, str(w2))
    ref["steps"] = {**out[2][0]["single"], **out[2][1]["single"]}
    ref["mutants"] = ref["steps"].pop("mutants")
    out.update(ref=ref, data=data)
    return out


# ---------------------------------------------------------------------------
# The 2D step against one device, the JAX package


def _lane_id(lane):
    return "-".join(str(x) for x in lane)


@pytest.mark.parametrize("lane", [(a,) + l for a in ARCHS
                                  for l in xw.lanes(a)], ids=_lane_id)
def test_2d_step_matches_single_device(runs, lane):
    """data:2,model:2, σ = 0.8, 2 steps: the gathered params within 1e-6
    of the single-device step's, the losses equal, the ranks of one model
    slot bitwise equal across the data ranks."""
    want_p, want_l = runs["ref"]["steps"][lane]
    r4 = runs[4]
    _, got_p, got_l = r4[0]["steps"][lane]
    assert _maxdiff(got_p, want_p) < 1e-6
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for j in range(2):
        assert _bitwise(r4[j]["steps"][lane][0], r4[2 + j]["steps"][lane][0])
    assert not _bitwise(r4[0]["steps"][lane][0], r4[1]["steps"][lane][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_leaves_are_slices(runs, arch):
    """Each rank holds E/M experts, the router's matching columns, its
    heads of the sliced projections and the whole latent path."""
    d = runs["data"][arch]
    local, gathered, _ = runs[4][1]["steps"][(arch, "gather", "auto",
                                              "flat")]
    specs = sh.param_sharding(d["axes"], "data:2,model:2",
                              shapes_tree=d["params"])
    for p in leaf_paths(specs):
        full = tuple(get_subtree(d["params"], p).shape)
        assert tuple(get_subtree(local, p).shape) == sh.local_shape(
            full, get_subtree(specs, p), 2)
    moe = local["blocks"]["moe"]
    assert moe["w_gate"]["w"].shape[1] == 2          # (L, E/M, D, F)
    assert moe["router"]["w"].shape[-1] == 2
    whole = gathered["blocks"]["moe"]["w_gate"]["w"]
    assert torch.equal(moe["w_gate"]["w"], whole[:, 2:])
    if arch == "deepseek-v3-671b":
        a = local["blocks"]["attn"]
        full_a = d["params"]["blocks"]["attn"]
        assert a["wq_a"]["w"].shape == full_a["wq_a"]["w"].shape
        assert a["wkv_b"]["w"].shape[-1] * 2 == full_a["wkv_b"]["w"].shape[-1]
        assert moe["shared"]["w_up"]["w"].shape[-1] * 2 == \
            d["params"]["blocks"]["moe"]["shared"]["w_up"]["w"].shape[-1]


@pytest.mark.parametrize("impl", xw.IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sigma0_matches_jax_package(runs, arch, impl):
    """σ = 0 on model:2: the gathered params equal the JAX package's
    single-device step from the same params and batches (sort: the JAX
    package's gather, whose slots it reproduces)."""
    want_p, want_l = runs["ref"]["jax"][(arch, "gather" if impl == "sort"
                                         else impl)]
    got_p, got_l = runs[2][0]["jax"][(arch, impl)]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for p in leaf_paths(want_p):
        np.testing.assert_allclose(get_subtree(got_p, p).numpy(),
                                   get_subtree(want_p, p), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))
    assert _bitwise(got_p, runs[2][1]["jax"][(arch, impl)][0])


@pytest.mark.parametrize("impl", ("gather", "sort"))
@pytest.mark.parametrize("cf", xw.CAPACITY_FACTORS)
def test_global_capacity_on_a_data_axis(runs, cf, impl):
    """Fault F6: on data:2 a rank holds half the batch, and the dispatch
    derived its capacity and positions from its own tokens.  At factor
    0.5 the slots hold half the entries, so entries drop, and only the
    global capacity and positions offset by the earlier rank's counts
    give the JAX package's single-device step; at 2.0 nothing drops."""
    want_p, want_l = runs["ref"]["capacity"][cf]
    got_p, got_l = runs[2][0]["capacity"][(impl, cf)]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for p in leaf_paths(want_p):
        np.testing.assert_allclose(get_subtree(got_p, p).numpy(),
                                   get_subtree(want_p, p), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))
    assert _bitwise(got_p, runs[2][1]["capacity"][(impl, cf)][0])


def _rel(got, want):
    """The largest entry of |got - want| over the largest of |want|, leaf
    by leaf."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for g, w in zip(_leaves(got), _leaves(want)))


@pytest.mark.parametrize("name", xw.MUTANTS)
def test_mutant_misses_one_device(runs, name):
    """Each mutant's per-example norms and released gradient (σ = 0,
    every example clipped) miss one device's by more than 1e-4 relative
    (the largest entry of a leaf), where the clean lane's are within
    1e-5.  The unsummed expert norm² moves the least (4e-4 on reduced
    DeepSeek-V3, whose expert groups hold a small share of the norm);
    the missing copies move the gradient by 40-80 %."""
    want, want_n = runs["ref"]["mutants"]
    got, got_n = runs[2][0]["mutants"]["none"]
    assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(got_n.numpy(), want_n.numpy(), rtol=1e-5)
    bad, bad_n = runs[2][0]["mutants"][name]
    assert float(((bad_n - want_n).abs() / want_n).max()) > 1e-4
    assert _rel(bad, want) > 1e-4


# ---------------------------------------------------------------------------
# Plans, resume, the verifier


def _specs(arch, B=8, T=32):
    jm, tm = jbuild(jget(arch).reduced()), xw.lm_model(arch)
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), jp)
    jb = {k: jax.ShapeDtypeStruct((B, T), jnp.int32)
          for k in ("tokens", "labels")}
    tb = {k: torch.empty((B, T), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    return (jm.apply, jp, jb), (tm.apply, tp, tb)


@pytest.mark.parametrize("mode", ("flat", "stale"))
@pytest.mark.parametrize("arch", ARCHS)
def test_2d_plan_matches_reference(arch, mode):
    """The port's plan on data:2,model:2 equals the JAX package's: each
    layer's method, ``model_shards`` and collective bytes by axis."""
    (ja, jp, jb), (ta, tp, tb) = _specs(arch)
    j = jcm.get_plan(ja, jp, jb, mesh="data:2,model:2", clip_mode=mode,
                     calibration=None)
    t = tcm.get_plan(ta, tp, tb, mesh="data:2,model:2", clip_mode=mode,
                     calibration="analytic")
    assert set(j.layers) == set(t.layers)
    for n, a in j.layers.items():
        b = t.layers[n]
        assert (a.kind, a.norm_method, a.stash, a.fused, a.model_shards) \
            == (b.kind, b.norm_method, b.stash, b.fused, b.model_shards), n
        np.testing.assert_allclose(b.coll_bytes, a.coll_bytes, rtol=1e-9,
                                   err_msg=n)
        assert [x for x, _ in a.coll_bytes_by_axis] \
            == [x for x, _ in b.coll_bytes_by_axis], n
        np.testing.assert_allclose([v for _, v in b.coll_bytes_by_axis],
                                   [v for _, v in a.coll_bytes_by_axis],
                                   rtol=1e-9, err_msg=n)
    assert t.layers["blocks/moe/w_gate"].model_shards == 2
    np.testing.assert_allclose(t.total_coll_bytes, j.total_coll_bytes,
                               rtol=1e-9)


def test_checkpoint_whole_and_resumed_on_one_device(runs):
    """The data:2,model:2 run's checkpoint holds whole arrays; one device
    resumes it from step 1 to within 1e-6 of the 2D run, with no ledger
    gap."""
    st, at, p, steps = runs["ref"]["resumed"]
    full = runs["data"][ARCHS[0]]["params"]
    assert at == 1 and st.mesh_axes == (("data", 2), ("model", 2))
    for q in leaf_paths(full):
        assert get_subtree(st.params, q).shape == get_subtree(full, q).shape
    assert steps == mw.STEPS
    assert _maxdiff(p, runs[4][0]["resume"]) < 1e-6


@pytest.mark.parametrize("lane", range(len(xw.VERIFY_LANES)),
                         ids=[_lane_id(v) for v in xw.VERIFY_LANES])
def test_verify_2d_model_half_clean(runs, lane):
    """The live data:2,model:2 trace of each rank (one lane a rank)
    reports no model-half finding; its one finding is the one-device
    run's, the gather dispatch's slot competition
    (``unclipped_batch_reduction``, as ``tests/test_torch_dpcheck.py``
    pins on one device); the data pair reads no integer count as a
    gradient sync."""
    codes, sharding = runs[4][lane]["verify"]
    assert codes == ["unclipped_batch_reduction"], codes
    assert "partitioned over model" in sharding


@pytest.mark.parametrize("rank", (0, 1), ids=ARCHS)
def test_verify_2d_expert_norm_mutant_is_flagged(runs, rank):
    codes, _ = runs[2][rank]["verify_mutant"]
    assert "model_norm_sum_missing" in codes
