"""The recurrent families on a model axis in the port (ROADMAP item 14
part 3).

``PrivacyEngine(mesh=<live data:D,model:M>, param_axes=axes)`` runs
reduced xLSTM-125M (mLSTM and sLSTM blocks, 4 heads each) and reduced
Zamba2-2.7B (at d_model 128: 4 SSD heads, 4 attention heads over 2 KV
heads, its shared block applied twice) with each recurrence on the
rank's heads.  The column-sharded input projections are gathered, the
row-sharded ``wq`` / ``wk`` / ``wv`` / ``wif`` partial products are
reduce-scattered to the rank's heads (``wif``'s replicated bias added
once, after the sum), the RMSNorms over a sliced width sum their sums
of squares over ``model``, and the replicated params a scan reads for
the rank's heads only (Mamba2's ``ssd``, sLSTM's gate bias) have their
per-example gradient summed over ``model`` by the ``local_vjp`` kind.

Execution on gloo over the CPU: one world of 4 ranks (``data:2,model:2``
and ``model:4``) and one of 2 (``model:2``), started together
(``tests/torch_recurrent_model_axis_worker.py``); the 2-rank world
computes the single-device references too, the parent the JAX
package's.  Checked:

* 2 steps at σ = 0.8 on data:2,model:2 equal the port's single-device
  step within 1e-6 under every strategy but ``multi`` and every clipping
  mode; the ranks of one model slot are bitwise equal; both on model:4
  (one head a rank: ``up``'s and ``wx``'s column slices inside one piece
  each) too; Zamba2 with remat on bitwise remat off;
* the model group's calls a step do not depend on T (no collective in
  a time loop);
* at σ = 0 on model:2 the gathered params equal the JAX package's
  single-device step (rtol 1e-5, floor 2e-5 of each leaf's largest
  entry: ``tests/torch_recurrent_parity.py``'s);
* three mutants each fail their way: the ``ssd`` sum dropped is flagged
  ``model_partial_unsummed``; ``wif``'s bias added on every rank before
  the sum, and the reduce-scatter with an identity backward, miss one
  device (the latter in ``wq``'s gradient);
* the verifier's model half is clean on the live lanes;
* the plans on data:2,model:2 and the param specs equal the JAX
  package's; a degree that does not divide the heads, and serving on a
  model axis, raise naming item 14 part 3.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_attn_model_axis_worker as aw  # noqa: E402
import torch_moe_model_axis_worker as xw  # noqa: E402
import torch_recurrent_model_axis_worker as rw  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import DPConfig as JDPConfig  # noqa: E402
from repro.core import PrivacyEngine as JPrivacyEngine  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import sgdm_init as jsgdm_init  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core.tapper import Tapper  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.train import make_batch_fn, to_device  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths, tree_map  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = rw.ARCHS
B, T = 4, 8
# tests/torch_recurrent_parity.py's: rtol 1e-5, an absolute floor of
# COT_ATOL of the largest entry.
RTOL, COT_ATOL = 1e-5, 2e-5


def _leaves(tree):
    return [get_subtree(tree, p) for p in leaf_paths(tree)]


def _maxdiff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)))


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(arch):
    return jget(arch).reduced().replace(**rw.CFG_KW[arch])


def _jparams(arch):
    """The JAX package's init as numpy; xLSTM's ``wif`` bias (zeros at
    init) drawn from a seed, so that a bias added twice shows."""
    p = _np(jbuild(_jcfg(arch)).init(jax.random.PRNGKey(0))[0])
    if arch == ARCHS[0]:
        b = p["blocks"]["m"]["blk"]["wif"]["b"]
        p["blocks"]["m"]["blk"]["wif"]["b"] = np.random.RandomState(3) \
            .normal(0.0, 0.5, b.shape).astype(b.dtype)
    return p


def _inputs(arch):
    """{arch: params, axes, 2 batches of (B, T)} with ``("census", arch,
    t)`` and ``("verify", arch)`` the same params beside batches of
    (B, t) and (B, VERIFY_T); and the JAX package's params and
    batches."""
    cfg = _jcfg(arch)
    jparams = _jparams(arch)
    like, axes = rw.lm_model(arch).init(0, device="cpu")
    params = params_from_numpy(jparams, like=like, device="cpu")

    def at(seq):
        bf = make_batch_fn(cfg, B, seq)
        return {"params": params, "axes": axes,
                "batches": [to_device(bf(s), "cpu") for s in range(2)]}
    out = {arch: at(T), ("verify", arch): at(rw.VERIFY_T)}
    out.update({("census", arch, t): at(t) for t in rw.CENSUS_T})
    bf = make_batch_fn(cfg, B, T)
    return out, (jparams, [bf(s) for s in range(2)])


def _jax_steps(arch, jparams, jbatches):
    jmodel = jbuild(_jcfg(arch))
    p = jax.tree.map(jnp.asarray, jparams)
    eng = JPrivacyEngine(jmodel.apply, p, jbatches[0],
                         dp=JDPConfig(l2_clip=1.0, noise_multiplier=0.0),
                         optimizer="sgdm", lr=1e-2, calibration="analytic")
    o, losses = jsgdm_init(p), []
    for b in jbatches:
        p, o, loss, _ = eng.private_step(p, o, b)
        losses.append(float(loss))
    return _np(p), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("recurrent_model_axis")
    data, jin = {}, {}
    for arch in ARCHS:
        d, jin[arch] = _inputs(arch)
        data.update(d)
    w4, w2 = base / "w4", base / "w2"
    ctx4 = rw.start(4, str(w4), data)
    ctx2 = rw.start(2, str(w2), data)
    ref = {"jax": {a: _jax_steps(a, *jin[a]) for a in ARCHS}}
    out = {4: xw.join(ctx4, 4, str(w4)), 2: xw.join(ctx2, 2, str(w2))}
    ref["steps"] = {**out[2][0]["single"], **out[2][1]["single"]}
    ref["mutants"] = ref["steps"].pop("mutants")
    out.update(ref=ref, data=data)
    return out


def _lane_id(lane):
    return "-".join(str(x) for x in lane)


# ---------------------------------------------------------------------------
# The sharded step against one device, remat, the census, the JAX package


@pytest.mark.parametrize(
    "lane", [(a, s, m, False) for a in ARCHS for s, m in rw.STEP_LANES]
    + [(ARCHS[1], s, m, True) for s, m in rw.REMAT_LANES], ids=_lane_id)
def test_2d_step_matches_single_device(runs, lane):
    """data:2,model:2, σ = 0.8, 2 steps: the gathered params within 1e-6
    of the single-device step's (remat off there), the losses equal, the
    ranks of one model slot bitwise equal across the data ranks."""
    want_p, want_l = runs["ref"]["steps"][lane[:3]]
    r4 = runs[4]
    _, got_p, got_l = r4[0]["steps"][lane]
    assert _maxdiff(got_p, want_p) < 1e-6
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for j in range(2):
        assert _bitwise(r4[j]["steps"][lane][0], r4[2 + j]["steps"][lane][0])
    assert not _bitwise(r4[0]["steps"][lane][0], r4[1]["steps"][lane][0])


@pytest.mark.parametrize("lane", rw.M4_LANES, ids=_lane_id)
def test_model4_one_head_a_rank(runs, lane):
    """model:4, one head a rank: xLSTM (``up``'s 2·d_inner columns split
    inside ``xin`` and ``z``, ``wx``'s one gate a rank) and Zamba2 (one SSD
    head, its conv's 72 channels beside the head's 64, one query head
    beside its KV head): 2 steps within 1e-6 of one device's; the leaves
    are quarter slices."""
    want_p, want_l = runs["ref"]["steps"][lane]
    local, got_p, got_l = runs[4][3]["m4"][lane + (False,)]
    assert _maxdiff(got_p, want_p) < 1e-6
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    full = runs["data"][lane[0]]["params"]["blocks"]
    if lane[0] == ARCHS[0]:
        blk, fblk = local["blocks"]["m"]["blk"], full["m"]["blk"]
        assert blk["up"]["w"].shape[-1] * 4 == fblk["up"]["w"].shape[-1]
        assert blk["wq"]["w"].shape[-2] * 4 == fblk["wq"]["w"].shape[-2]
        s, fs = local["blocks"]["s"]["blk"], full["s"]["blk"]
        assert s["rec"]["R"].shape[2] == 1 and fs["rec"]["R"].shape[2] == 4
    else:
        blk, fblk = local["blocks"]["mamba"]["blk"], full["mamba"]["blk"]
        assert blk["conv"]["b"].shape[-1] * 4 == fblk["conv"]["b"].shape[-1]
        assert blk["out_proj"]["w"].shape[-2] == 64


@pytest.mark.parametrize("lane", rw.REMAT_LANES, ids=_lane_id)
def test_remat_bitwise_on_the_mesh(runs, lane):
    """Zamba2 with remat=True on data:2,model:2: every rank's slices
    bitwise those of remat=False (the recompute re-issues the forward's
    collectives in the same order on every rank)."""
    for r in runs[4]:
        assert _bitwise(r["steps"][(ARCHS[1],) + lane + (True,)][0],
                        r["steps"][(ARCHS[1],) + lane + (False,)][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_calls_do_not_depend_on_T(runs, arch):
    """A bk step's model-group calls on model:2 (``COLL_STATS``) are the
    count ``chip_smoke.rx_bk_calls`` reckons from the layers (the card's
    check), at T = 8 and at T = 16: every collective sits outside the
    scans' time loops; the bytes grow with T."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke.rx_bk_calls(rw.lm_model(arch).cfg)
    for r in runs[2]:
        (c8, b8), (c16, b16) = (r["calls"][(arch, t)] for t in rw.CENSUS_T)
        assert c8 == c16 == want
        assert b16 > b8


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_are_slices(runs, arch):
    """Each rank holds the slices its spec names: the sliced heads'
    projections, ``R`` on heads; ``wif``'s bias, sLSTM's gate bias and
    the ``ssd`` params whole."""
    d = runs["data"][arch]
    local, _, _ = runs[4][1]["steps"][(arch, "auto", "flat", False)]
    specs = sh.param_sharding(d["axes"], "data:2,model:2",
                              shapes_tree=d["params"])
    for p in leaf_paths(specs):
        full = tuple(get_subtree(d["params"], p).shape)
        assert tuple(get_subtree(local, p).shape) == sh.local_shape(
            full, get_subtree(specs, p), 2), p
    if arch == ARCHS[0]:
        m, s = local["blocks"]["m"]["blk"], local["blocks"]["s"]["blk"]
        assert not sh.is_sharded(specs["blocks"]["m"]["blk"]["wif"]["b"])
        assert sh.is_sharded(specs["blocks"]["m"]["blk"]["wif"]["w"])
        assert m["wif"]["b"].shape[-1] == 8
        assert not sh.is_sharded(specs["blocks"]["s"]["blk"]["rec"]["b"])
        assert s["rec"]["R"].shape[2] == 2
    else:
        ssd = specs["blocks"]["mamba"]["blk"]["ssd"]
        assert not any(sh.is_sharded(v) for v in ssd.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_sigma0_matches_jax_package(runs, arch):
    """σ = 0 on model:2: two steps' gathered params equal the JAX
    package's single-device steps from the same params and batches."""
    want_p, want_l = runs["ref"]["jax"][arch]
    got_p, got_l = runs[2][0]["jax"][arch]
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL)
    for p in leaf_paths(want_p):
        want = np.asarray(get_subtree(want_p, p))
        np.testing.assert_allclose(
            get_subtree(got_p, p).numpy(), want, rtol=RTOL,
            atol=COT_ATOL * max(np.abs(want).max(), 1e-30), err_msg=str(p))
    assert _bitwise(got_p, runs[2][1]["jax"][arch][0])


# ---------------------------------------------------------------------------
# The mutants, the verifier, the plans


def _rel(got, want):
    """The largest entry of |got - want| over the largest of |want|, leaf
    by leaf."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for g, w in zip(_leaves(got), _leaves(want)))


def _wq(tree):
    return tree["blocks"]["m"]["blk"]["wq"]


@pytest.mark.parametrize("name", rw.MUTANTS)
def test_mutant_misses_one_device(runs, name):
    """σ = 0, bk under per_layer clipping, every group clipped: the clean
    lane's per-layer norms (rtol) and released gradient (of each leaf's
    largest entry) are within ``COT_ATOL`` of one device's, the
    recurrences' f32 spread (``tests/torch_recurrent_parity.py``);
    each mutant's miss by more than 1e-4 relative (the reduce-scatter
    with an identity backward in ``wq``'s gradient)."""
    arch = rw.mutant(name)[3]
    want, want_n = runs["ref"]["mutants"][arch]
    got, got_n = runs[2][0]["mutants"][("none", arch)]
    assert _rel(got, want) < COT_ATOL
    np.testing.assert_allclose(got_n.numpy(), want_n.numpy(),
                               rtol=COT_ATOL)
    bad, bad_n = runs[2][0]["mutants"][name]
    assert float(((bad_n - want_n).abs() / want_n).max()) > 1e-4
    assert _rel(bad, want) > 1e-4
    if name == "scatter_identity_backward":
        assert _rel(_wq(bad), _wq(want)) > 1e-4


@pytest.mark.parametrize("rank", range(len(rw.VERIFY_LANES)),
                         ids=[_lane_id(v) for v in rw.VERIFY_LANES])
def test_verify_2d_model_half_clean(runs, rank):
    """The live data:2,model:2 trace of each rank (one lane a rank: bk,
    auto flat with remat, auto stale, bk per_layer) reports no finding:
    the one-device verdict."""
    codes, sharding = runs[4][rank]["verify"]
    assert codes == [], codes
    assert "partitioned over model" in sharding


@pytest.mark.parametrize("rank", (0, 1), ids=("bk", "auto"))
def test_verify_flags_unsummed_ssd(runs, rank):
    """Zamba2's ``ssd`` per-example gradient left unsummed over model
    reaches its norm partial: ``model_partial_unsummed``, and nothing
    else of the model half."""
    codes, _ = runs[2][rank]["verify_mutant"]
    assert codes == ["model_partial_unsummed"], codes


def _specs(arch):
    jm, tm = jbuild(_jcfg(arch)), rw.lm_model(arch)
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
    layer's method, ``model_shards`` and collective bytes by axis (the
    ``local_vjp`` layers' sums of their partial per-example gradients
    are left unpriced in both)."""
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
    np.testing.assert_allclose(t.total_coll_bytes, j.total_coll_bytes,
                               rtol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """``param_sharding`` on data:2,model:2 names, leaf by leaf, the JAX
    package's spec."""
    import types
    box = {}

    def init(k):
        p, box["axes"] = jbuild(_jcfg(arch)).init(k)
        return p
    jp = jax.eval_shape(init, jax.random.PRNGKey(0))
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 2})
    want = jax.tree.map(
        lambda a, leaf: tuple(jsh._axes_to_spec(a, jsh.PARAM_RULES, mesh,
                                                tuple(leaf.shape))),
        box["axes"], jp, is_leaf=lambda x: isinstance(x, tuple))
    tp, taxes = rw.lm_model(arch).init(0, device="cpu")
    got = sh.param_sharding(taxes, "data:2,model:2", shapes_tree=tp)
    assert leaf_paths(got) == leaf_paths(want)
    for p in leaf_paths(want):
        assert get_subtree(got, p) == get_subtree(want, p), p


def test_indivisible_heads_and_serving_raise():
    """A model degree that does not divide the heads (4 mLSTM, sLSTM or
    SSD heads on 8 ranks) raises before any collective, and so does
    serving either family on a model axis: both name item 14 part 3."""
    fake8 = sh.ModelShard(None, 0, 8)
    x = torch.zeros((1, 2, 64))
    xl, zm = rw.lm_model(ARCHS[0]), rw.lm_model(ARCHS[1])
    p, _ = xl.init(0, device="cpu")
    zp, _ = zm.init(0, device="cpu")
    m_blk = tree_map(lambda a: a[0, 0], p["blocks"]["m"]["blk"])
    s_blk = tree_map(lambda a: a[0], p["blocks"]["s"]["blk"])
    z_blk = tree_map(lambda a: a[0, 0], zp["blocks"]["mamba"]["blk"])
    calls = (
        lambda: ssm.mlstm_apply(Tapper(), "blk", m_blk, x, n_heads=4),
        lambda: ssm.slstm_apply(Tapper(), "blk", s_blk, x, n_heads=4),
        lambda: ssm.mamba2_apply(Tapper(), "blk", z_blk,
                                 torch.zeros((1, 2, 128)), d_state=16))
    for call in calls:
        with sh.model_parallel(fake8), pytest.raises(
                NotImplementedError, match="heads.*item 14 part 3"):
            call()
    fake2 = sh.ModelShard(None, 0, 2)
    for model, params in ((xl, p), (zm, zp)):
        with sh.model_parallel(fake2), pytest.raises(
                NotImplementedError,
                match="serving the .* family on a model axis.*item 14 "
                      "part 3"):
            model.prefill(params, torch.zeros((1, 2), dtype=torch.int32), 4)

