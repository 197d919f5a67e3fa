"""qk-norm and the enc-dec family on a model axis in the port (ROADMAP
item 14 part 3).

``PrivacyEngine(mesh=<live data:D,model:M>, param_axes=axes)`` runs
reduced Chameleon-34B (GQA with qk-norm, 4 query heads, 2 KV heads,
LayerNorm with a bias) and reduced SeamlessM4T-large-v2 (a 2-layer
encoder, a 2-layer decoder with cross attention, a GeLU MLP) with the
query heads, the MLPs' hidden width and the vocabulary sliced over
``model``.  ``kn`` normalizes the replicated keys before their copy to
``model``; ``qn`` normalizes the rank's query heads, and the ``scale``
kind sums its partial per-example gradient over ``model`` before any
norm reads it; cross attention takes its K and V from the replicated
``wk`` / ``wv`` on the encoder's output.

Execution on gloo over the CPU: one ``data:2,model:2`` world (4 ranks)
and one ``model:2`` world (2 ranks), started together (``tests/
torch_attn_model_axis_worker.py``); the 2-rank world computes the
single-device references too, the parent the JAX package's.  Checked:

* 2 steps at σ = 0.8 on data:2,model:2 equal the port's single-device
  step within 1e-6 under every strategy but ``multi`` and every clipping
  mode; three lanes of each arch again with ``remat=True``, bitwise
  equal to ``remat=False`` on the mesh; the ranks of one model slot are
  bitwise equal; the leaves are slices, qk-norm's scales whole;
* with remat on, the model group's extra calls are exactly the
  recomputed forward's layout moves (``COLL_STATS``);
* at σ = 0 on model:2 the gathered params equal the JAX package's
  single-device step (rtol 1e-4, atol 1e-6), Seamless also with 500 of
  its 512 vocabulary rows valid (the padded rows on the last rank);
* the encoder output's cotangent is whole on every model rank;
  ``src_frames`` is split over data with the tokens;
* three mutants miss one device: ``qn``'s per-example gradient left
  unsummed, ``kn`` normed after the copy, cross attention's ``wk`` /
  ``wv`` without their copy;
* the verifier's model half: clean on the live data:2,model:2 lanes
  (ghost's weighted backward and remat among them), and it flags ``qn``
  unsummed (``model_partial_unsummed``);
* the plans on data:2,model:2 equal the JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_attn_model_axis_worker as aw  # noqa: E402
import torch_moe_model_axis_worker as xw  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import DPConfig as JDPConfig  # noqa: E402
from repro.core import PrivacyEngine as JPrivacyEngine  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import sgdm_init as jsgdm_init  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.train import make_batch_fn, to_device  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = aw.ARCHS
B, T = 8, 32


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
    return (jget(ARCHS[1]).reduced().replace(vocab=aw.PADDED_VOCAB)
            if arch == "padded" else jget(arch).reduced())


def _inputs(arch):
    cfg = _jcfg(arch)
    jparams, _ = jbuild(cfg).init(jax.random.PRNGKey(0))
    model = (aw.lm_model(ARCHS[1], vocab=aw.PADDED_VOCAB)
             if arch == "padded" else aw.lm_model(arch))
    like, axes = model.init(0, device="cpu")
    params = params_from_numpy(_np(jparams), like=like, device="cpu")
    bf = make_batch_fn(cfg, B, T)
    return {"params": params, "axes": axes,
            "batches": [to_device(bf(s), "cpu") for s in range(2)]}, \
        (jparams, [bf(s) for s in range(2)])


def _jax_steps(arch, jparams, jbatches):
    jmodel = jbuild(_jcfg(arch))
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
    base = tmp_path_factory.mktemp("attn_model_axis")
    data, jin = {}, {}
    for arch in ARCHS + ("padded",):
        data[arch], jin[arch] = _inputs(arch)
    w4, w2 = base / "w4", base / "w2"
    ctx4 = aw.start(4, str(w4), data)
    ctx2 = aw.start(2, str(w2), data)
    ref = {"jax": {a: _jax_steps(a, *jin[a]) for a in ARCHS + ("padded",)},
           "enc_out_cotangent": aw.enc_out_cotangent(data[ARCHS[1]])}
    out = {4: xw.join(ctx4, 4, str(w4)), 2: xw.join(ctx2, 2, str(w2))}
    ref["steps"] = {**out[2][0]["single"], **out[2][1]["single"]}
    ref["mutants"] = ref["steps"].pop("mutants")
    ref["padded"] = ref["steps"].pop("padded")
    out.update(ref=ref, data=data)
    return out


def _lane_id(lane):
    return "-".join(str(x) for x in lane)


# ---------------------------------------------------------------------------
# The 2D step against one device, remat, the JAX package


@pytest.mark.parametrize(
    "lane", [(a, s, m, False) for a in ARCHS for s, m in aw.STEP_LANES]
    + [(a, s, m, True) for a in ARCHS for s, m in aw.REMAT_LANES],
    ids=_lane_id)
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


@pytest.mark.parametrize("lane", [(a, s, m) for a in ARCHS
                                  for s, m in aw.REMAT_LANES], ids=_lane_id)
def test_remat_bitwise_on_the_mesh(runs, lane):
    """remat=True on data:2,model:2: every rank's slices bitwise those of
    remat=False (the recompute re-issues the forward's collectives in
    the same order on every rank)."""
    for r in runs[4]:
        assert _bitwise(r["steps"][lane + (True,)][0],
                        r["steps"][lane + (False,)][0])


# The forward layout moves a recomputed layer re-issues (sums over
# model), each of a (B/d, T, D) f32 tensor: the recompute stops at the
# last tensor the layer's backward saved (the non-reentrant checkpoint's
# early stop), so w_down's sum, which feeds the residual add alone, is
# not made again.  Chameleon: wo's; Seamless's decoder (the scan under
# remat): self and cross wo's.
RECOMPUTED = {"chameleon-34b": (1, T), "seamless-m4t-large-v2": (2, T // 2)}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_adds_only_layout_moves(runs, arch):
    """A bk step with remat on makes, over the model group, the calls of
    remat off plus one sum of the recomputed forward's moves a layer
    (``COLL_STATS``), each of a (B/d, T, D) f32 activation: the norm sums
    stay as they were."""
    per_layer, t = RECOMPUTED[arch]
    L = 2
    for r in runs[4]:
        c0, b0 = r["calls"][(arch, False)]
        c1, b1 = r["calls"][(arch, True)]
        assert c1 - c0 == per_layer * L
        assert b1 - b0 == per_layer * L * (B // 2) * t * 64 * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_are_slices(runs, arch):
    """Each rank holds its query heads, its slice of the MLPs' hidden
    width and of the vocabulary; wk / wv, the norms and qk-norm's
    scales whole."""
    d = runs["data"][arch]
    local, _, _ = runs[4][1]["steps"][(arch, "auto", "flat", False)]
    specs = sh.param_sharding(d["axes"], "data:2,model:2",
                              shapes_tree=d["params"])
    for p in leaf_paths(specs):
        full = tuple(get_subtree(d["params"], p).shape)
        assert tuple(get_subtree(local, p).shape) == sh.local_shape(
            full, get_subtree(specs, p), 2)
    full, attn = d["params"], ("blocks", "attn") if arch == ARCHS[0] \
        else ("dec", "cross")
    a, fa = get_subtree(local, attn), get_subtree(full, attn)
    assert a["wq"]["w"].shape[-1] * 2 == fa["wq"]["w"].shape[-1]
    assert a["wk"]["w"].shape == fa["wk"]["w"].shape
    assert local["tok_emb"]["emb"].shape[0] * 2 == \
        full["tok_emb"]["emb"].shape[0]
    if arch == ARCHS[0]:
        assert a["qn"]["g"].shape == fa["qn"]["g"].shape
        assert a["kn"]["g"].shape == fa["kn"]["g"].shape


@pytest.mark.parametrize("arch", ARCHS + ("padded",))
def test_sigma0_matches_jax_package(runs, arch):
    """σ = 0 on model:2: the gathered params equal the JAX package's
    single-device step from the same params and batches."""
    want_p, want_l = runs["ref"]["jax"][arch]
    got_p, got_l = runs[2][0]["jax"][arch]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for p in leaf_paths(want_p):
        np.testing.assert_allclose(get_subtree(got_p, p).numpy(),
                                   get_subtree(want_p, p), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))
    assert _bitwise(got_p, runs[2][1]["jax"][arch][0])


def test_padded_vocab_rows_on_the_last_rank(runs):
    """Reduced Seamless with 500 valid rows of 512: on model:2 the 12
    padded rows lie in the last rank's slice, which the sliced cross
    entropy masks by global index; 2 steps at σ = 0.8 equal one
    device's within 1e-6 (their padded rows move by the noise only)."""
    cfg = aw.lm_model(ARCHS[1], vocab=aw.PADDED_VOCAB).cfg
    assert cfg.padded_vocab == 512 > cfg.vocab
    local, got_p, got_l = runs[2][1]["padded"]
    assert local["tok_emb"]["emb"].shape[0] == cfg.padded_vocab // 2
    assert cfg.vocab > cfg.padded_vocab // 2
    want_p, want_l = runs["ref"]["padded"]
    assert _maxdiff(got_p, want_p) < 1e-6
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)


def test_enc_out_cotangent_whole_on_every_rank(runs):
    """The encoder output's cotangent under Σ_b L_b is whole on each
    model:2 rank: bitwise equal across the ranks and within 1e-6 of one
    device's (the copies after the replicated cross ``wk`` / ``wv``)."""
    want = runs["ref"]["enc_out_cotangent"]
    got = [r["enc_out_cotangent"] for r in runs[2]]
    assert torch.equal(got[0], got[1])
    assert float((got[0] - want).abs().max()) < 1e-6 * max(
        1.0, float(want.abs().max()))


def test_src_frames_split_over_data_with_the_tokens(runs):
    """On data:2,model:2 a rank's model sees half the examples of every
    batch leaf, the source frames among them, as ``batch_sharding``
    says."""
    d = runs["data"][ARCHS[1]]
    specs = sh.batch_sharding(d["batches"][0], "data:2,model:2")
    assert specs == {k: ("data",) for k in d["batches"][0]}
    for r in runs[4]:
        seen = r["batch_seen"]
        assert seen == {k: (B // 2,) + tuple(v.shape[1:])
                        for k, v in d["batches"][0].items()}


def _rel(got, want):
    """The largest entry of |got - want| over the largest of |want|, leaf
    by leaf."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for g, w in zip(_leaves(got), _leaves(want)))


@pytest.mark.parametrize("name", aw.MUTANTS)
def test_mutant_misses_one_device(runs, name):
    """Each mutant's per-layer norms and released gradient (σ = 0, bk
    under per_layer clipping, every group clipped) miss one device's by
    more than 1e-4 relative, where the clean lane's are within 1e-5."""
    arch = aw.mutant(name)[3]
    want, want_n = runs["ref"]["mutants"][arch]
    got, got_n = runs[2][0]["mutants"][("none", arch)]
    assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(got_n.numpy(), want_n.numpy(), rtol=1e-5)
    bad, bad_n = runs[2][0]["mutants"][name]
    assert float(((bad_n - want_n).abs() / want_n).max()) > 1e-4
    assert _rel(bad, want) > 1e-4


# ---------------------------------------------------------------------------
# The verifier, the plans


@pytest.mark.parametrize("rank", range(len(aw.VERIFY_LANES)),
                         ids=[_lane_id(v) for v in aw.VERIFY_LANES])
def test_verify_2d_model_half_clean(runs, rank):
    """The live data:2,model:2 trace of each rank (one lane a rank:
    ghost's weighted backward, remat, per_layer, stale) reports no
    finding: the one-device verdict."""
    codes, sharding = runs[4][rank]["verify"]
    assert codes == [], codes
    assert "partitioned over model" in sharding


@pytest.mark.parametrize("rank", (0, 1), ids=("bk", "auto"))
def test_verify_flags_unsummed_partial_group(runs, rank):
    """qn's per-example gradient left unsummed over model reaches the
    norms partial: ``model_partial_unsummed``, and nothing else of the
    model half."""
    codes, _ = runs[2][rank]["verify_mutant"]
    assert codes == ["model_partial_unsummed"], codes


def _specs(arch):
    jm, tm = jbuild(jget(arch).reduced()), aw.lm_model(arch)
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), jp)
    jb = {k: jax.ShapeDtypeStruct((B, T), jnp.int32)
          for k in ("tokens", "labels")}
    tb = {k: torch.empty((B, T), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    if arch == ARCHS[1]:
        D = jget(arch).reduced().d_model
        jb["src_frames"] = jax.ShapeDtypeStruct((B, T, D), jnp.float32)
        tb["src_frames"] = torch.empty((B, T, D), device="meta")
    return (jm.apply, jp, jb), (tm.apply, tp, tb)


@pytest.mark.parametrize("mode", ("flat", "stale"))
@pytest.mark.parametrize("arch", ARCHS)
def test_2d_plan_matches_reference(arch, mode):
    """The port's plan on data:2,model:2 equals the JAX package's: each
    layer's method, ``model_shards`` and collective bytes by axis (qk-
    norm's scales a replicated group in both: the port's sum of ``qn``'s
    partial per-example gradient is left unpriced)."""
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
    if arch == ARCHS[0]:
        assert t.layers["blocks/attn/qn"].model_shards == 1
        assert t.layers["blocks/attn/wq"].model_shards == 2
