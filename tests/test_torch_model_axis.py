"""Model-axis sharding in the port (ROADMAP item 14, part 2).

``PrivacyEngine(mesh=<live data:D,model:M>, param_axes=axes)`` runs the
tensor-sharded private step: each rank holds its slices of the leaves
``launch.sharding.PARAM_RULES`` puts on ``model``, the models make their
layout moves explicitly, each sliced group's partial norm² is summed over
``model`` once, and every rank keeps its slice of the one full-shape
noise draw.  The reference's tests for this are
``tests/test_sharded_engine.py``'s 2D lanes and ``tests/test_exactness.
py``'s conv 2D oracle.

Execution on gloo over the CPU: one ``data:2,model:2`` world (4 ranks)
and one ``model:2`` world (2 ranks), each spawned once for the module
(``tests/torch_model_axis_worker.py``); the parent computes every
single-device and JAX reference while a world runs.  Checked:

* 2 steps at σ = 0.8 (the noise included) of reduced AlexNet and reduced
  Llama-3.2-1B (4 heads, 2 KV heads, vocab 512) under crb, ghost, bk and
  ``auto`` x flat / per_layer / stale equal the port's single-device step
  within 1e-6; the ranks of one model slot are bitwise equal across data
  ranks; the sliced leaves really are slices;
* at σ = 0 the gathered params equal the JAX package's single-device
  step on the same numpy inputs (the JAX package's params loaded through
  ``repro_torch.weights``; rtol 1e-4, atol 1e-6, the parity tests');
* the clipped mean gradient of ``tests/test_exactness.py``'s conv and
  conv + 3-wide head models (conv out-channels sliced, the head
  replicated) matches the naive Jacobian oracle, computed here in JAX,
  under that file's ``_sum_tol``, f32 and bf16, flat / per_layer / stale;
* a custom optimizer's moments equal the single-device ones and are the
  params' slices;
* the verifier's model half: clean lanes, four mutants, "partitioned
  over model"; ``dpcheck --mesh data:2,model:2``;
* kill-and-resume bitwise on data:2,model:2 (the engine and the CLI);
  a data:2,model:2 checkpoint resumed on one device and a one-device
  checkpoint on data:2,model:2, within 1e-6 of the straight runs; the
  CLI's 2D checkpoint resumed with no ``--mesh`` in one process;
* the collective calibration over each axis's own group.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_model_axis_worker as mw  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import DPConfig as JDPConfig  # noqa: E402
from repro.core import PrivacyEngine as JPrivacyEngine  # noqa: E402
from repro.core import Tapper as JTapper  # noqa: E402
from repro.core.strategies import clip_coefficients as jclip  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import sgdm_init as jsgdm_init  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import clipping, costmodel, strategies  # noqa: E402
from repro_torch.launch import dpcheck  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.train import make_batch_fn, to_device  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths, set_subtree  # noqa
from repro_torch.weights import params_from_numpy  # noqa: E402

ARCHS = ("alexnet", "llama3.2-1b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _leaves(tree):
    return [get_subtree(tree, p) for p in leaf_paths(tree)]


def _maxdiff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)))


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


# ---------------------------------------------------------------------------
# Inputs: the JAX package's params, the port's axes, numpy batches


def _lm_inputs(arch):
    cfg = jget(arch).reduced()
    jmodel = jbuild(cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tmodel = mw.lm_model(arch)
    like, axes = tmodel.init(0, device="cpu")
    params = params_from_numpy(_np(jparams), like=like, device="cpu")
    bf = make_batch_fn(cfg, 8, 32)
    return {"params": params, "axes": axes,
            "batches": [to_device(bf(s), "cpu") for s in range(2)]}, \
        (jmodel, jparams, [bf(s) for s in range(2)])


def _conv_inputs(jdt, head, seed=7, B=8):
    """``tests/test_exactness.py``'s ``conv_model`` / ``conv_plus_head_
    model`` at CONV_GEOMS[1] (their draws, in order): the JAX apply, the
    JAX params and batch, and the port's params and batch."""
    C, D, HW, K, s, p_, dil, g = mw.CONV_GEOM
    rng = np.random.RandomState(seed)
    jp = {"c": {"w": jnp.asarray(rng.randn(D, C // g, K, K), jdt) * 0.3,
                "b": jnp.asarray(rng.randn(D), jdt) * 0.1}}
    if head:
        jp["head"] = {"w": jnp.asarray(rng.randn(D, 3), jdt) * 0.4}
    jb = {"x": jnp.asarray(rng.randn(B, C, HW, HW), jdt)}

    def japply(p, batch, tp):
        y = tp.conv("c", batch["x"], p["c"]["w"], p["c"]["b"], stride=s,
                    padding=p_, dilation=dil, groups=g)
        t = jnp.tanh(y.astype(jnp.float32))
        if not head:
            return jnp.sum(t ** 2, axis=(1, 2, 3))
        o = tp.dense("head", t.mean(axis=(2, 3)), p["head"]["w"])
        return jnp.sum(jnp.tanh(o.astype(jnp.float32)) ** 2, axis=1)

    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[jdt]

    def to_t(tree):
        return {k: to_t(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32)).to(tdt)
                for k, v in tree.items()}
    return (japply, jp, jb), {"params": to_t(jp), "batch": to_t(jb)}


def _oracle(japply, jp, jb, C, per_layer):
    """Σ_b clip(g_b) / B from the rows of the Jacobian of the per-example
    losses (``tests/test_exactness.py``'s naive oracle); per_layer clips
    each top-level group at its uniform budget C/√G."""
    pe = jax.jacrev(lambda p: japply(p, jb, JTapper()))(jp)
    B = jb["x"].shape[0]

    def sq(tree):
        return sum(jnp.sum(jnp.square(leaf.astype(jnp.float32)).reshape(
            B, -1), axis=1) for leaf in jax.tree.leaves(tree))

    def clipped(tree, bound):
        coef = jclip(sq(tree), bound)
        return jax.tree.map(lambda g: jnp.einsum(
            "b...,b->...", g.astype(jnp.float32), coef) / B, tree)
    if per_layer:
        return {k: clipped(pe[k], C / np.sqrt(len(pe))) for k in sorted(pe)}
    return clipped(pe, C)


def _sum_tol(dt, scale):
    """``tests/test_exactness.py``'s clipped-sum tolerance."""
    if dt == "f32":
        return dict(rtol=3e-3, atol=3e-4 * scale)
    return dict(rtol=1.2e-1, atol=2e-2 * scale)


def _jax_steps(jmodel, jparams, jbatches):
    eng = JPrivacyEngine(jmodel.apply, jparams, jbatches[0],
                         dp=JDPConfig(l2_clip=1.0, noise_multiplier=0.0),
                         optimizer="sgdm", lr=1e-2, calibration="analytic")
    p, o, losses = jparams, jsgdm_init(jparams), []
    for s, b in enumerate(jbatches):
        p, o, loss, _ = eng.private_step(p, o, b)
        losses.append(float(loss))
    return _np(p), losses


def _single(data, arch, strategy, mode, **kw):
    d, model = data[arch], mw.lm_model(arch)
    costmodel.clear_plan_cache()
    eng = mw.engine(model.apply, d["params"], d["batches"][0],
                    strategy=strategy, mode=mode, **kw)
    return mw.run_steps(eng, d["params"], d["batches"],
                        optimizer=kw.get("optimizer", "sgdm"))


def _stale_engine(data, mesh=None):
    d, model = data["alexnet"], mw.lm_model("alexnet")
    return mw.engine(model.apply, d["params"], d["batches"][0],
                     strategy="auto", mode="stale", sigma=mw.NOISE,
                     mesh=mesh, axes=d["axes"] if mesh else None,
                     accountant=True, optimizer="adamw")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("model_axis")
    data, jax_in = {"conv": {}}, {}
    for arch in ARCHS:
        data[arch], jax_in[arch] = _lm_inputs(arch)
    conv_j = {}
    for dt, (jdt, _) in DTYPES.items():
        (ja, jp, jb), t = _conv_inputs(jdt, head=False)
        (jah, jph, jbh), th = _conv_inputs(jdt, head=True)
        data["conv"][dt] = {"conv": t, "head": th}
        conv_j[dt] = ((ja, jp, jb), (jah, jph, jbh))
    w4, w2 = base / "w4", base / "w2"
    # A one-device run's checkpoint (killed before step 2), which the
    # data:2,model:2 world resumes.
    w4.mkdir()
    mw.drive(_stale_engine(data), data["alexnet"]["params"],
             data["alexnet"]["batches"],
             ckpt=Checkpointer(str(w4 / "ck_single")), kill_at=mw.KILL_AT)
    ctx = mw.start(4, str(w4), data)
    # The references, while the ranks run.
    ref = {"steps": {}, "conv": {}}
    for arch in ARCHS:
        for strategy, mode in mw.STEP_LANES:
            p, _, losses = _single(data, arch, strategy, mode)
            ref["steps"][(arch, strategy, mode)] = (p, losses)
    d, model = data["llama3.2-1b"], mw.lm_model("llama3.2-1b")
    eng = mw.engine(model.apply, d["params"], d["batches"][0],
                    optimizer=mw.momentum)
    ref["custom"] = mw.run_steps(eng, d["params"], d["batches"],
                                 optimizer=mw.momentum)
    ref["stale_straight"] = mw.drive(_stale_engine(data),
                                     data["alexnet"]["params"],
                                     data["alexnet"]["batches"])[0]
    for dt, ((ja, jp, jb), (jah, jph, jbh)) in conv_j.items():
        ref["conv"][(dt, "flat")] = _oracle(ja, jp, jb, 0.1, False)
        ref["conv"][(dt, "per_layer")] = _oracle(jah, jph, jbh, 0.1, True)
        ref["conv"][(dt, "stale")] = _oracle(jah, jph, jbh, 0.1, False)
    out = {4: mw.join(ctx, 4, str(w4))}
    ctx = mw.start(2, str(w2), data)
    ref["jax"] = {arch: _jax_steps(*jax_in[arch]) for arch in ARCHS}
    out[2] = mw.join(ctx, 2, str(w2))
    out.update(ref=ref, data=data, dir=base)
    return out


# ---------------------------------------------------------------------------
# The step against the single-device step, the JAX package, the oracle


def _lane_id(lane):
    return "-".join(lane)


@pytest.mark.parametrize("lane", [(a,) + sl for a in ARCHS
                                  for sl in mw.STEP_LANES], ids=_lane_id)
def test_2d_step_matches_single_device(runs, lane):
    """data:2,model:2, σ = 0.8, 2 steps: the gathered params within 1e-6
    of the single-device step's, the losses equal, the ranks of one model
    slot bitwise equal across the data ranks."""
    want_p, want_l = runs["ref"]["steps"][lane]
    r4 = runs[4]
    local, got_p, got_l = r4[0]["steps"][lane]
    assert _maxdiff(got_p, want_p) < 1e-6
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for j in range(2):
        assert _bitwise(r4[j]["steps"][lane][0], r4[2 + j]["steps"][lane][0])
    assert not _bitwise(r4[0]["steps"][lane][0], r4[1]["steps"][lane][0])


def test_sliced_leaves_are_slices(runs):
    """Each rank holds its slice of a leaf the model axis divides (AlexNet:
    every conv and fc; Llama: wq, wo, the MLP, the vocabulary-sharded
    tied table) and the whole of a replicated one (wk, wv, the norms)."""
    data = runs["data"]
    for arch in ARCHS:
        local = runs[4][1]["steps"][(arch, "auto", "flat")][0]
        specs = sh.param_sharding(data[arch]["axes"], "data:2,model:2",
                                  shapes_tree=data[arch]["params"])
        n_sliced = 0
        for p in leaf_paths(specs):
            full = tuple(get_subtree(data[arch]["params"], p).shape)
            got = tuple(get_subtree(local, p).shape)
            assert got == sh.local_shape(full, get_subtree(specs, p), 2)
            n_sliced += got != full
        assert n_sliced
    llama = runs[4][0]["steps"][("llama3.2-1b", "auto", "flat")][0]
    assert llama["tok_emb"]["emb"].shape[0] == 512 // 2
    assert llama["blocks"]["attn"]["wk"]["w"].shape[-1] == 2 * 16


@pytest.mark.parametrize("lane", [(a, "auto", m) for a in ARCHS
                                  for m in ("flat", "stale")],
                         ids=_lane_id)
def test_model2_step_matches_single_device(runs, lane):
    """model:2 alone (no data degree): the same equality, both ranks one
    update."""
    want_p, want_l = runs["ref"]["steps"][lane]
    _, got_p, got_l = runs[2][0]["steps"][lane]
    assert _maxdiff(got_p, want_p) < 1e-6
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert _bitwise(got_p, runs[2][1]["steps"][lane][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_sigma0_matches_jax_package(runs, arch):
    """σ = 0 on model:2: the gathered params equal the JAX package's
    single-device step from the same params and batches."""
    want_p, want_l = runs["ref"]["jax"][arch]
    got_p, got_l = runs[2][0][("jax", arch)]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for p in leaf_paths(want_p):
        np.testing.assert_allclose(get_subtree(got_p, p).numpy(),
                                   get_subtree(want_p, p), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))


@pytest.mark.parametrize("mode", ("flat", "per_layer", "stale"))
@pytest.mark.parametrize("dt", tuple(DTYPES))
def test_conv_2d_passes_oracle(runs, dt, mode):
    """The reference's conv 2D oracle lanes: the conv's weight sliced on
    its out-channels, the 3-wide head replicated beside it; the clipped
    mean gradient (bootstrap and steady under stale) against the naive
    Jacobian oracle."""
    want = runs["ref"]["conv"][(dt, mode)]
    grads, shapes, pl_shape = runs[4][0][("conv", dt, mode)]
    assert shapes == {"w": (3, 4, 3, 3), "b": (3,)}
    if mode == "per_layer":
        assert pl_shape == (2,)
    scale = max(max(float(jnp.abs(w).max()) for w in jax.tree.leaves(want)),
                1e-3)
    wnp = _np(want)
    for g in grads:
        assert sorted(leaf_paths(g)) == sorted(leaf_paths(wnp))
        for p in leaf_paths(wnp):
            np.testing.assert_allclose(
                get_subtree(g, p).float().numpy(), get_subtree(wnp, p),
                err_msg=str(p), **_sum_tol(dt, scale))
    for r in runs[4][1:]:
        assert _bitwise(r[("conv", dt, mode)][0][0], grads[0])


def test_custom_optimizer_moments_are_slices(runs):
    """A custom optimizer callable: its moments equal the single-device
    ones (gathered) and are slices wherever the param's spec is
    unambiguous; its step count stays whole."""
    want_p, want_o, want_l = runs["ref"]["custom"]
    got_p, got_o, got_l, local = runs[4][0]["custom"]
    assert _maxdiff(got_p, want_p) < 1e-6
    assert _maxdiff(got_o["mom"], want_o["mom"]) < 1e-6
    specs = local["specs"]
    assert specs["step"] == ()
    full = runs["data"]["llama3.2-1b"]["params"]
    n = 0
    for p in leaf_paths(full):
        spec = get_subtree(specs["mom"], p)
        assert tuple(get_subtree(local["mom"], p).shape) == sh.local_shape(
            tuple(get_subtree(full, p).shape), spec, 2)
        n += sh.is_sharded(spec)
    assert n
    derived = sh.derived_specs({"mom": full}, full, specs["mom"])["mom"]
    for p in leaf_paths(full):
        d = get_subtree(derived, p)
        assert d in ((), get_subtree(specs["mom"], p))


# ---------------------------------------------------------------------------
# Resume: bitwise after a kill, across model degrees


def test_kill_and_resume_bit_identical_2d(runs):
    for r in runs[4]:
        ref_p, ref_o, got_p, got_o, steps, _ = r["resume"]
        assert _bitwise(ref_p, got_p) and _bitwise(ref_o, got_o)
        assert steps == mw.STEPS


def test_resume_across_model_degrees(runs):
    """A data:2,model:2 checkpoint (whole arrays) resumes on one device,
    and a one-device checkpoint on data:2,model:2, each within 1e-6 of
    the straight run of the other side, with no ledger gap."""
    data = runs["data"]
    straight_2d = runs[4][0]["resume"][5]
    eng = _stale_engine(data)
    ck = Checkpointer(str(runs["dir"] / "w4" / "ck_2d"))
    from repro_torch.optim import adamw_init
    full = data["alexnet"]["params"]
    st, at = ck.restore_state(full, adamw_init(full), step=1)
    assert at == 1 and st.mesh_axes == (("data", 2), ("model", 2))
    assert st.params["conv0"]["w"].shape == full["conv0"]["w"].shape
    eng.load_clip_state(st.clip_state)
    eng.accountant.load_state_dict(st.ledger)
    p, o = st.params, st.opt
    for step in range(2, mw.STEPS):
        p, o, _, _ = eng.private_step(
            p, o, mw.batch_at(data["alexnet"]["batches"], step), step=step)
    assert eng.accountant.steps == mw.STEPS
    assert _maxdiff(p, straight_2d) < 1e-6
    got, steps = runs[4][0]["from_single"]
    assert steps == mw.STEPS
    assert _maxdiff(got, runs["ref"]["stale_straight"]) < 1e-6


def _final_arrays(d, step):
    import os
    ck = Checkpointer(d)
    assert ck.latest_step() == step
    with np.load(os.path.join(d, f"step_{step:09d}", "arrays.npz")) as z:
        return dict(z), ck.read_meta(step)


def test_cli_2d_kill_resume(runs):
    """``launch.train --mesh data:2,model:2 --backend gloo`` on four
    ranks: killed before step 2, it resumes to the straight run's final
    checkpoint bitwise; the checkpoint holds whole arrays and the mesh."""
    base = runs["dir"] / "w4"
    assert "[restore] resuming from step 2" in runs[4][0]["cli"]["cli_killed"]
    a, ma = _final_arrays(str(base / "cli_straight"), 3)
    b, mb = _final_arrays(str(base / "cli_killed"), 3)
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ma["mesh_axes"] == [["data", 2], ["model", 2]]
    assert ma["ledger"] == mb["ledger"]
    w = [k for k in a if "conv0" in k and "'w'" in k and "params" in k]
    assert w and a[w[0]].shape[0] == 8


def test_cli_2d_checkpoint_resumes_on_one_device(runs, tmp_path,
                                                 monkeypatch, capsys):
    """The CLI's ``data:2,model:2`` checkpoint, resumed with no ``--mesh``
    in one process: the world cannot hold its model degree, so the model
    axis is dropped (the checkpoint holds whole arrays) and the run goes
    on from step 4 with the ledger."""
    import shutil
    from repro_torch.launch import train
    d = tmp_path / "ck"
    shutil.copytree(runs["dir"] / "w4" / "cli_straight", d)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    one_device = [a for a in mw.CLI if a not in ("--backend", "gloo")]
    one_device[one_device.index("--steps") + 1] = "6"
    train.main(one_device + ["--ckpt-dir", str(d)])
    out = capsys.readouterr().out
    assert "[elastic] checkpoint mesh data=2xmodel=2 -> " in out
    assert "[restore] resuming from step 4" in out
    a, meta = _final_arrays(str(d), 5)
    assert meta["mesh_axes"] == [] and meta["ledger"]["steps"] == 6


# ---------------------------------------------------------------------------
# The verifier's model half, calibration


def _verify_engine(data, arch, mode="flat"):
    costmodel.clear_plan_cache()
    d, model = data[arch], mw.lm_model(arch)
    return mw.engine(model.apply, d["params"], d["batches"][0], mode=mode,
                     mesh="data:2,model:2", axes=d["axes"])


def _head_engine(mode="per_layer"):
    costmodel.clear_plan_cache()
    _, t = _conv_inputs(jnp.float32, head=True)
    return mw.engine(mw.conv_apply(True), t["params"], t["batch"], mode=mode,
                     mesh="data:2,model:2", axes=mw.CONV_HEAD_AXES)


@pytest.mark.parametrize("arch,mode", [("alexnet", "flat"),
                                       ("alexnet", "per_layer"),
                                       ("alexnet", "stale"),
                                       ("llama3.2-1b", "stale")])
def test_verify_2d_clean(runs, arch, mode):
    report = _verify_engine(runs["data"], arch, mode).verify()
    assert report.ok, report.summary()
    assert "partitioned over model" in report.checked["sharding"]
    assert "model rank(s) [0, 1]" in report.checked["sharding"]
    assert "mesh=data=2xmodel=2" in report.target


def test_verify_2d_clean_replicated_head():
    """The conv's weight sliced beside a replicated head: one model sum
    for the conv's partial norm, none for the head's."""
    report = _head_engine().verify()
    assert report.ok, report.summary()


def _all_summed(norms, paths):
    ms = sh.active()
    return list(sh.all_reduce(torch.stack(norms), ms.group).unbind(0))


_real_sync = clipping.sync_grads
_real_noise = clipping.add_noise


def _contrib_over_model(gsum, shard):
    out = _real_sync(gsum, shard)
    for p in leaf_paths(out):
        out = set_subtree(out, p, sh.all_reduce(get_subtree(out, p),
                                                shard.model.group))
    return out


def _noise_per_rank(g, gen, nm, c, model=None):
    return _real_noise(g, gen, nm, c)


MUTANTS = {
    "model_norm_sum_missing": (strategies, "model_summed",
                               lambda norms, paths: norms),
    "model_norm_overcount": (strategies, "model_summed", _all_summed),
    "model_contrib_reduced": (clipping, "sync_grads", _contrib_over_model),
    "noise_slice_mismatch": (clipping, "add_noise", _noise_per_rank),
}


@pytest.mark.parametrize("code", list(MUTANTS))
def test_verify_2d_mutant_is_flagged(runs, monkeypatch, code):
    """A partial norm not summed over model; a replicated leaf's norm
    summed over it; a sliced contribution all-reduced over it; noise drawn
    per rank: each flagged by its own finding, and by it alone."""
    module, name, fn = MUTANTS[code]
    eng = (_head_engine("flat") if code == "model_norm_overcount"
           else _verify_engine(runs["data"], "alexnet"))
    monkeypatch.setattr(module, name, fn)
    codes = sorted({f.code for f in eng.verify().errors})
    assert codes == [code], codes


def test_live_verify_and_calibration_over_the_model_group(runs):
    """The verifier on a live 2D mesh traces each rank over its own
    groups (clean); ``calibrate.measure("data:2,model:2", groups=)``
    times each axis over its own group and every rank holds rank 0's
    calibration, keyed by the 2D mesh."""
    for r in runs[4]:
        ok, sharding, codes = r["live_verify"]
        assert ok, codes
        assert "partitioned over model" in sharding
    cals = [calibrate.Calibration.from_payload(r["calibration"])
            for r in runs[4]]
    assert len({c.digest() for c in cals}) == 1
    assert cals[0].mesh == (("data", 2), ("model", 2))
    assert cals[0].collective_bytes_per_second["model"] > 0
    assert cals[0].collective_bytes_per_second["data"] > 0


def test_dpcheck_mesh_2d(capsys):
    assert dpcheck.main(["--archs", "alexnet", "--mesh", "data:2,model:2",
                         "--clip-modes", "flat", "stale",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS  alexnet clip=stale mesh=data:2,model:2" in out
    assert "2/2 lanes clean" in out
