"""The planned step (``strategy="auto"``) and the non-flat clipping modes:
the port against the JAX package.

At σ = 0, three ``PrivacyEngine.private_step``s under flat, per_layer
(uniform, mapping and ``"auto"`` budgets) and stale clipping must leave
the same params (rtol 1e-4 / atol 1e-6, AdamW eps 1e-6 and lr 1e-4 as in
``test_torch_slice.py``), with the same per-step losses, per-example
norms and mode-specific metrics, on the toy CNN and the AlexNet- and
VGG16-structured configs (``test_torch_alexnet.py`` and
``test_torch_vgg16.py`` run those through the helpers here); so must bk
under per_layer and stale.  The fused norm+contrib
realizations (``kinds.*_norm_and_contrib``) are held against the JAX
package's on their own, and the budget split keeps Σ C_l² = C².
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import kinds as jkinds  # noqa: E402
from repro.core.tapper import LayerMeta as JMeta  # noqa: E402
from repro.data import SyntheticImageDataset  # noqa: E402
from repro.models.cnn import CNN as JCNN  # noqa: E402
from repro.models.cnn import toy_cnn_config as jtoy  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import kinds as tkinds  # noqa: E402
from repro_torch.core.tapper import STATS, LayerMeta  # noqa: E402
from repro_torch.models.cnn import CNN as TCNN  # noqa: E402
from repro_torch.models.cnn import toy_cnn_config as ttoy  # noqa: E402
from repro_torch.optim import adamw_init as tadamw_init  # noqa: E402
from repro_torch.optim import adamw_update as tadamw_update  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa
from test_torch_slice import _assert_tree_close, _jax_params, _t  # noqa

TOY = dict(n_layers=4, channel_rate=2.0, c0=16, img=32)
ALEX64 = dict(img_size=64, n_classes=10)
VGG32 = dict(img_size=32, n_classes=10)
# A mapping split: the classifier groups get twice the conv groups' weight.
MAPPING = {"fc*": 2.0}
CLIPPINGS = {
    "flat": "flat",
    "per_layer_uniform": "per_layer",
    "per_layer_mapping": dict(mode="per_layer", budgets=MAPPING),
    "per_layer_auto": dict(mode="per_layer", budgets="auto", ema=0.5),
    "stale": "stale",
}


def _policy(pkg, spec):
    return spec if isinstance(spec, str) else pkg.ClipPolicy(**spec)


def _cfgs(arch):
    if arch == "toy":
        return jtoy(**TOY), ttoy(**TOY), 4
    if arch == "vgg16_32":
        return jget("vgg16").replace(**VGG32), \
            tget("vgg16").replace(**VGG32), 2
    return jget("alexnet").replace(**ALEX64), \
        tget("alexnet").replace(**ALEX64), 2


def run_mode_parity(arch, strategy, clipping, l2_clip=0.05, steps=3):
    """σ = 0 private_steps in both packages under one clipping policy;
    losses, per-example norms, mode metrics and params compared."""
    jcfg, tcfg, B = _cfgs(arch)
    jm, tm = JCNN(jcfg), TCNN(tcfg)
    jparams = _jax_params(jm)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    ds = SyntheticImageDataset(jcfg.img_size, jcfg.n_classes, n_examples=64)
    batches = [ds.batch(range(i * B, (i + 1) * B)) for i in range(steps)]
    jdp = jcore.DPConfig(l2_clip=l2_clip, strategy=strategy,
                         clipping=_policy(jcore, clipping))
    tdp = tcore.DPConfig(l2_clip=l2_clip, strategy=strategy,
                         clipping=_policy(tcore, clipping))
    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, batches[0], dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, _t(batches[0]), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    jopt, topt = jadamw_init(jparams), tadamw_init(tparams)
    keys = ("per_example_norms", "clip_fraction", "clip_fraction_lagged",
            "per_layer_norms", "per_layer_clip_fraction", "clip_budgets")
    for b in batches:
        jparams, jopt, jloss, jaux = jeng.private_step(
            jparams, jopt, jax.tree.map(jnp.asarray, b))
        tparams, topt, tloss, taux = teng.private_step(tparams, topt, _t(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        assert {k for k in keys if k in taux} == {k for k in keys
                                                  if k in jaux}
        for k in keys:
            if k in jaux:
                np.testing.assert_allclose(taux[k].numpy(),
                                           np.asarray(jaux[k]), rtol=1e-4,
                                           atol=1e-6, err_msg=k)
    _assert_tree_close(params_to_numpy(tparams),
                       jax.tree.map(np.asarray, jparams), rtol=1e-4,
                       atol=1e-6)
    return teng, taux


@pytest.mark.parametrize("clipping", list(CLIPPINGS))
def test_auto_step_parity(clipping):
    teng, _ = run_mode_parity("toy", "auto", CLIPPINGS[clipping])
    plan = teng.plan()
    assert plan.clip_mode == teng.dp.clipping.mode
    if clipping == "stale":
        assert any(lp.fused for lp in plan.layers.values())


@pytest.mark.parametrize("clipping", ["per_layer_uniform", "stale"])
def test_bk_step_parity_under_modes(clipping):
    run_mode_parity("toy", "bk", CLIPPINGS[clipping])


# ---------------------------------------------------------------------------
# Budgets: Σ C_l² = C²


@pytest.mark.parametrize("budgets, observed", [
    ("uniform", None), (MAPPING, None), ("auto", [0.3, 2.0, 0.7, 1e-3]),
    ("auto", None)])
def test_budgets_match_reference_and_keep_sensitivity(budgets, observed):
    keys = ("conv0", "conv1", "fc0", "fc1")
    C = 0.7
    got = tcore.resolve_budgets(
        tcore.ClipPolicy(mode="per_layer", budgets=budgets), C, keys,
        observed=observed)
    want = jcore.resolve_budgets(
        jcore.ClipPolicy(mode="per_layer", budgets=budgets), C, keys,
        observed=observed)
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(tcore.clipping_sensitivity(got.numpy()), C,
                               rtol=1e-6)
    if budgets == MAPPING:
        np.testing.assert_allclose(got[2] / got[0], 2.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# The engine's clip state


def _toy_engine(clipping, l2_clip=0.05):
    jcfg, tcfg, B = _cfgs("toy")
    tm = TCNN(tcfg)
    params, _ = tm.init(0, device="cpu")
    ds = SyntheticImageDataset(tcfg.img_size, tcfg.n_classes, n_examples=16)
    batch = _t(ds.batch(range(B)))
    eng = tcore.PrivacyEngine(
        tm.apply, params, batch, device="cpu",
        dp=tcore.DPConfig(l2_clip=l2_clip, clipping=clipping))
    return eng, params, batch


def test_stale_bootstrap_then_steady_state():
    eng, params, batch = _toy_engine("stale")
    opt = tadamw_init(params)
    STATS.reset()
    _, _, _, aux1 = eng.private_step(params, opt, batch)
    # Bootstrap: exact flat clipping under a flat plan, no fused pass.
    assert STATS.fused == 0
    np.testing.assert_allclose(float(aux1["clip_fraction_lagged"]),
                               float(aux1["clip_fraction"]))
    prev = aux1["clip_state"]["prev_norms_sq"]
    assert isinstance(prev, torch.Tensor)
    assert eng.clip_state_dict()["prev_norms_sq"].shape == (4,)
    STATS.reset()
    _, _, _, aux2 = eng.private_step(params, opt, batch)
    assert STATS.snapshot() == {"forwards": 1, "backwards": 1, "probes": 0}
    assert STATS.fused >= 1
    # Same params and batch: the lagged norms equal the current ones.
    np.testing.assert_allclose(aux2["per_example_norms"].numpy(),
                               np.sqrt(prev.numpy() + 1e-12), rtol=1e-5)
    np.testing.assert_allclose(float(aux2["clip_fraction_lagged"]),
                               float(aux2["clip_fraction"]))
    # A checkpointed clip state resumes the steady state, not a bootstrap.
    state = eng.clip_state_dict()
    eng.reset_clip_state()
    assert eng.clip_state_dict() == {}
    eng.load_clip_state(state)
    STATS.reset()
    eng.noisy_grad(params, batch)
    assert STATS.fused >= 1


def test_clip_fraction_lagged_reports_applied_coefficients():
    eng, params, batch = _toy_engine("stale")
    cfg = eng.dp
    _, _, aux = tcore.dp_gradient(eng.apply_fn, params, batch, cfg=cfg)
    assert "clip_fraction_lagged" in aux and "clip_state" in aux
    # Tiny previous norms: the lagged coefficients clipped nothing, while
    # every current norm exceeds C.
    tiny = {"prev_norms_sq": torch.full((4,), 1e-8)}
    _, _, aux2 = tcore.dp_gradient(eng.apply_fn, params, batch, cfg=cfg,
                                   clip_state=tiny)
    assert float(aux2["clip_fraction_lagged"]) == 0.0
    assert float(aux2["clip_fraction"]) == 1.0


def test_auto_budgets_track_and_stay_calibrated():
    policy = tcore.ClipPolicy(mode="per_layer", budgets="auto", ema=0.5)
    eng, params, batch = _toy_engine(policy)
    G = len(eng.plan().groups)
    uniform = eng._clip_state()["budgets"].numpy()
    np.testing.assert_allclose(uniform, 0.05 / np.sqrt(G), rtol=1e-6)
    _, _, _, aux = eng.private_step(params, tadamw_init(params), batch)
    assert aux["per_layer_norms"].shape == (G, 4)
    np.testing.assert_allclose(float(aux["clip_fraction"]),
                               float(aux["per_layer_clip_fraction"].mean()),
                               rtol=1e-6)
    adapted = eng.clip_state_dict()["budgets"]
    np.testing.assert_allclose(tcore.clipping_sensitivity(adapted), 0.05,
                               rtol=1e-5)
    assert np.abs(adapted - uniform).max() > 1e-6


@pytest.mark.parametrize("mode", ["per_layer", "stale"])
def test_microbatches_sum_like_one_batch_under_modes(mode):
    eng, params, batch = _toy_engine(mode)
    state = None
    if mode == "stale":
        _, _, aux = tcore.dp_gradient(eng.apply_fn, params, batch,
                                      cfg=eng.dp)
        state = aux["clip_state"]
    outs = [tcore.dp_gradient(
        eng.apply_fn, params, batch, clip_state=state,
        cfg=tcore.DPConfig(l2_clip=0.05, clipping=mode, microbatches=m))[1]
        for m in (1, 2)]
    _assert_tree_close(params_to_numpy(outs[1]), params_to_numpy(outs[0]),
                       rtol=1e-5, atol=1e-8)


def test_fused_equals_unfused_and_is_deterministic():
    """Stale with ClipPolicy(fused=True) equals fused=False on the same
    lagged norms, and two fused runs are bitwise equal."""
    eng, params, batch = _toy_engine("stale")
    _, _, aux = tcore.dp_gradient(eng.apply_fn, params, batch, cfg=eng.dp)
    prev = aux["clip_state"]["prev_norms_sq"]

    def run(fused):
        return tcore.clipped_grad_sum_detailed(
            eng.apply_fn, params, batch, l2_clip=0.05, strategy="auto",
            clip_policy=tcore.ClipPolicy(mode="stale", fused=fused),
            prev_norms_sq=prev)

    f1, f2, unfused = run(True), run(True), run(False)
    np.testing.assert_allclose(f1[2].numpy(), unfused[2].numpy(), rtol=1e-4,
                               atol=1e-6)
    _assert_tree_close(params_to_numpy(f1[1]), params_to_numpy(unfused[1]),
                       rtol=1e-4, atol=1e-6)
    assert torch.equal(f1[2], f2[2])
    for a, b in zip(params_to_numpy(f1[1]).values(),
                    params_to_numpy(f2[1]).values()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# The fused norm+contrib realizations, layer by layer


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("bias, w_transposed, T", [
    (True, False, 7), (False, True, 5), (True, False, 1)])
def test_dense_norm_and_contrib_matches_reference(bias, w_transposed, T):
    rng = np.random.RandomState(T)
    B, Di, Do = 3, 6, 4
    x, dy, w = _rand(rng, B, T, Di), _rand(rng, B, T, Do), rng.rand(B)
    bk = "b" if bias else None
    jn, jc = jkinds.dense_norm_and_contrib(
        JMeta("dense", ("l",), bias_key=bk, w_transposed=w_transposed),
        {"x": jnp.asarray(x)}, jnp.asarray(dy), jnp.asarray(w, jnp.float32),
        method="pallas")
    before = STATS.fused
    tn, tc = tkinds.dense_norm_and_contrib(
        LayerMeta("dense", ("l",), bias_key=bk, w_transposed=w_transposed),
        {"x": torch.from_numpy(x)}, torch.from_numpy(dy),
        torch.from_numpy(w.astype(np.float32)))
    assert STATS.fused == before + 1
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("C, D, HW, K, stride, pad, groups, bias", [
    (3, 4, 7, 3, 1, 1, 1, True), (4, 6, 9, 3, 2, 0, 2, True),
    (2, 5, 6, 2, 1, 0, 1, False)])
def test_conv_norm_and_contrib_matches_reference(C, D, HW, K, stride, pad,
                                                 groups, bias):
    rng = np.random.RandomState(C * D)
    B = 3
    x = _rand(rng, B, C, HW, HW)
    Ho = (HW + 2 * pad - K) // stride + 1
    dy = _rand(rng, B, D, Ho, Ho)
    w = rng.rand(B).astype(np.float32)
    static = {"stride": stride, "dilation": 1, "padding": pad,
              "groups": groups, "kernel_shape": (D, C // groups, K, K)}
    bk = "b" if bias else None
    jn, jc = jkinds.conv_norm_and_contrib(
        JMeta("conv", ("c",), bias_key=bk, static=static),
        {"x": jnp.asarray(x)}, jnp.asarray(dy), jnp.asarray(w),
        use_pallas=True)
    tn, tc = tkinds.conv_norm_and_contrib(
        LayerMeta("conv", ("c",), bias_key=bk, static=static),
        {"x": torch.from_numpy(x)}, torch.from_numpy(dy),
        torch.from_numpy(w))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-6)
    # The fused realization equals the separate norm + contribution.
    meta = LayerMeta("conv", ("c",), bias_key=bk, static=static)
    cap, tdy, tw = {"x": torch.from_numpy(x)}, torch.from_numpy(dy), \
        torch.from_numpy(w)
    n_sep = tkinds.conv_norm_sq(meta, cap, tdy, method="ghost")
    c_sep = tkinds.conv_contrib(meta, cap, tdy, tw)
    np.testing.assert_allclose(tn.numpy(), n_sep.numpy(), rtol=1e-5)
    for k in c_sep:
        np.testing.assert_allclose(tc[k].numpy(), c_sep[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shared", [False, True])
def test_apply_norm_contrib_routes(shared):
    # Unscanned dense layers fuse whether shared or not, as the planner
    # marks them (the unfused pair of a shared layer comes with the LM
    # slice, so the unshared pair is the yardstick); scanned ones raise.
    rng = np.random.RandomState(0)
    meta = LayerMeta("dense", ("l",), bias_key="b", shared=shared)
    cap = {"x": torch.from_numpy(_rand(rng, 2, 3, 5))}
    dy = torch.from_numpy(_rand(rng, 2, 3, 4))
    w = torch.tensor([0.5, 1.0])
    before = STATS.fused
    n_f, c_f = tkinds.apply_norm_contrib(meta, cap, dy, weights=w)
    assert STATS.fused == before + 1
    n_u, c_u = tkinds.apply_norm_contrib(
        LayerMeta("dense", ("l",), bias_key="b"), cap, dy, weights=w,
        fused=False, norm_method="gram")
    assert STATS.fused == before + 1
    np.testing.assert_allclose(n_f.numpy(), n_u.numpy(), rtol=1e-5)
    for k in c_u:
        np.testing.assert_allclose(c_f[k].numpy(), c_u[k].numpy(),
                                   rtol=1e-5, atol=1e-7)
    with pytest.raises(NotImplementedError, match="LM slice"):
        tkinds.apply_norm_contrib(
            LayerMeta("dense", ("l",), scanned=1), cap, dy, weights=w)
