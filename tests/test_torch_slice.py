"""The slice as a whole: the port's DP-SGD step against the JAX package's,
through the entry points (``dp_gradient`` and ``PrivacyEngine``).

Params are initialized in JAX and loaded into the port
(``weights.params_from_numpy``); batches come from the shared synthetic
dataset.  At σ = 0 the per-example losses, the per-example norms and the
clipped gradient must agree, and 3 ``private_step``s with AdamW must
leave the same params (rtol 1e-4 / atol 1e-6: f32 sums in another
order, compounded over three Adam steps).  Both packages' AdamW runs
with eps 1e-6 and lr 1e-4: for a coordinate whose gradient is near eps
the update g/(|g| + eps) turns a last-bit difference of g into a
visible one, and at the default eps 1e-8 a few of AlexNet's 20 M
coordinates land there.  The toy CNN runs every
strategy, and again with every kernel knob set in the port
(``NormCfg(conv_impl="pallas", dense="pallas", conv="pallas")``, the
kernels' plain versions on the CPU) against the JAX package's jnp
realizations of the same function.  ``test_torch_alexnet.py`` runs the
AlexNet-structured config.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.data import SyntheticImageDataset  # noqa: E402
from repro.models.cnn import CNN as JCNN  # noqa: E402
from repro.models.cnn import toy_cnn_config as jtoy  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro_torch import calibrate  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.models.cnn import CNN as TCNN  # noqa: E402
from repro_torch.models.cnn import toy_cnn_config as ttoy  # noqa: E402
from repro_torch.optim import adamw_init as tadamw_init  # noqa: E402
from repro_torch.optim import adamw_update as tadamw_update  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa

PALLAS = dict(conv_impl="pallas", dense="pallas", conv="pallas")


def _t(tree):
    return {k: _t(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def _assert_tree_close(got, want, rtol, atol):
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], rtol, atol)
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), rtol=rtol,
                                       atol=atol, err_msg=k)


_JAX_PARAMS = {}


def _jax_params(jm):
    """JAX init once per config and process (threefry on the CPU takes
    seconds at AlexNet width)."""
    if jm.cfg not in _JAX_PARAMS:
        _JAX_PARAMS[jm.cfg] = jax.jit(lambda k: jm.init(k)[0])(
            jax.random.PRNGKey(0))
    return _JAX_PARAMS[jm.cfg]


def run_parity(jcfg, tcfg, strategy, B, *, port_norm=None, l2_clip=1.0):
    """σ=0 clipped sums and three AdamW private_steps in each package,
    compared."""
    jm, tm = JCNN(jcfg), TCNN(tcfg)
    jparams = _jax_params(jm)
    pnp = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(pnp, like=tm.init(0, device="cpu")[0],
                                device="cpu")
    ds = SyntheticImageDataset(jcfg.img_size, jcfg.n_classes, n_examples=64)
    batches = [ds.batch(range(i * B, (i + 1) * B)) for i in range(3)]

    jdp = jcore.DPConfig(l2_clip=l2_clip, strategy=strategy)
    tdp = tcore.DPConfig(l2_clip=l2_clip, strategy=strategy,
                         norm=tcore.NormCfg(**(port_norm or {})))
    b0 = batches[0]
    # The JAX package's clipped sum, per-example losses and norms against
    # the port's dp_gradient (grad = clipped sum / B) and its per-example
    # losses.
    jl, jsum, jn = jax.jit(functools.partial(
        jcore.clipped_grad_sum, jm.apply, l2_clip=l2_clip,
        strategy=strategy))(jparams, jax.tree.map(jnp.asarray, b0))
    tl, _, _ = tcore.clipped_grad_sum(
        tm.apply, tparams, _t(b0), l2_clip=l2_clip, strategy=strategy,
        norm_method=tdp.norm.dense, conv_impl=tdp.norm.conv_impl,
        conv_norm=tdp.norm.conv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    tloss, tgrad, taux = tcore.dp_gradient(tm.apply, tparams, _t(b0),
                                           cfg=tdp)
    np.testing.assert_allclose(float(tloss), float(np.mean(jl)), rtol=1e-5)
    np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                               np.sqrt(np.asarray(jn) + 1e-12), rtol=1e-5)
    _assert_tree_close(params_to_numpy(tgrad),
                       jax.tree.map(lambda g: np.asarray(g) / B, jsum),
                       rtol=1e-4, atol=1e-7)

    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, b0, dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, _t(b0), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    jopt, topt = jadamw_init(jparams), tadamw_init(tparams)
    for b in batches:
        jparams, jopt, jloss, _ = jeng.private_step(
            jparams, jopt, jax.tree.map(jnp.asarray, b))
        tparams, topt, tloss, _ = teng.private_step(tparams, topt, _t(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    _assert_tree_close(params_to_numpy(tparams),
                       jax.tree.map(np.asarray, jparams), rtol=1e-4,
                       atol=1e-6)


TOY = dict(n_layers=4, channel_rate=2.0, c0=4, img=32)


@pytest.mark.parametrize("strategy", ["naive", "multi", "crb", "ghost", "bk"])
def test_toy_cnn_step_parity(strategy):
    run_parity(jtoy(**TOY), ttoy(**TOY), strategy, B=3)


@pytest.mark.parametrize("strategy", ["crb", "ghost", "bk"])
def test_toy_cnn_step_parity_kernel_knobs(strategy):
    run_parity(jtoy(**TOY), ttoy(**TOY), strategy, B=3, port_norm=PALLAS)


def test_fixed_strategies_only():
    """A mesh with a model axis verifies (item 14 part 2: the step of a
    rank of a fake data x model world, its params sliced) where the
    batch divides its data degree, and raises where it does not; a
    calibration blob measured on other hardware raises; the planned
    strategy, injected plans and stale clipping run, and a fixed
    strategy's explain shows the plan as advisory."""
    cfg = ttoy(**TOY)
    m = TCNN(cfg)
    params, axes = m.init(0, device="cpu")
    batch = {"img": torch.zeros(2, 3, 32, 32),
             "label": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="not divisible"):
        tcore.PrivacyEngine(m.apply, params, batch, device="cpu",
                            dp=tcore.DPConfig(strategy="crb"),
                            mesh="data:4,model:2").verify()
    report = tcore.PrivacyEngine(m.apply, params, batch, device="cpu",
                                 dp=tcore.DPConfig(strategy="crb"),
                                 mesh="data:2,model:2",
                                 param_axes=axes).verify()
    assert report.ok, report.summary()
    assert "partitioned over model" in report.checked["sharding"]
    foreign = calibrate.injected(hardware="cuda:NVIDIA H100 80GB HBM3:1")
    with pytest.raises(calibrate.CalibrationHardwareMismatch):
        tcore.PrivacyEngine(m.apply, params, batch, device="cpu",
                            dp=tcore.DPConfig(strategy="crb"),
                            calibration=foreign)
    plan = tcore.get_plan(m.apply, params, batch)
    for kw in ({"dp": tcore.DPConfig(strategy="auto")},
               {"dp": tcore.DPConfig(strategy="auto"), "plan": plan},
               {"dp": tcore.DPConfig(strategy="bk", clipping="stale")}):
        eng = tcore.PrivacyEngine(m.apply, params, batch, device="cpu", **kw)
        for _ in range(2):      # the stale bootstrap, then a steady step
            _, grad, aux = eng.noisy_grad(params, batch)
        assert torch.isfinite(aux["per_example_norms"]).all()
    assert eng.clip_state_dict()["prev_norms_sq"].shape == (2,)
    _, _, aux = tcore.dp_gradient(m.apply, params, batch,
                                  cfg=tcore.DPConfig(strategy="auto"))
    assert aux["per_example_norms"].shape == (2,)
    eng = tcore.PrivacyEngine(m.apply, params, batch, device="cpu",
                              dp=tcore.DPConfig(strategy="ghost",
                                                microbatches="auto"))
    assert eng.microbatches() == 1
    assert "fixed strategy 'ghost'" in eng.explain()
    assert "advisory" in eng.explain()


def test_microbatches_sum_like_one_batch():
    """An integer microbatch count splits the batch in a Python loop; the
    clipped mean gradient is the same up to summation order."""
    cfg = ttoy(**TOY)
    m = TCNN(cfg)
    params, _ = m.init(1, device="cpu")
    ds = SyntheticImageDataset(32, 10, n_examples=16)
    batch = _t(ds.batch(range(4)))
    outs = [tcore.dp_gradient(m.apply, params, batch,
                              cfg=tcore.DPConfig(strategy="bk",
                                                 microbatches=mb))
            for mb in (1, 2)]
    _assert_tree_close(params_to_numpy(outs[1][1]),
                       params_to_numpy(outs[0][1]), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(outs[1][2]["per_example_norms"].numpy(),
                               outs[0][2]["per_example_norms"].numpy(),
                               rtol=1e-6)
