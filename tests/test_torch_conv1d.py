"""DP-SGD on a network of plain 1-D convs: the port against the JAX
package.

The repo has no model with plain 1-D convs, so the network is written
here in both packages (as ``tests/test_exactness.py`` writes its
``conv_model``): three tapped 1-D convs (stride = dilation = 1, groups =
1, "same" padding), ReLU after each, a mean over time and a tapped dense
head of 10 classes, f32, with the same numpy params and batches.  Under
``conv_impl="pallas"`` every conv's per-example gradient goes through
``pe_conv_grad_1d`` (its plain version here, on the CPU; the JAX package's
Pallas kernel in interpret mode).

At σ = 0, three ``private_step``s of ``crb`` and of ``auto`` (flat) must
leave the same params (rtol 1e-4 / atol 1e-6, AdamW eps 1e-6 and lr 1e-4
as in ``test_torch_slice.py``), with the same per-step losses and
per-example norms (rtol 1e-4), and the planner must make the same
per-layer decisions as ``repro.core.costmodel.get_plan``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import adamw_init as tadamw_init  # noqa: E402
from repro_torch.optim import adamw_update as tadamw_update  # noqa: E402
from test_torch_planner import _decisions  # noqa: E402
from test_torch_slice import _assert_tree_close, _t  # noqa: E402

# (name, C, D, K, padding)
LAYERS = [("conv0", 3, 8, 5, 2), ("conv1", 8, 12, 3, 1),
          ("conv2", 12, 6, 3, 1)]
B, T, CLASSES = 4, 32, 10


def _numpy_params(seed=0):
    rng = np.random.RandomState(seed)
    p = {n: {"w": (rng.randn(d, c, k) / np.sqrt(c * k)).astype(np.float32),
             "b": (0.1 * rng.randn(d)).astype(np.float32)}
         for n, c, d, k, _ in LAYERS}
    d = LAYERS[-1][2]
    p["head"] = {"w": (rng.randn(d, CLASSES) / np.sqrt(d)).astype(np.float32),
                 "b": np.zeros(CLASSES, np.float32)}
    return p


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(B, 3, T).astype(np.float32),
             "label": rng.randint(0, CLASSES, (B,)).astype(np.int32)}
            for _ in range(n)]


def jax_apply(params, batch, tp):
    h = batch["x"]
    for n, _, _, _, pad in LAYERS:
        h = jax.nn.relu(tp.conv(n, h, params[n]["w"], params[n]["b"],
                                padding=pad))
    logits = tp.dense("head", h.mean(axis=2), params["head"]["w"],
                      params["head"]["b"])
    logp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(logp, batch["label"][:, None], 1)[:, 0]


def torch_apply(params, batch, tp):
    h = batch["x"]
    for n, _, _, _, pad in LAYERS:
        h = torch.relu(tp.conv(n, h, params[n]["w"], params[n]["b"],
                               padding=pad))
    logits = tp.dense("head", h.mean(dim=2), params["head"]["w"],
                      params["head"]["b"])
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, batch["label"].long()[:, None])[:, 0]


def _specs():
    jp = jax.tree.map(jnp.asarray, _numpy_params())
    tp = _t(_numpy_params())
    b = _batches(1)[0]
    return jp, tp, jax.tree.map(jnp.asarray, b), _t(b)


@pytest.mark.parametrize("mode", ["flat", "per_layer", "stale"])
def test_conv1d_plan_decisions_match_reference(mode):
    jp, tp, jb, tb = _specs()
    jplan = jcm.get_plan(jax_apply, jp, jb, clip_mode=mode)
    tplan = tcm.get_plan(torch_apply, tp, tb, clip_mode=mode)
    assert _decisions(tcm, tplan, B) == _decisions(jcm, jplan, B)
    assert set(tplan.layers) == {n for n, *_ in LAYERS} | {"head"}


@pytest.mark.parametrize("strategy", ["crb", "auto"])
def test_conv1d_private_steps_match_reference(strategy):
    steps = 3
    jparams = jax.tree.map(jnp.asarray, _numpy_params())
    tparams = _t(_numpy_params())
    batches = _batches(steps)
    jdp = jcore.DPConfig(l2_clip=0.5, strategy=strategy,
                         norm=jcore.NormCfg(conv_impl="pallas"))
    tdp = tcore.DPConfig(l2_clip=0.5, strategy=strategy,
                         norm=tcore.NormCfg(conv_impl="pallas"))
    jeng = jcore.PrivacyEngine(
        jax_apply, jparams, jax.tree.map(jnp.asarray, batches[0]), dp=jdp,
        lr=1e-4, optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        torch_apply, tparams, _t(batches[0]), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    if strategy == "auto":
        assert _decisions(tcm, teng.plan(), B) == _decisions(jcm, jeng.plan(),
                                                             B)
    jopt, topt = jadamw_init(jparams), tadamw_init(tparams)
    before = dict(ops.LAUNCHES)
    for b in batches:
        jparams, jopt, jloss, jaux = jeng.private_step(
            jparams, jopt, jax.tree.map(jnp.asarray, b))
        tparams, topt, tloss, taux = teng.private_step(tparams, topt, _t(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                                   np.asarray(jaux["per_example_norms"]),
                                   rtol=1e-4)
    assert ops.LAUNCHES == before        # the CPU takes the plain versions
    _assert_tree_close({k: {n: v.numpy() for n, v in d.items()}
                        for k, d in tparams.items()},
                       jax.tree.map(np.asarray, jparams), rtol=1e-4,
                       atol=1e-6)


def test_conv1d_crb_reaches_the_1d_kernel_path(monkeypatch):
    """crb with ``conv_impl="pallas"`` sends every plain 1-D conv to
    ``ops.pe_conv_grad_1d`` (once each per step), padded first."""
    seen = []
    real = ops.pe_conv_grad_1d

    def spy(x, dy, *, K):
        seen.append((tuple(x.shape), tuple(dy.shape), K))
        return real(x, dy, K=K)

    monkeypatch.setattr(ops, "pe_conv_grad_1d", spy)
    _, tp, _, tb = _specs()
    tcore.clipped_grad_sum(torch_apply, tp, tb, l2_clip=1.0, strategy="crb",
                           conv_impl="pallas")
    assert seen == [((B, c, T + 2 * pad), (B, d, T), k)
                    for _, c, d, k, pad in LAYERS]
