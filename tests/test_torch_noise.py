"""Noise, accounting and the numpy-side copies of the port.

* The noise stream is a pure function of (run_seed, step): the same pair
  gives bitwise-equal noise, another step other noise, and the empirical
  std on a 1e6-element leaf is σC within 1%.
* ε of the port's accountant equals ``repro.core.privacy``'s to 1e-12,
  and a ledger of another mechanism raises ``LedgerMismatch``.
* Synthetic batches, configs and the optimizers match the JAX package's.
* ``DPConfig`` keeps its validation and its legacy-kwarg shim; every
  knob the planned step reads is honored, ``NormCfg.embed`` included
  (the embedding kinds read it; ``test_torch_lm.py`` shows its effect).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.privacy as jpriv  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
import repro_torch.core.privacy as tpriv  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import (DPConfig, KeyProvenanceError, NormCfg,  # noqa
                              PrivacyEngine, add_noise, dp_gradient)
from repro_torch.core.clipping import ClipPolicy  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.cnn import CNN, toy_cnn_config  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa


@pytest.fixture(scope="module")
def toy_engine():
    cfg = toy_cnn_config(2, 2.0, c0=4, img=16)
    m = CNN(cfg)
    params, _ = m.init(0, device="cpu")
    ds = tsyn.SyntheticImageDataset(16, 10, n_examples=8)
    b = ds.batch(range(3))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    eng = PrivacyEngine(m.apply, params, batch, device="cpu", run_seed=7,
                        dp=DPConfig(strategy="bk", noise_multiplier=1.3,
                                    l2_clip=0.5),
                        sampling_rate=0.01)
    return eng, params, batch


def test_noise_stream_is_a_function_of_run_seed_and_step(toy_engine):
    eng, params, batch = toy_engine
    _, g1, _ = eng.noisy_grad(params, batch, step=5)
    _, g2, _ = eng.noisy_grad(params, batch, step=5)
    _, g3, _ = eng.noisy_grad(params, batch, step=6)
    n1, n2, n3 = (params_to_numpy(g) for g in (g1, g2, g3))
    for layer in n1:
        for k in n1[layer]:
            np.testing.assert_array_equal(n1[layer][k], n2[layer][k])
            assert not np.array_equal(n1[layer][k], n3[layer][k])
    # An explicit generator must carry the stream's seed for that step.
    eng.noisy_grad(params, batch, eng.noise_key(5), step=5)
    with pytest.raises(KeyProvenanceError):
        eng.noisy_grad(params, batch, eng.noise_key(4), step=5)
    with pytest.raises(ValueError, match="noise"):
        eng.noisy_grad(params, batch)


def test_noise_std_and_dtype():
    g = torch.Generator().manual_seed(0)
    tree = {"a": {"w": torch.zeros(1000, 1000)},
            "b": {"w": torch.zeros(10, dtype=torch.bfloat16)}}
    out = add_noise(tree, g, noise_multiplier=1.5, l2_clip=0.4)
    std = out["a"]["w"].std().item()
    assert abs(std - 0.6) / 0.6 < 0.01
    assert out["b"]["w"].dtype == torch.bfloat16
    assert add_noise(tree, g, 0.0, 1.0) is tree


def test_private_step_accounts(toy_engine):
    eng, params, batch = toy_engine
    from repro_torch.optim import sgdm_init
    eng.accountant.reset()
    eng._update_fn = tadamw.sgdm_update
    p, opt = params, sgdm_init(params)
    for s in range(2):
        p, opt, loss, aux = eng.private_step(p, opt, batch, step=s)
        assert torch.isfinite(loss)
    assert eng.accountant.steps == 2 and int(opt["step"]) == 2
    ref = jpriv.PrivacyAccountant(0.01, 1.3)
    ref.step(2)
    assert abs(eng.epsilon() - ref.epsilon(1e-5)) <= 1e-12
    assert "eps=" in eng.report()


@pytest.mark.parametrize("q,sigma,steps", [(0.01, 1.1, 1000),
                                           (0.004, 0.8, 250),
                                           (1.0, 2.0, 10)])
def test_epsilon_matches_reference(q, sigma, steps):
    a, b = tpriv.PrivacyAccountant(q, sigma), jpriv.PrivacyAccountant(q, sigma)
    a.step(steps)
    b.step(steps)
    assert abs(a.epsilon(1e-5) - b.epsilon(1e-5)) <= 1e-12
    assert tpriv.clipping_sensitivity([0.6, 0.8]) == \
        jpriv.clipping_sensitivity([0.6, 0.8])


def test_ledger_mismatch():
    a = tpriv.PrivacyAccountant(0.01, 1.1)
    a.step(3)
    state = a.state_dict()
    b = tpriv.PrivacyAccountant(0.01, 1.1)
    b.load_state_dict(state)
    assert b.steps == 3
    with pytest.raises(tpriv.LedgerMismatch):
        tpriv.PrivacyAccountant(0.02, 1.1).load_state_dict(state)


def test_synthetic_batches_bitwise_equal():
    for ds_t, ds_j in ((tsyn.SyntheticImageDataset(24, 7, seed=3),
                        jsyn.SyntheticImageDataset(24, 7, seed=3)),
                       (tsyn.SyntheticLMDataset(50, 9, seed=2),
                        jsyn.SyntheticLMDataset(50, 9, seed=2))):
        bt, bj = ds_t.batch([0, 5, 9]), ds_j.batch([0, 5, 9])
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])
    for a, b in zip(tsyn.poisson_batch_indices(3, 500, 0.05, 16, seed=1),
                    jsyn.poisson_batch_indices(3, 500, 0.05, 16, seed=1)):
        np.testing.assert_array_equal(a, b)


def test_configs_match_reference():
    for arch in ("alexnet", "vgg16"):
        t, j = tget(arch), jget(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.reduced()) == \
            dataclasses.asdict(j.reduced())
        assert t.torch_dtype == torch.float32
    for arch in ("llama3.2-1b", "olmo-1b"):
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(
            jget(arch))


def test_optimizers_match_reference():
    rng = np.random.RandomState(0)
    p = {"a": {"w": rng.randn(5, 4).astype(np.float32)},
         "b": {"b": rng.randn(4).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                          p) for _ in range(3)]
    tp = params_from_numpy(p, device="cpu")
    jp = jax.tree.map(jnp.asarray, p)
    for init, upd, kw in ((tadamw.adamw_init, tadamw.adamw_update,
                           dict(lr=1e-2, weight_decay=0.1)),
                          (tadamw.sgdm_init, tadamw.sgdm_update,
                           dict(lr=1e-2, weight_decay=0.1))):
        jinit = getattr(jadamw, init.__name__)
        jupd = getattr(jadamw, upd.__name__)
        ts, js, tq, jq = init(tp), jinit(jp), tp, jp
        for g in grads:
            tq, ts = upd(params_from_numpy(g, device="cpu"), ts, tq, **kw)
            jq, js = jupd(jax.tree.map(jnp.asarray, g), js, jq, **kw)
        got, want = params_to_numpy(tq), jax.tree.map(np.asarray, jq)
        for layer in want:
            for k in want[layer]:
                np.testing.assert_allclose(got[layer][k], want[layer][k],
                                           rtol=1e-6, atol=1e-7)
    for step in (0, 3, 10, 50):
        np.testing.assert_allclose(
            float(tsched.cosine_schedule(step, warmup=5, total=40, peak=0.1,
                                         floor=0.01)),
            float(jsched.cosine_schedule(step, warmup=5, total=40, peak=0.1,
                                         floor=0.01)), rtol=1e-6)
        np.testing.assert_allclose(
            float(tsched.linear_warmup(step, warmup=5, peak=0.1)),
            float(jsched.linear_warmup(step, warmup=5, peak=0.1)), rtol=1e-6)


def test_params_from_numpy_checks_structure():
    like = {"fc0": {"w": torch.zeros(3, 2), "b": torch.zeros(2)}}
    good = {"fc0": {"w": np.ones((3, 2), np.float32),
                    "b": np.ones(2, np.float32)}}
    out = params_from_numpy(good, like=like, device="cpu")
    assert out["fc0"]["w"].shape == (3, 2)
    np.testing.assert_array_equal(params_to_numpy(out)["fc0"]["w"],
                                  good["fc0"]["w"])
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({"fc0": {"w": good["fc0"]["w"]}}, like=like,
                          device="cpu")
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy({"fc0": dict(good["fc0"], g=np.ones(2))},
                          like=like, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy({"fc0": dict(good["fc0"], b=np.ones(3))},
                          like=like, device="cpu")


def test_dpconfig_validation_and_legacy_shim():
    with pytest.raises(ValueError, match="microbatches"):
        DPConfig(microbatches=0)
    with pytest.raises(ValueError, match="requires strategy"):
        DPConfig(strategy="ghost", clipping="per_layer")
    with pytest.raises(ValueError, match="clipping mode"):
        DPConfig(clipping="nope")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = DPConfig(strategy="crb", conv_impl="pallas", norm_method="gram",
                       conv_norm=None)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert cfg.norm == NormCfg(dense="gram", conv="auto", conv_impl="pallas")
    assert DPConfig(overrides={"conv*": "pe"}).overrides == (("conv*", "pe"),)


def _fused_toy():
    """A toy CNN whose stale plan fuses a layer (conv3, Gram regime)."""
    m = CNN(toy_cnn_config(4, 2.0, c0=16, img=32))
    params, _ = m.init(0, device="cpu")
    b = tsyn.SyntheticImageDataset(32, 10, n_examples=4).batch(range(2))
    return m.apply, params, {k: torch.from_numpy(v) for k, v in b.items()}


def _knob_honored(knob, apply_fn, params, batch, cfg):
    """Show, knob by knob, that the planned step reads it."""
    from repro_torch.core.tapper import STATS
    eng = PrivacyEngine(apply_fn, params, batch, cfg, device="cpu")
    base = PrivacyEngine(apply_fn, params, batch,
                         dataclasses.replace(cfg, overrides=(),
                                             norm=NormCfg(),
                                             clipping=ClipPolicy(
                                                 mode=cfg.clipping.mode)),
                         device="cpu")
    plan, plan0 = eng.plan(), base.plan()
    if knob in ("overrides", "NormCfg.mem_budget", "NormCfg.embed",
                "ClipPolicy.fused"):
        assert plan.fingerprint != plan0.fingerprint
    if knob == "overrides":
        assert plan0.layers["conv0"].norm_method == "pe"
        assert all(lp.norm_method == "ghost"
                   for n, lp in plan.layers.items() if n.startswith("conv"))
    elif knob == "NormCfg.mem_budget":
        assert plan0.peak_stash_bytes() > cfg.norm.mem_budget
        assert plan.peak_stash_bytes() <= cfg.norm.mem_budget
    elif knob == "ClipPolicy.fused":
        assert any(lp.fused for lp in plan0.layers.values())
        assert not any(lp.fused for lp in plan.layers.values())
    outs = []
    for s in range(2):          # stale: bootstrap, then a steady step
        STATS.reset()
        outs.append(eng.noisy_grad(params, batch)[2])
    if knob == "ClipPolicy.fused":
        assert STATS.fused == 0
    if knob == "ClipPolicy.budgets":
        b = outs[0]["clip_budgets"]
        keys = [g.path[0] for g in plan.groups]
        assert b[keys.index("fc0")] / b[keys.index("conv0")] == \
            pytest.approx(2.0, rel=1e-6)
    if knob in ("ClipPolicy.quantile", "ClipPolicy.ema"):
        # Replay the engine's tracking on the host: quantile q of each
        # group's norms, then an EMA with factor ema.
        qs = [np.quantile(a["per_layer_norms"].numpy().astype(np.float64),
                          cfg.clipping.quantile, axis=1) for a in outs]
        want = cfg.clipping.ema * qs[0] + (1 - cfg.clipping.ema) * qs[1]
        np.testing.assert_allclose(eng.clip_state_dict()["budget_q"], want,
                                   rtol=1e-12)


@pytest.mark.parametrize("knob, kw", [
    ("overrides", dict(overrides={"conv*": "ghost"})),
    ("NormCfg.embed", dict(norm=NormCfg(embed="gram"))),
    ("NormCfg.mem_budget", dict(norm=NormCfg(mem_budget=1 << 10))),
    ("NormCfg.embed", dict(embed_norm="segsum")),
    ("ClipPolicy.budgets", dict(clipping=ClipPolicy(mode="per_layer",
                                                    budgets={"fc*": 2.0}))),
    ("ClipPolicy.quantile", dict(clipping=ClipPolicy(
        mode="per_layer", budgets="auto", quantile=0.7))),
    ("ClipPolicy.ema", dict(clipping=ClipPolicy(mode="per_layer",
                                                budgets="auto", ema=0.5))),
    ("ClipPolicy.fused", dict(clipping=ClipPolicy(mode="stale",
                                                  fused=False))),
])
def test_planner_only_knobs_raise_at_use(toy_engine, knob, kw):
    """Under ``strategy="auto"`` every knob the planner and the clipping
    modes read is honored, none raises and none is ignored:
    ``NormCfg.embed`` now reaches the planner (its key and fingerprint)
    and the embedding kinds."""
    eng, params, batch = toy_engine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = DPConfig(strategy="auto", l2_clip=0.05, **kw)
    if knob == "NormCfg.embed":
        assert cfg.planner_opts()["embed_method"] == cfg.norm.embed
        dp_gradient(eng.apply_fn, params, batch, cfg=cfg)
    if knob == "ClipPolicy.fused":
        _knob_honored(knob, *_fused_toy(), cfg)
    else:
        _knob_honored(knob, eng.apply_fn, params, batch, cfg)
