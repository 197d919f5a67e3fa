"""The port's planner (``core/costmodel.py``) against the JAX package's.

For the toy CNN, the AlexNet-structured config at 64 px, full-width
AlexNet and VGG16 at B = 32, Llama-3.2-1B reduced and at full width and
OLMo-1B at full width (B = 8, T = 1024, bf16) with ``attn_impl="flash"``
(by shape only: JAX plans from ``jax.eval_shape`` params, the port from
``device="meta"`` tensors), the two planners must make the same per-layer
``(norm_method, stash, fused)`` decisions, group ``norm_mode`` and
``sum_method``, ``needs_backward``, capture bytes and
``microbatches="auto"`` count under flat, per_layer and stale clipping.
Plans round-trip through JSON, a stale or mismatched plan fails loudly
naming its field, and a steady stale step is one forward + one backward
with the fused realization.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.models.cnn import CNN as JCNN  # noqa: E402
from repro.models.cnn import toy_cnn_config as jtoy  # noqa: E402
from repro.models.lm import TransformerLM as JLM  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core.tapper import STATS, TensorSpec, probe  # noqa: E402
from repro_torch.models.cnn import CNN as TCNN  # noqa: E402
from repro_torch.models.cnn import toy_cnn_config as ttoy  # noqa: E402
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402

TOY = dict(n_layers=4, channel_rate=2.0, c0=16, img=32)
MODES = ("flat", "per_layer", "stale")
# arch -> (JAX config, port config, batch size, layers a stale plan fuses)
ARCHS = {
    "toy": (lambda: jtoy(**TOY), lambda: ttoy(**TOY), 4, {"conv3"}),
    "alexnet64": (
        lambda: jget("alexnet").replace(img_size=64, n_classes=10),
        lambda: tget("alexnet").replace(img_size=64, n_classes=10), 2,
        {"conv1", "conv2", "conv3", "conv4"}),
    "alexnet": (lambda: jget("alexnet"), lambda: tget("alexnet"), 32,
                {"conv2", "conv3", "conv4"}),
    "vgg16": (lambda: jget("vgg16"), lambda: tget("vgg16"), 32,
              {"conv10", "conv11", "conv12"}),
}


def _shapes(arch):
    """(JAX apply, port apply, JAX param/batch specs, port meta tensors)."""
    jcfg_fn, tcfg_fn, B, _ = ARCHS[arch]
    jm, tm = JCNN(jcfg_fn()), TCNN(tcfg_fn())
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), jp)
    S = jm.cfg.img_size
    jb = {"img": jax.ShapeDtypeStruct((B, 3, S, S), jnp.float32),
          "label": jax.ShapeDtypeStruct((B,), jnp.int32)}
    tb = {"img": torch.empty(B, 3, S, S, device="meta"),
          "label": torch.empty(B, dtype=torch.int32, device="meta")}
    return jm, tm, (jp, jb), (tp, tb)


def _decisions(cm, plan, B):
    return {
        "layers": {n: (lp.norm_method, lp.stash, lp.fused)
                   for n, lp in plan.layers.items()},
        "groups": {"/".join(map(str, g.path)):
                   (g.members, g.norm_mode, g.sum_method)
                   for g in plan.groups},
        "needs_backward": plan.needs_backward,
        "microbatches": cm.auto_microbatches(plan, B),
        "capture_bytes": plan.capture_bytes,
    }


def _both(arch, **opts):
    jm, tm, (jp, jb), (tp, tb) = _shapes(arch)
    B = ARCHS[arch][2]
    jplan = jcm.get_plan(jm.apply, jp, jb, **opts)
    tplan = tcm.get_plan(tm.apply, tp, tb, **opts)
    return _decisions(jcm, jplan, B), _decisions(tcm, tplan, B), tplan


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_plan_decisions_match_reference(arch, mode):
    want, got, plan = _both(arch, clip_mode=mode)
    assert got == want
    fused = {n for n, lp in plan.layers.items() if lp.fused}
    assert fused == (ARCHS[arch][3] if mode == "stale" else set())
    assert not (mode != "flat" and plan.needs_backward)


# LM -> (arch, config transform, batch, sequence length, the stacked
# layers a stale plan fuses)
_ATTN_MLP = {f"blocks/{n}" for n in ("attn/wq", "attn/wo", "mlp/w_gate",
                                     "mlp/w_up", "mlp/w_down")}
LMS = {"llama_reduced": ("llama3.2-1b", lambda c: c.reduced(), 2, 16,
                         None),
       "llama": ("llama3.2-1b", lambda c: c, 8, 1024, _ATTN_MLP),
       "olmo": ("olmo-1b", lambda c: c, 8, 1024,
                _ATTN_MLP | {"blocks/attn/wk", "blocks/attn/wv"})}
_TORCH_DT = {jnp.dtype(jnp.float32): torch.float32,
             jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _lm_both(lm, **opts):
    """Plan one LM in both packages, by shape."""
    arch, fn, B, T, _ = LMS[lm]
    jm = JLM(fn(jget(arch)).replace(attn_impl="flash"))
    tm = TLM(fn(tget(arch)).replace(attn_impl="flash"))
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=_TORCH_DT[jnp.dtype(s.dtype)], device="meta"), jp)
    jb = {k: jax.ShapeDtypeStruct((B, T), jnp.int32)
          for k in ("tokens", "labels")}
    tb = {k: torch.empty((B, T), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    jplan = jcm.get_plan(jm.apply, jp, jb, **opts)
    tplan = tcm.get_plan(tm.apply, tp, tb, **opts)
    return _decisions(jcm, jplan, B), _decisions(tcm, tplan, B), tplan


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lm", list(LMS))
def test_lm_plan_decisions_match_reference(lm, mode):
    want, got, plan = _lm_both(lm, clip_mode=mode)
    assert got == want
    assert plan.metas["blocks/mlp/w_up"].scanned == 1
    assert plan.metas["~tok_emb"].shared
    tied = next(g for g in plan.groups if g.path == ("tok_emb",))
    assert tied.members == ("tok_emb", "~tok_emb")
    # full width: segsum on the 128 256- and 50 304-row tables, so the
    # tied group takes the cross term; the reduced table is small enough
    # to stash
    assert tied.norm_mode == ("group_pe" if lm == "llama_reduced"
                              else "tied")
    assert not plan.needs_backward
    # Under stale clipping the stacked Gram-realized denses fuse (one
    # gram_norm_fused call per layer of the stack), as in the reference.
    fused = {n for n, lp in plan.layers.items() if lp.fused}
    if mode == "stale" and LMS[lm][4] is not None:
        assert fused == LMS[lm][4]
    elif mode != "stale":
        assert not fused


@pytest.mark.parametrize("opts", [
    dict(embed_method="segsum"),
    dict(embed_method="gram", clip_mode="per_layer"),
    dict(overrides={"blocks/mlp/*": "stream", "tok_emb": "gram"}),
    dict(mem_budget=1 << 16, clip_mode="stale"),
], ids=["segsum", "gram_per_layer", "overrides", "mem_budget_stale"])
def test_lm_plan_knobs_match_reference(opts):
    want, got, _ = _lm_both("llama_reduced", **opts)
    assert got == want


@pytest.mark.parametrize("opts", [
    dict(overrides={"conv*": "pe"}),
    dict(overrides={"conv[23]": "ghost", "fc0": "gram"}, clip_mode="stale"),
    dict(mem_budget=1 << 20),
    dict(mem_budget=1 << 20, clip_mode="stale"),
    dict(conv_norm="ghost", norm_method="gram"),
    dict(clip_mode="stale", clip_fused=False),
], ids=["overrides", "overrides_stale", "mem_budget", "mem_budget_stale",
        "fixed_methods", "stale_unfused"])
@pytest.mark.parametrize("arch", ["toy", "alexnet64"])
def test_plan_knobs_match_reference(arch, opts):
    want, got, _ = _both(arch, **opts)
    assert got == want


def test_probe_is_shape_only():
    m = TCNN(ttoy(**TOY))
    params, _ = m.init(0, device="cpu")
    spec = {"img": TensorSpec((2, 3, 32, 32), torch.float32),
            "label": TensorSpec((2,), torch.int64)}
    STATS.reset()
    metas, outs, caps = probe(m.apply, params, spec, return_captures=True)
    assert STATS.snapshot() == {"forwards": 0, "backwards": 0, "probes": 1}
    assert list(metas) == ["conv0", "conv1", "conv2", "conv3", "fc0"]
    assert outs["conv0"] == TensorSpec((2, 16, 30, 30), torch.float32)
    assert caps["fc0"]["x"] == TensorSpec((2, 128 * 5 * 5), torch.float32)
    assert outs["fc0"] == TensorSpec((2, 10), torch.float32)
    assert metas["conv1"].static["kernel_shape"] == (32, 16, 3, 3)


def _toy(B=4, seed=0):
    from repro.data import SyntheticImageDataset
    m = TCNN(ttoy(**TOY))
    params, _ = m.init(seed, device="cpu")
    b = SyntheticImageDataset(32, 10, n_examples=16).batch(range(B))
    return m, params, {k: torch.from_numpy(v) for k, v in b.items()}


def test_plan_json_roundtrip_executes_alike():
    m, params, batch = _toy()
    plan = tcm.get_plan(m.apply, params, batch, clip_mode="stale")
    plan2 = tcore.ExecPlan.from_json(plan.to_json())
    assert plan2 == plan and plan2.clip_mode == "stale"
    assert plan2.metas == plan.metas
    assert {n for n, lp in plan2.layers.items() if lp.fused} == {"conv3"}
    prev = torch.full((4,), 0.3)
    outs = [tcore.clipped_grad_sum_detailed(
        m.apply, params, batch, l2_clip=0.1, strategy="auto", plan=p,
        clip_policy=tcore.ClipPolicy(mode="stale"), prev_norms_sq=prev)
        for p in (plan, plan2)]
    assert torch.equal(outs[0][2], outs[1][2])
    assert "fused single-pass" in plan2.explain()


def test_stale_plans_fail_loudly():
    m, params, batch = _toy()
    flat = tcm.get_plan(m.apply, params, batch)
    with pytest.raises(ValueError, match="clipping mode"):
        tcm.check_plan_matches(flat, clip_mode="stale")
    with pytest.raises(ValueError, match="clipping mode"):
        tcore.PrivacyEngine(m.apply, params, batch, device="cpu", plan=flat,
                            dp=tcore.DPConfig(clipping="per_layer"))
    with pytest.raises(ValueError, match="clipping mode"):
        tcore.clipped_grad_sum_detailed(
            m.apply, params, batch, l2_clip=0.1, strategy="auto", plan=flat,
            clip_policy=tcore.ClipPolicy(mode="per_layer"))
    half = {k: v[:2] for k, v in batch.items()}
    with pytest.raises(ValueError, match="batch shape"):
        tcore.PrivacyEngine(m.apply, params, half, device="cpu", plan=flat)
    with pytest.raises(ValueError, match="fingerprint"):
        tcore.PrivacyEngine(m.apply, params, batch, device="cpu", plan=flat,
                            dp=tcore.DPConfig(norm=tcore.NormCfg(conv="pe")))
    with pytest.raises(ValueError, match="calibration"):
        tcm.check_plan_matches(dataclasses.replace(flat, calibration="x"),
                               calibration="")
    other = TCNN(ttoy(n_layers=2, channel_rate=2.0, c0=16, img=32))
    oparams, _ = other.init(0, device="cpu")
    with pytest.raises(ValueError, match="does not match this model"):
        tcore.clipped_grad_sum_detailed(other.apply, oparams, batch,
                                        l2_clip=0.1, strategy="auto",
                                        plan=flat)
    # The injected plan that does match runs without a probe.
    eng = tcore.PrivacyEngine(m.apply, params, batch, device="cpu",
                              plan=flat)
    assert eng.plan() is flat and eng.fingerprint() == flat.fingerprint
    STATS.reset()
    eng.noisy_grad(params, batch)
    assert STATS.probes == 0


def test_steady_stale_step_is_one_pass_and_fused():
    m, params, batch = _toy()
    tcm.clear_plan_cache()
    eng = tcore.PrivacyEngine(m.apply, params, batch, device="cpu",
                              dp=tcore.DPConfig(l2_clip=0.1,
                                                clipping="stale"))
    plan = eng.plan()
    assert plan.clip_mode == "stale" and plan.layers["conv3"].fused
    _, _, prev, _ = tcore.clipped_grad_sum_detailed(
        m.apply, params, batch, l2_clip=0.1, strategy="auto")
    STATS.reset()
    tcore.clipped_grad_sum_detailed(
        m.apply, params, batch, l2_clip=0.1, strategy="auto", plan=plan,
        clip_policy=tcore.ClipPolicy(mode="stale"), prev_norms_sq=prev)
    assert STATS.snapshot() == {"forwards": 1, "backwards": 1, "probes": 0}
    assert STATS.fused >= 1


def test_flat_auto_caches_its_plan():
    m, params, batch = _toy()
    tcm.clear_plan_cache()
    STATS.reset()
    for _ in range(2):
        tcore.clipped_grad_sum(m.apply, params, batch, l2_clip=0.1,
                               strategy="auto")
    # The knobs of a direct call: embed_method defaults to "segsum" there,
    # as in the JAX package.
    knobs = dict(embed_method="segsum")
    plan = tcm.get_plan(m.apply, params, batch, **knobs)
    passes = 2 if plan.needs_backward else 1
    assert STATS.snapshot() == {"forwards": 2 * passes,
                                "backwards": 2 * passes, "probes": 1}
    assert plan.fingerprint == tcore.plan_fingerprint(m.apply, params,
                                                      batch, **knobs)
    assert len(tcore.code_fingerprint()) == 12


def test_auto_microbatches_split_over_budget():
    m, params, batch = _toy()
    plan = tcm.get_plan(m.apply, params, batch)
    need = plan.capture_bytes + plan.peak_stash_bytes()
    assert tcm.auto_microbatches(plan, 4, mem_budget=need) == 1
    assert tcm.auto_microbatches(plan, 4, mem_budget=need / 2) == 2
    assert tcm.auto_microbatches(plan, 4, mem_budget=1) == 4
    cfg = tcore.DPConfig(microbatches="auto",
                         norm=tcore.NormCfg(mem_budget=int(need / 2)))
    assert tcore.resolve_microbatches(m.apply, params, batch, cfg) == 2
    eng = tcore.PrivacyEngine(m.apply, params, batch, cfg, device="cpu")
    assert eng.microbatches() == 2 and "(auto)" in eng.explain()
    _, g2, _ = eng.noisy_grad(params, batch)
    _, g1, _ = tcore.dp_gradient(m.apply, params, batch,
                                 cfg=tcore.DPConfig())
    for layer in g1:
        for k in g1[layer]:
            np.testing.assert_allclose(g2[layer][k].numpy(),
                                       g1[layer][k].numpy(), rtol=1e-5,
                                       atol=1e-8)


def test_planner_rejects_what_it_does_not_serve():
    m, params, batch = _toy()
    # A pure-data mesh plans, and so does a model axis under measured
    # constants (item 14 part 2 calibrates and runs it).
    assert tcm.get_plan(m.apply, params, batch,
                        mesh="data:8").mesh == (("data", 8),)
    from repro_torch import calibrate
    assert tcm.get_plan(m.apply, params, batch, mesh="data:4,model:2",
                        calibration=calibrate.injected(
                            mesh="data:4,model:2", device="cpu")).mesh \
        == (("data", 4), ("model", 2))
    # The planner prices under a Calibration (or the analytic table);
    # "measure" and paths are the engine's to resolve.
    with pytest.raises(TypeError, match="PrivacyEngine resolves"):
        tcm.get_plan(m.apply, params, batch, calibration="measure")
    with pytest.raises(ValueError, match="invalid for conv"):
        tcm.get_plan(m.apply, params, batch, overrides={"conv0": "gram"})


def test_executor_backward_sum_phase_exact():
    """No dense or conv layer makes the planner pick the shared weighted
    backward (a contraction never costs more than its wgrad share), so
    force a group onto it: the executor still gives the naive clipped
    sum and pays one more forward + backward."""
    m, params, batch = _toy()
    plan = tcm.get_plan(m.apply, params, batch)
    assert not plan.needs_backward
    groups = tuple(dataclasses.replace(g, sum_method="backward")
                   if g.path == ("fc0",) else g for g in plan.groups)
    forced = dataclasses.replace(plan, groups=groups, needs_backward=True)
    _, want, _ = tcore.clipped_grad_sum(m.apply, params, batch,
                                        l2_clip=0.05, strategy="naive")
    STATS.reset()
    _, got, _, _ = tcore.planned_clipped_sum(m.apply, params, batch, forced,
                                             l2_clip=0.05, check=True)
    assert STATS.snapshot() == {"forwards": 2, "backwards": 2, "probes": 0}
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k].numpy(),
                                       want[layer][k].numpy(), rtol=1e-4,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="weighted backward"):
        tcore.planned_clipped_sum(
            m.apply, params, batch,
            dataclasses.replace(forced, clip_mode="per_layer"), l2_clip=0.05,
            clip_policy=tcore.ClipPolicy(mode="per_layer"))
