"""The block-level ``"attn"`` kind (``dp_attn``) in the port against the
JAX package's.

The lanes of ``tests/test_exactness.py``'s attention section, built in
both packages from the same numpy inputs (params from the JAX package's
``init``, carried by ``weights.params_from_numpy``): a GQA block (plain
and qk-norm) and an MLA block under a dense head, each tapped as one
``"attn"`` layer, whose per-example norms come from a layer-local
recompute of the block (``ghost``) or from the materialized
per-projection grads (``pe``), in f32 and bf16.  The per-group norms
agree with the JAX package's to rtol 1e-5 in f32 and to the reference's
bf16 ``_tol``; the clipped sums (ghost and ``auto``) to its ``_sum_tol``.
The planner prices the block as its own kind: at the toy shape it picks
``ghost`` as the reference does, and its full-width Llama-3.2-1B
``dp_attn`` plans (by meta shapes, B = 8, T = 1024, bf16, flash) make the
reference's decisions.  Reduced Llama-3.2-1B with ``dp_attn=True,
attn_impl="flash"`` (the JAX package's flash kernel in interpret mode,
the port's wrapper its plain version) takes three σ = 0 steps of bk and
``auto`` under flat, per_layer and stale clipping to the JAX package's
params (rtol 1e-5 / atol 1e-7) and per-example norms (rtol 1e-5).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.data import SyntheticLMDataset  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcmn  # noqa: E402
from repro.models.lm import TransformerLM as JLM  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.core.tapper import STATS, capture_backward  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402
from repro_torch.optim import adamw_init as tadamw_init  # noqa: E402
from repro_torch.optim import adamw_update as tadamw_update  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa

DTYPES = ("float32", "bfloat16")
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {jnp.dtype(jnp.float32): torch.float32,
        jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _tol(dtype):
    """The reference's norm tolerance (``tests/test_exactness.py``);
    port against the JAX package in f32 at rtol 1e-5."""
    return (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
            else dict(rtol=6e-2, atol=2e-3))


def _sum_tol(dtype, scale):
    """The reference's clipped-sum tolerance."""
    if dtype == "float32":
        return dict(rtol=3e-3, atol=3e-4 * scale)
    return dict(rtol=1.2e-1, atol=2e-2 * scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _head_loss_j(tp, p, feat):
    o = tp.dense("head", feat, p["head"]["w"])
    return jnp.sum(jnp.tanh(o.astype(jnp.float32)) ** 2, axis=1)


def _head_loss_t(tp, p, feat):
    # JAX promotes the f32 features times a bf16 head to f32; torch
    # multiplies one dtype, so the head enters in f32.
    o = tp.dense("head", feat, p["head"]["w"].float())
    return (torch.tanh(o.float()) ** 2).sum(dim=1)


def _block_model(kind, dtype, qk_norm=False):
    """(JAX apply, params, batch; port apply, params, batch) of one
    ``dp_attn`` block under a dense head: ``tests/test_exactness.py``'s
    ``gqa_attn_plus_head_model`` (B = 4, T = 8, D = 16, 4 / 2 heads,
    head_dim 4, seed 15) or ``mla_attn_plus_head_model`` (B = 4, T = 6,
    D = 16, 2 heads, q/kv ranks 8, nope / rope / v 4, seed 16)."""
    dt = _JDT[dtype]
    if kind == "gqa":
        B, T, D, seed = 4, 8, 16, 15
        kw = dict(n_heads=4, n_kv=2, head_dim=4, qk_norm=qk_norm)
        tree = jattn.gqa_init(jax.random.PRNGKey(seed), D, 4, 2, 4,
                              qk_norm=qk_norm, dtype=dt)
        japply_attn, tapply_attn = jattn.gqa_apply, tattn.gqa_apply
    else:
        B, T, D, seed = 4, 6, 16, 16
        kw = dict(n_heads=2, q_lora_rank=8, kv_lora_rank=8, qk_nope_dim=4,
                  qk_rope_dim=4, v_head_dim=4)
        tree = jattn.mla_init(jax.random.PRNGKey(seed), D, 2, dtype=dt,
                              **{k: v for k, v in kw.items()
                                 if k != "n_heads"})
        japply_attn, tapply_attn = jattn.mla_apply, tattn.mla_apply
    rng = np.random.RandomState(seed)
    jparams = {"attn": jcmn.split_tree(tree)[0],
               "head": {"w": jnp.asarray(rng.randn(D, 3), dt) * 0.4}}
    jbatch = {"x": jnp.asarray(rng.randn(B, T, D) * 0.5, dt)}

    def japply(p, batch, tp):
        y, _ = japply_attn(tp, "attn", p["attn"], batch["x"], dp_attn=True,
                           **kw)
        return _head_loss_j(tp, p, jnp.tanh(y.astype(jnp.float32)).mean(1))

    def tapply(p, batch, tp):
        y, _ = tapply_attn(tp, "attn", p["attn"], batch["x"], dp_attn=True,
                           **kw)
        return _head_loss_t(tp, p, torch.tanh(y.float()).mean(1))

    tparams = params_from_numpy(_np(jparams), device="cpu")
    tbatch = params_from_numpy(_np(jbatch), device="cpu")
    return (japply, jparams, jbatch), (tapply, tparams, tbatch)


def _group_norms(apply_fn, params, batch, **kw):
    _, caps, dtaps, metas = capture_backward(apply_fn, params, batch,
                                             with_metas=True)
    return tstrat.group_norms_from_captures(params, caps, dtaps, metas,
                                            **kw)


def _assert_norms_match(kind, dtype, method, qk_norm=False):
    (japply, jp, jb), (tapply, tp, tb) = _block_model(kind, dtype, qk_norm)
    _, _, (jcaps, jdtaps, jmetas) = jstrat.ghost_norms(japply, jp, jb,
                                                       attn_norm=method)
    jkeys, jn = jstrat.group_norms_from_captures(jp, jcaps, jdtaps, jmetas,
                                                 attn_norm=method)
    STATS.reset()
    tkeys, tn = _group_norms(tapply, tp, tb, attn_norm=method)
    # the block's recompute is layer-local: one forward, one backward
    assert STATS.snapshot() == {"forwards": 1, "backwards": 1, "probes": 0}
    assert tkeys == jkeys == ("attn", "head")
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("method", ("ghost", "pe"))
@pytest.mark.parametrize("qk_norm", (False, True), ids=("plain", "qknorm"))
def test_attn_gqa_norms_match_reference(qk_norm, method, dtype):
    _assert_norms_match("gqa", dtype, method, qk_norm)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("method", ("ghost", "pe"))
def test_attn_mla_norms_match_reference(method, dtype):
    _assert_norms_match("mla", dtype, method)


def _assert_clipped_sum_matches(kind, dtype, strategy, C=0.1):
    (japply, jp, jb), (tapply, tp, tb) = _block_model(kind, dtype)
    _, want, jn = jstrat.clipped_grad_sum(japply, jp, jb, l2_clip=C,
                                          check=True, strategy=strategy)
    _, got, tn = tstrat.clipped_grad_sum(tapply, tp, tb, l2_clip=C,
                                         check=True, strategy=strategy)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn, np.float32),
                               **_tol(dtype))
    want = _np(jax.tree.map(lambda a: a.astype(jnp.float32), want))
    scale = max(max(float(np.abs(w).max()) for w in jax.tree.leaves(want)),
                1.0)
    got = params_to_numpy(tree_map(lambda a: a.float(), got))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.astype(np.float32), w,
                                   **_sum_tol(dtype, scale))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("strategy", ("ghost", "auto"))
def test_attn_clipped_sum_matches_reference(strategy, dtype):
    _assert_clipped_sum_matches("gqa", dtype, strategy)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_attn_mla_clipped_sum_matches_reference(dtype):
    _assert_clipped_sum_matches("mla", dtype, "auto")


def _decisions(plan):
    return ({n: (lp.kind, lp.norm_method, lp.stash, lp.fused,
                 lp.fallback_norm) for n, lp in plan.layers.items()},
            {g.path: (g.members, g.norm_mode, g.sum_method)
             for g in plan.groups}, plan.needs_backward)


def test_attn_planner_selects_realization():
    """The planner prices the block tap as its own ``"attn"`` kind and
    picks the reference's non-materializing realization at the toy
    shape; overrides pin it to ghost or pe, and a method outside the
    kind's vocabulary is refused."""
    (japply, jp, jb), (tapply, tp, tb) = _block_model("gqa", "float32")
    for ov in (None, {"attn": "pe"}, {"attn": "ghost"}):
        jplan = jcm.get_plan(japply, jp, jb, overrides=ov)
        tplan = tcm.get_plan(tapply, tp, tb, overrides=ov)
        assert _decisions(tplan) == _decisions(jplan)
    plan = tcm.get_plan(tapply, tp, tb)
    lp = plan.layers["attn"]
    assert lp.kind == "attn" and lp.norm_method == "ghost"
    assert "attn" in plan.explain()
    assert plan.metas["attn"].static["proj_dims"] == (
        (16, 16), (16, 8), (16, 8), (16, 16))
    with pytest.raises(ValueError, match="invalid for attn"):
        tcm.get_plan(tapply, tp, tb, overrides={"attn": "gram"})


def test_attn_plan_json_roundtrip_and_v2_refusal(tmp_path):
    """A v3 plan with an ``"attn"`` layer round-trips through JSON (the
    rebuild closure is not serialized; execution takes the live metas)
    and executes alike; a plan or plan store of the port's format 2 is
    refused, naming its format."""
    _, (tapply, tp, tb) = _block_model("gqa", "float32")
    plan = tcm.get_plan(tapply, tp, tb)
    assert plan.metas["attn"].fn is not None
    back = tcm.ExecPlan.from_json(plan.to_json())
    assert back == plan and back.metas["attn"].fn is None
    want = tstrat.planned_clipped_sum(tapply, tp, tb, plan, l2_clip=0.1)
    got = tstrat.planned_clipped_sum(tapply, tp, tb, back, l2_clip=0.1)
    assert torch.equal(got[2], want[2])
    payload = plan.to_payload()
    assert payload["format"] == tcm.PLAN_FORMAT_VERSION == 4
    for old in (2, 3):
        payload["format"] = old
        with pytest.raises(ValueError, match=f"unsupported plan format {old}"):
            tcm.ExecPlan.from_payload(payload)
        store = tmp_path / "plans.json"
        store.write_text(__import__("json").dumps({"format": old,
                                                   "plans": [payload]}))
        with pytest.raises(ValueError,
                           match=f"unsupported plan format {old}"):
            tcm.load_plan_store(str(store))


def _llama_meta_plans(**opts):
    """Full-width Llama-3.2-1B with ``dp_attn=True, attn_impl="flash"``,
    B = 8, T = 1024, planned by shape in both packages."""
    B, T = 8, 1024
    jm = JLM(jget("llama3.2-1b").replace(dp_attn=True, attn_impl="flash"))
    tm = TLM(tget("llama3.2-1b").replace(dp_attn=True, attn_impl="flash"))
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=_TDT[jnp.dtype(s.dtype)], device="meta"), jp)
    jb = {k: jax.ShapeDtypeStruct((B, T), jnp.int32)
          for k in ("tokens", "labels")}
    tb = {k: torch.empty((B, T), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    return (jcm.get_plan(jm.apply, jp, jb, **opts),
            tcm.get_plan(tm.apply, tp, tb, **opts))


@pytest.mark.parametrize("opts", [
    dict(), dict(clip_mode="per_layer"), dict(clip_mode="stale"),
    dict(overrides={"blocks/attn": "pe"}),
    dict(overrides={"blocks/attn": "ghost"}),
    dict(mem_budget=8 << 30),
], ids=["flat", "per_layer", "stale", "pe", "ghost", "budget_8g"])
def test_full_width_llama_dp_attn_plan_matches_reference(opts):
    jplan, tplan = _llama_meta_plans(**opts)
    assert _decisions(tplan) == _decisions(jplan)
    lp = tplan.layers["blocks/attn"]
    assert lp.kind == "attn" and tplan.metas["blocks/attn"].scanned == 1
    assert not any(n.startswith("blocks/attn/") for n in tplan.layers)
    # the stacked block stash (16 layers x 8 examples x 10.5 M params x
    # 4 B) is priced as the reference prices it
    assert lp.stash_bytes == jplan.layers["blocks/attn"].stash_bytes \
        == 8 * 16 * (2 * 2048 * 2048 + 2 * 2048 * 512) * 4
    assert not any(lp.fused for n, lp in tplan.layers.items()
                   if lp.kind == "attn")


# ---------------------------------------------------------------------------
# Reduced Llama-3.2-1B with dp_attn and the flash kernels, through the
# engine


B, T = 2, 16


@pytest.fixture(scope="module")
def lm():
    cfg = dict(dp_attn=True, attn_impl="flash")
    jm = JLM(jget("llama3.2-1b").reduced().replace(**cfg))
    tm = TLM(tget("llama3.2-1b").reduced().replace(**cfg))
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    ds = SyntheticLMDataset(jm.cfg.vocab, T, n_examples=64)
    batches = [ds.batch(range(i * B, (i + 1) * B)) for i in range(3)]
    return jm, tm, jparams, tparams, batches


def _t(batch):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in batch.items()}


@pytest.mark.parametrize("mode", ("flat", "per_layer", "stale"))
@pytest.mark.parametrize("strategy", ("bk", "auto"))
def test_dp_attn_private_steps_match_reference(lm, strategy, mode):
    """Three σ = 0 ``private_step``s; the clip bound (0.05) is below every
    example's norm, so every step clips.  The ``auto`` plans realize the
    block as the reference's do, and never fuse it."""
    jm, tm, jparams, tparams, batches = lm
    jdp = jcore.DPConfig(l2_clip=0.05, strategy=strategy, clipping=mode)
    tdp = tcore.DPConfig(l2_clip=0.05, strategy=strategy, clipping=mode)
    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, batches[0], dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, _t(batches[0]), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    if strategy == "auto":
        tplan, jplan = teng.plan(), jeng.plan()
        assert tplan.layers["blocks/attn"].kind == "attn"
        assert not tplan.layers["blocks/attn"].fused
        assert {n: (lp.norm_method, lp.stash, lp.fused)
                for n, lp in tplan.layers.items()} == \
            {n: (lp.norm_method, lp.stash, lp.fused)
             for n, lp in jplan.layers.items()}
    jp, tp = jparams, tparams
    jopt, topt = jadamw_init(jp), tadamw_init(tp)
    for b in batches:
        jp, jopt, jloss, jaux = jeng.private_step(
            jp, jopt, jax.tree.map(jnp.asarray, b))
        tp, topt, tloss, taux = teng.private_step(tp, topt, _t(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                                   np.asarray(jaux["per_example_norms"]),
                                   rtol=1e-5)
    assert float(taux["clip_fraction"]) == 1.0
    got, want = params_to_numpy(tp), _np(jp)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
