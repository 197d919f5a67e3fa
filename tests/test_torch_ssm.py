"""The SSM family (``models/ssm.py``, the ``local_vjp`` kind, xLSTM) in the
port against the JAX package's.

The three recurrences (``_ssd_scan``, ``_mlstm_scan``, ``_slstm_scan``) on
random f32 inputs from a numpy seed (B = 3, T = 8), forward and the VJP of
a random cotangent, and the three ``*_apply`` / ``*_step`` pairs on the
JAX package's init: rtol 1e-5.  The ``local_vjp`` kind's ``pe_grad``,
``norm_sq`` and ``contrib`` on the captures of reduced xLSTM's sLSTM
recurrence, stacked (``scanned`` 1) and one layer alone, against
``repro.core.kinds.apply_kind`` (Zamba2's SSD parameters, ``scanned`` 2,
in ``tests/test_torch_hybrid.py``).  The planner's ``local_vjp`` pricing:
the stash vetoed tips the group into the shared weighted backward (the
reference's ``tests/test_planner.py`` case), and the plans of reduced and
full-width xLSTM-125M (by shape only) equal the reference's.  Then
reduced xLSTM-125M (2 super-blocks of one mLSTM and one sLSTM, d_model
64): losses (rtol 1e-5), metas, captures and cotangents (rtol 1e-5 and
2e-5 of the largest entry: ``torch_recurrent_parity.COT_ATOL``), group
norms (rtol 1e-5), ghost and bk against the
port's own ``naive`` (``tests/test_ghost_archs.py``'s tolerances: norms
rtol 3e-4, sums 5e-5 of the largest entry), three σ = 0 steps of bk,
``auto`` flat and ``auto`` stale against the JAX package's, and prefill +
4 decode steps (logits, tokens, every recurrent state).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core.tapper import LayerMeta as JMeta  # noqa: E402
from repro.core.tapper import Tapper as JTapper  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import kinds as tkinds  # noqa: E402
from repro_torch.core.tapper import LayerMeta as TMeta  # noqa: E402
from repro_torch.core.tapper import Tapper, TensorSpec  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.tree import get_subtree  # noqa: E402

import torch_recurrent_parity as rp  # noqa: E402

B, T = rp.B, rp.T
ARCH = "xlstm-125m"


def test_configs_match_reference():
    """Both configs field for field, reduced too (``attn_every``,
    ``slstm_every``, ``ssm_state`` cut as the reference cuts them), and
    both build."""
    for arch in (ARCH, "zamba2-2.7b"):
        t, j = tget(arch), jget(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.reduced()) == \
            dataclasses.asdict(j.reduced())
        assert isinstance(build_model(t), TLM)
    assert tget(ARCH).reduced().slstm_every == 2
    z = tget("zamba2-2.7b").reduced()
    assert (z.attn_every, z.n_layers, z.ssm_state) == (2, 4, 16)


def _vjp_both(jf, tf, args, ct):
    """Forward and the VJP of ``ct`` w.r.t. every argument (a params dict
    first, then arrays), in both packages."""
    jy, vjp = jax.vjp(jf, *jax.tree.map(jnp.asarray, args))
    jg = vjp(jnp.asarray(ct))
    targs = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True),
                         args)
    ty = tf(*targs)
    leaves = jax.tree.leaves(targs)
    tg = torch.autograd.grad(ty, leaves, torch.from_numpy(ct))
    rp.close(ty, jy, what="y")
    for i, (g, w) in enumerate(zip(tg, jax.tree.leaves(jg))):
        rp.close(g, w, what=f"grad {i}")


def test_ssd_scan_matches_reference():
    rng = np.random.RandomState(0)
    nh, hd, ds = 2, 4, 5
    params = {"A_log": rng.randn(nh).astype(np.float32) * 0.5,
              "D": rng.randn(nh).astype(np.float32),
              "dt_bias": rng.randn(nh).astype(np.float32)}
    args = (params, rng.randn(B, T, nh, hd).astype(np.float32),
            rng.randn(B, T, ds).astype(np.float32),
            rng.randn(B, T, ds).astype(np.float32),
            rng.randn(B, T, nh).astype(np.float32))
    ct = rng.randn(B, T, nh, hd).astype(np.float32)
    _vjp_both(jssm._ssd_scan, tssm._ssd_scan, args, ct)


def test_mlstm_scan_matches_reference():
    rng = np.random.RandomState(1)
    H, hd = 2, 4
    args = tuple(rng.randn(B, T, H, hd).astype(np.float32) for _ in range(3))
    args += tuple(rng.randn(B, T, H).astype(np.float32) * 2 for _ in range(2))
    ct = rng.randn(B, T, H, hd).astype(np.float32)
    _vjp_both(jssm._mlstm_scan, tssm._mlstm_scan, args, ct)


def test_slstm_scan_matches_reference():
    rng = np.random.RandomState(2)
    H, hd = 2, 4
    D = H * hd
    params = {"R": rng.randn(4, H, hd, hd).astype(np.float32) * 0.3,
              "b": rng.randn(4, D).astype(np.float32) * 0.1}
    args = (params, rng.randn(B, T, 4, D).astype(np.float32))
    ct = rng.randn(B, T, D).astype(np.float32)
    _vjp_both(jssm._slstm_scan, tssm._slstm_scan, args, ct)


D_MODEL = 64
_BLOCKS = {
    "mamba2": (jssm.mamba2_init, jssm.mamba2_apply, jssm.mamba2_state,
               jssm.mamba2_step, tssm.mamba2_apply, tssm.mamba2_state,
               tssm.mamba2_step, dict(d_state=16)),
    "mlstm": (jssm.mlstm_init, jssm.mlstm_apply, jssm.mlstm_state,
              jssm.mlstm_step, tssm.mlstm_apply, tssm.mlstm_state,
              tssm.mlstm_step, dict(n_heads=4)),
    "slstm": (jssm.slstm_init, jssm.slstm_apply, jssm.slstm_state,
              jssm.slstm_step, tssm.slstm_apply, tssm.slstm_state,
              tssm.slstm_step, dict(n_heads=4)),
}


@pytest.mark.parametrize("block", list(_BLOCKS))
def test_apply_and_step_match_reference(block):
    """``*_apply`` over T = 8 and ``*_step`` token by token from the zero
    state (the JAX package's init, through numpy): outputs and states
    rtol 1e-5, and the steps equal the apply position by position."""
    jinit, japply, jstate, jstep, tapply, tstate, tstep, kw = _BLOCKS[block]
    p = jax.tree.map(np.asarray, jcm.split_tree(
        jinit(jax.random.PRNGKey(3), D_MODEL, **kw))[0])
    tp = rp.t_(p)
    # slstm_state takes no n_heads
    init_kw = {} if block == "slstm" else kw
    x = np.random.RandomState(4).randn(B, T, D_MODEL).astype(np.float32)
    jy = japply(JTapper(), "blk", jax.tree.map(jnp.asarray, p),
                jnp.asarray(x), **kw)
    with torch.no_grad():
        ty = tapply(Tapper(), "blk", tp, torch.from_numpy(x), **kw)
    rp.close(ty, jy, what="apply")
    js = jstate(B, D_MODEL, **init_kw)
    ts = tstate(B, D_MODEL, **init_kw)
    for t in range(T):
        jo, js = jstep(jax.tree.map(jnp.asarray, p), js,
                       jnp.asarray(x[:, t]), **kw)
        with torch.no_grad():
            to, ts = tstep(tp, ts, torch.from_numpy(x[:, t]), **kw)
        rp.close(to, jo, what=f"step {t}")
        rp.close(ts, jax.tree.map(np.asarray, js), what=f"state {t}")
        rp.close(to, np.asarray(jy)[:, t], rtol=1e-4, what=f"vs apply {t}")


# ---------------------------------------------------------------------------
# The local_vjp kind, on the captures of the reduced models


@pytest.fixture(scope="module")
def xl():
    return rp.setup(ARCH)


@pytest.fixture(scope="module")
def captured(xl):
    jm, tm, jparams, tparams, batches = xl
    return rp.capture_both(jm, tm, jparams, tparams, batches[0])


@pytest.mark.parametrize("op", ("pe_grad", "norm_sq", "contrib"))
@pytest.mark.parametrize("layer", ((), (1,)), ids=["stacked", "one_layer"])
def test_local_vjp_kind_matches_reference(xl, captured, op, layer):
    """The kind on sLSTM's captured recurrence (R and b, ``scanned`` 1),
    stacked and one layer alone: rtol 1e-5, atol 1e-5 of the largest
    entry (``tests/test_torch_hybrid.py`` takes Mamba2's, ``scanned``
    2)."""
    rp.check_local_vjp_kind(xl[2], xl[3], captured, "blocks/s/blk/rec",
                            layer, op, scanned=1)


def test_local_vjp_without_fn_is_refused_by_name(xl, captured):
    (_, _, _, _), (tmetas, tcaps, tdtaps, _) = captured
    n = "blocks/s/blk/rec"
    meta = dataclasses.replace(tmetas[n], fn=None)
    with pytest.raises(ValueError, match="has no fn"):
        tkinds.apply_kind("norm_sq", meta, tcaps[n], tdtaps[n],
                          params_sub=get_subtree(xl[3], meta.path))


def test_local_vjp_captures_are_tuples(captured):
    """A local_vjp tap captures its inputs as a tuple, stacked element by
    element over the scanned layers; the probe records them as a tuple of
    specs."""
    (_, _, _, _), (tmetas, tcaps, tdtaps, _) = captured
    ins = tcaps["blocks/s/blk/rec"]["inputs"]
    assert isinstance(ins, tuple) and len(ins) == 1
    assert tuple(ins[0].shape) == (2, B, T, 4, 64)
    from repro_torch.core.tapper import probe
    cfg = tget(ARCH).reduced()
    tm = TLM(cfg)
    p = tm.init(0, device="cpu")[0]
    _, _, caps = probe(tm.apply, p, {
        "tokens": torch.zeros((B, T), dtype=torch.int32),
        "labels": torch.zeros((B, T), dtype=torch.int32)},
        return_captures=True)
    spec = caps["blocks/s/blk/rec"]["inputs"]
    assert type(spec) is tuple and spec == (TensorSpec((2, B, T, 4, 64),
                                                       torch.float32),)


# ---------------------------------------------------------------------------
# The planner


def test_planner_backward_sum_phase_reachable():
    """The reference's case (``tests/test_planner.py``): a local_vjp layer
    whose per-example-grad stash blows the budget pays the vmapped-VJP
    premium on its contraction, and when it dominates the model the plan
    routes its sum through one shared weighted backward — in both
    packages, alike."""
    Bb, Tt, D = 8, 128, 256
    budget = Bb * 4096 * 4096 * 4 // 2
    jplan = jcost.plan_execution(
        {"ssm": JMeta("local_vjp", ("ssm",), fn=lambda p, x: x),
         "head": JMeta("dense", ("head",))},
        {"ssm": {"inputs": (jax.ShapeDtypeStruct((Bb, Tt, D),
                                                 jnp.float32),)},
         "head": {"x": jax.ShapeDtypeStruct((Bb, 1, 8), jnp.float32)}},
        {"ssm": jax.ShapeDtypeStruct((Bb, Tt, D), jnp.float32),
         "head": jax.ShapeDtypeStruct((Bb, 1, 4), jnp.float32)},
        lambda: {}, {"ssm": {"A": jnp.zeros((4096, 4096))},
                     "head": {"w": jnp.zeros((8, 4))}}, mem_budget=budget)
    tplan = tcost.plan_execution(
        {"ssm": TMeta("local_vjp", ("ssm",), fn=lambda p, x: x),
         "head": TMeta("dense", ("head",))},
        {"ssm": {"inputs": (TensorSpec((Bb, Tt, D), torch.float32),)},
         "head": {"x": TensorSpec((Bb, 1, 8), torch.float32)}},
        {"ssm": TensorSpec((Bb, Tt, D), torch.float32),
         "head": TensorSpec((Bb, 1, 4), torch.float32)},
        {"ssm": {"A": torch.empty((4096, 4096), device="meta")},
         "head": {"w": torch.empty((8, 4), device="meta")}},
        mem_budget=budget)
    assert not tplan.layers["ssm"].stash
    assert tplan.needs_backward
    sums = {g.path: g.sum_method for g in tplan.groups}
    assert sums[("ssm",)] == "backward" and sums[("head",)] != "backward"
    assert rp.plan_decisions(tplan) == rp.plan_decisions(jplan)
    # and within the budget the stash wins: no backward
    small = tcost.plan_execution(
        tplan.metas, {"ssm": {"inputs": (TensorSpec((Bb, Tt, D),
                                                    torch.float32),)},
                      "head": {"x": TensorSpec((Bb, 1, 8), torch.float32)}},
        tplan.tap_shapes, {"ssm": {"A": torch.empty((64, 64))},
                           "head": {"w": torch.empty((8, 4))}})
    assert small.layers["ssm"].stash and not small.needs_backward
    assert small.layers["ssm"].contrib_flops == \
        tcost.LOCAL_VJP_CONTRIB_PENALTY * small.layers["ssm"].norm_flops


@pytest.mark.parametrize("lane,mode", [("reduced", "flat"),
                                       ("reduced", "stale"),
                                       ("full", "stale")])
def test_plans_match_reference(lane, mode):
    """``get_plan`` by shape only, reduced at B = 3, T = 8 and at the card
    lane's shape (full width, B = 8, T = 128): see
    ``torch_recurrent_parity.check_plans``."""
    if lane == "reduced":
        rp.check_plans(ARCH, lambda c: c.reduced(), B, T, mode)
    else:
        rp.check_plans(ARCH, lambda c: c, 8, 128, mode)


# ---------------------------------------------------------------------------
# Reduced xLSTM-125M


def test_losses_and_cotangents_match_reference(captured):
    tmetas = rp.check_losses_and_cotangents(captured)
    assert tmetas["blocks/s/blk/rec"].kind == "local_vjp"
    assert tmetas["blocks/m/blk/wq"].scanned == 2
    assert tmetas["blocks/s/blk/wx"].scanned == 1


def test_group_norms_match_reference(xl, captured):
    keys = rp.check_group_norms(xl[2], xl[3], captured)
    assert "blocks/s/blk/rec" in keys and "blocks/m/blk/conv" in keys


@pytest.mark.parametrize("strategy", ("ghost", "bk"))
def test_norms_and_sums_match_naive(xl, strategy):
    _, tm, _, tparams, batches = xl
    rp.check_against_naive(tm, tparams, batches[1], strategy)


@pytest.mark.parametrize("strategy,mode", [("bk", "flat"), ("auto", "flat"),
                                           ("auto", "stale")])
def test_private_steps_match_reference(xl, strategy, mode):
    rp.check_private_steps(*xl, strategy, mode)


def test_prefill_and_decode_match_reference(xl):
    jm, tm, jparams, tparams, _ = xl
    tc = rp.check_prefill_and_decode(jm, tm, jparams, tparams)
    assert sorted(tc["layers"]) == ["m", "s"]
    assert tuple(tc["layers"]["m"]["C"].shape) == (2, 1, 2, 4, 32, 32)


def test_bf16_decode_rule_holds_in_both_packages():
    """The bf16 decode-equals-forward rule ``chip_smoke.py`` holds this
    family to on the card (served logits within twice the bf16 forward's
    distance from the f32 forward, plus 2^-8 of the largest) holds for
    the JAX package's own decode too, on the same reduced bf16 weights."""
    rec = rp.check_bf16_decode_against_f32(ARCH)
    assert sorted(rec) == ["jax", "port"]
