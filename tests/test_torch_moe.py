"""The MoE family in the port against the JAX package's.

``models/moe.py`` at D = 32, F = 16, E = 4, k = 2, B = 2, T = 8 (f32):
``moe_apply``'s output and per-example load-balance loss under the
``einsum``, ``gather`` and ``sort`` dispatch (rtol 1e-5), the routing
(``top_e``) asserted equal first; the segmented dense tap
(``Tapper.dense_segmented``: metas field by field) and its kinds
(``seg_dense_pe_grad``, ``seg_dense_norm_sq`` stream and gram and
``seg_dense_contrib``, rtol 1e-4, atol 1e-6 of the largest entry) on the captures of one MoE layer; the planner's
``seg_norm_method`` and plans of reduced and full-width Granite (by
shape only).  Then the model: reduced Granite-3.0-1B-A400M
(``attn_impl="flash"``, the JAX package's flash in interpret mode, the
port's plain version) and reduced DeepSeek-V3-671B (MLA + MoE + a shared
expert, the plain softmax): params from the JAX package's ``init``
through numpy, the routing of every layer equal (each token's k-th
largest router probability at least ``MARGIN`` above its (k+1)-th in
both packages, so that a last-ulp difference cannot flip an expert),
per-example losses (rtol 1e-5) and every tap's cotangent (rtol 1e-5,
atol ``COT_ATOL`` of the largest entry, the f32 spread measured against
float64), the per-group norms (rtol 1e-5), three σ = 0
``private_step``s of ghost and ``auto`` under flat and stale clipping
(params rtol 1e-4, atol 1e-6, as ``tests/test_torch_lm.py``), and
prefill + 4 greedy decode steps (logits rtol 1e-5 / atol 1e-6, tokens
equal).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import kinds as jkinds  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.core.tapper import Tapper as JTapper  # noqa: E402
from repro.core.tapper import probe as jprobe  # noqa: E402
from repro.data import SyntheticLMDataset  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lm import TransformerLM as JLM  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import kinds as tkinds  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.core.tapper import LayerMeta as TMeta  # noqa: E402
from repro_torch.core.tapper import Tapper, capture_backward  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import adamw_init as tadamw_init  # noqa: E402
from repro_torch.optim import adamw_update as tadamw_update  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa

D, F, E, K, B, T = 32, 16, 4, 2, 2, 8
IMPLS = ("einsum", "gather", "sort")
# Each token's k-th largest router probability must exceed its (k+1)-th
# by this much in the test inputs: the packages' probabilities differ by
# a few f32 ulps, far below it, so no expert can flip between them.
MARGIN = 1e-4
# The model lanes: B = 2 examples of T = 16 tokens.
MB, MT = 2, 16
# The cotangents of the reduced MoE models are held to rtol 1e-5 and an
# absolute floor of COT_ATOL of the tensor's largest entry.  Against the
# port's own float64 run, each package's f32 cotangents of reduced
# DeepSeek-V3 are off by up to 1.4e-6 (JAX) and 1.7e-6 (port) of the
# largest entry (the dense LMs': below 1e-6), so two f32 runs may differ
# by their sum; the floor is 4e-6.
COT_ATOL = 4e-6


def _t(tree):
    return {k: _t(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def _tree_close(got, want, rtol, atol):
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], rtol, atol)
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), rtol=rtol,
                                       atol=atol, err_msg=k)


def _gap(probs, k):
    """The least gap between each token's k-th and (k+1)-th largest
    probability."""
    s = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return float((s[..., k - 1] - s[..., k]).min())


def _routing_equal(jprobs, tprobs, k):
    """``top_e`` equal in both packages, each with the margin."""
    jtop = np.asarray(jax.lax.top_k(jnp.asarray(jprobs), k)[1])
    ttop = torch.sort(torch.as_tensor(np.asarray(tprobs)), dim=-1,
                      descending=True, stable=True)[1][..., :k].numpy()
    np.testing.assert_array_equal(ttop, jtop)
    assert _gap(jprobs, k) > MARGIN and _gap(tprobs, k) > MARGIN


@pytest.fixture(scope="module")
def layer():
    """One MoE layer's params and input, from seed 5 (its margin holds)."""
    p = jax.tree.map(np.asarray, jcm.split_tree(
        jmoe.moe_init(jax.random.PRNGKey(5), D, F, E))[0])
    x = np.random.RandomState(5).randn(B, T, D).astype(np.float32)
    return p, x


def test_router_matches_reference(layer):
    p, x = layer
    jp = jax.tree.map(jnp.asarray, p)
    jprobs, jw, je, jlb = jmoe._router(JTapper(), "m", jp, jnp.asarray(x),
                                       E, K)
    tprobs, tw, te, tlb = tmoe._router(Tapper(), "m", _t(p),
                                       torch.from_numpy(x), E, K)
    _routing_equal(jprobs, tprobs.numpy(), K)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_allclose(tlb.numpy(), np.asarray(jlb), rtol=1e-5)


def test_router_breaks_ties_toward_the_lower_expert():
    """Equal probabilities pick the lower expert index, as
    ``jax.lax.top_k`` does."""
    p = {"router": {"w": torch.zeros(4, 6)}}
    x = torch.randn(1, 3, 4)
    _, _, te, _ = tmoe._router(Tapper(), "m", p, x, 6, 3)
    assert te.tolist() == [[[0, 1, 2]] * 3]
    jte = jmoe._router(JTapper(), "m", {"router": {"w": jnp.zeros((4, 6))}},
                       jnp.asarray(x.numpy()), 6, 3)[2]
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_matches_reference(layer, impl):
    """y and lb of each dispatch against the JAX package's (rtol 1e-5,
    atol 1e-6 of the largest entry, as the LM tests hold cotangents), at
    the config's capacity factor (2) and a tight one (0.5: tokens
    dropped, the same ones)."""
    p, x = layer
    for cf in (2.0, 0.5):
        kw = dict(impl=impl, n_experts=E, topk=K, capacity_factor=cf)
        jy, jlb = jmoe.moe_apply(JTapper(), "m", jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), **kw)
        ty, tlb = tmoe.moe_apply(Tapper(), "m", _t(p), torch.from_numpy(x),
                                 **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(jy)).max(),
                                   err_msg=f"{impl} cf={cf}")
        np.testing.assert_allclose(tlb.numpy(), np.asarray(jlb), rtol=1e-5)


def test_moe_gather_and_sort_are_bitwise_equal(layer):
    """The two global-capacity dispatches place every entry in the same
    slot, so their outputs, captures and input gradients are bitwise
    equal; no float scatter-add runs in either (gathers both ways)."""
    p, x = layer
    out = {}
    for impl in ("gather", "sort"):
        tp = Tapper("capture")
        xt = torch.from_numpy(x).requires_grad_(True)
        y, lb = tmoe.moe_apply(tp, "m", _t(p), xt, impl=impl, n_experts=E,
                               topk=K, capacity_factor=0.5)
        gx, = torch.autograd.grad((y.square().sum() + lb.sum()), [xt])
        out[impl] = (y.detach(), gx, tp.captures)
    (ya, ga, ca), (yb, gb, cb) = out["gather"], out["sort"]
    assert torch.equal(ya, yb) and torch.equal(ga, gb)
    for n in ca:
        for k in ca[n]:
            assert torch.equal(ca[n][k], cb[n][k]), (n, k)


def test_slot_rows_backward_is_the_inverse_gather():
    """``_SlotRows``'s backward against autograd's own (scatter-add)
    backward of the same gather, including dropped rows."""
    src = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([2, 5, 0, 4, 5])        # slot -> row, 5 = empty
    inv = torch.tensor([2, 5, 0, 5, 3])        # row -> slot, 5 = dropped
    got = tmoe._SlotRows.apply(src, idx, inv)
    want = torch.cat([src, src.new_zeros(1, 3)])[idx]
    assert torch.equal(got, want)
    w = torch.randn(5, 3, dtype=torch.float64)
    g1, = torch.autograd.grad((got * w).sum(), [src])
    g2, = torch.autograd.grad((want * w).sum(), [src])
    assert torch.equal(g1, g2)


def test_moe_einsum_vs_gather():
    """Port of ``tests/test_attention.py::test_moe_einsum_vs_gather``:
    both dispatch impls compute the same MoE layer output with ample
    capacity (routing identical; only the slot bookkeeping differs)."""
    D_, F_, E_, K_ = 16, 24, 4, 2
    p = tmoe.moe_init(torch.Generator().manual_seed(5), D_, F_, E_)
    p = {k: {kk: vv.value for kk, vv in v.items()} for k, v in p.items()}
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 6, D_)
                         .astype(np.float32))
    kw = dict(n_experts=E_, topk=K_, capacity_factor=8.0)
    y1, lb1 = tmoe.moe_apply(Tapper(), "moe", p, x, impl="einsum", **kw)
    y2, lb2 = tmoe.moe_apply(Tapper(), "moe", p, x, impl="gather", **kw)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lb1.numpy(), lb2.numpy(), rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_lb_per_example_isolation(impl):
    """Port of ``tests/test_attention.py::test_moe_lb_per_example_
    isolation``: changing example j must not change example i's
    load-balance loss."""
    D_, F_, E_, K_ = 8, 12, 4, 2
    p = tmoe.moe_init(torch.Generator().manual_seed(6), D_, F_, E_)
    p = {k: {kk: vv.value for kk, vv in v.items()} for k, v in p.items()}
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 5, D_).astype(np.float32))
    kw = dict(impl=impl, n_experts=E_, topk=K_)
    _, lb = tmoe.moe_apply(Tapper(), "m", p, x, **kw)
    x2 = x.clone()
    x2[2] = torch.from_numpy(rng.randn(5, D_).astype(np.float32))
    _, lb2 = tmoe.moe_apply(Tapper(), "m", p, x2, **kw)
    np.testing.assert_allclose(lb[:2].numpy(), lb2[:2].numpy(), rtol=1e-5)


def _seg_captures(layer, impl="gather"):
    """Both packages' capture pass over one MoE layer under the
    per-example loss Σ_t,d y² + lb (tight capacity: dropped tokens too):
    (JAX metas, caps, dtaps), then the port's."""
    p, x = layer
    kw = dict(impl=impl, n_experts=E, topk=K, capacity_factor=0.5)

    def japply(params, batch, tp):
        y, lb = jmoe.moe_apply(tp, "m", params, batch["x"], **kw)
        return jnp.sum(y ** 2, axis=(1, 2)) + lb

    def tapply(params, batch, tp):
        y, lb = tmoe.moe_apply(tp, "m", params, batch["x"], **kw)
        return y.square().sum(dim=(1, 2)) + lb

    jp, jb = jax.tree.map(jnp.asarray, p), {"x": jnp.asarray(x)}
    _, jmetas, _ = jprobe(japply, jp, jb)
    _, jcaps, jdtaps = jstrat._capture(japply, jp, jb)[:3]
    _, tcaps, tdtaps, tmetas = capture_backward(
        tapply, _t(p), {"x": torch.from_numpy(x)}, with_metas=True)
    return (jmetas, jcaps, jdtaps), (tmetas, tcaps, tdtaps)


def test_dense_segmented_metas_match_reference(layer):
    """The expert taps' metas field by field: kind "dense", segmented,
    scanned = the stacked expert axis, static n_examples; captures x and
    the slot ids (gather: the example of each filled slot, 0 for empty
    ones) equal, and the cotangents."""
    (jm, jc, jd), (tm, tc, td) = _seg_captures(layer)
    assert list(tm) == list(jm)
    for n in ("m/w_gate", "m/w_up", "m/w_down"):
        want = dataclasses.asdict(jm[n])
        got = dataclasses.asdict(tm[n])
        assert got.pop("fn") is None and want.pop("fn") is None
        assert got == want, n
        assert got["segmented"] and got["scanned"] == 1
        assert got["static"] == {"n_examples": B}
        np.testing.assert_array_equal(tc[n]["seg"].numpy(),
                                      np.asarray(jc[n]["seg"]))
        for got_, want_ in ((tc[n]["x"], jc[n]["x"]), (td[n], jd[n])):
            want_ = np.asarray(want_)
            np.testing.assert_allclose(got_.numpy(), want_, rtol=1e-5,
                                       atol=1e-6 * np.abs(want_).max(),
                                       err_msg=n)
    assert not tm["m/router"].segmented


@pytest.mark.parametrize("op,method", [("pe_grad", None),
                                       ("norm_sq", "stream"),
                                       ("norm_sq", "gram"),
                                       ("norm_sq", "auto"),
                                       ("contrib", None)])
@pytest.mark.parametrize("impl", ("einsum", "gather"))
def test_seg_kinds_match_reference(layer, op, method, impl):
    """The segmented kinds on one layer's expert captures (the einsum
    dispatch's per-example slot blocks and the gather dispatch's
    mixed slots), f32: rtol 1e-4 (atol 1e-6 of the largest entry)."""
    (jm, jc, jd), (tm, tc, td) = _seg_captures(layer, impl)
    w = np.random.RandomState(11).rand(B).astype(np.float32)
    for n in ("m/w_gate", "m/w_up", "m/w_down"):
        kw = {} if method is None else {"norm_method": method}
        if op == "contrib":
            kw["weights"] = w
        want = jkinds.apply_kind(op, jm[n], jc[n], jd[n],
                                 **{k: jnp.asarray(v) if k == "weights"
                                    else v for k, v in kw.items()})
        got = tkinds.apply_kind(op, tm[n], tc[n], td[n],
                                **{k: torch.from_numpy(v) if k == "weights"
                                   else v for k, v in kw.items()})
        if op == "norm_sq":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, err_msg=n)
            continue
        for k in want:
            wk = np.asarray(want[k])
            np.testing.assert_allclose(got[k].numpy(), wk, rtol=1e-4,
                                       atol=1e-6 * np.abs(wk).max(),
                                       err_msg=n)


def test_seg_norm_method_matches_reference():
    rng = np.random.RandomState(0)
    for _ in range(200):
        S, Di, Do, Bb, G = (int(rng.choice(v)) for v in (
            (8, 64, 512, 4096), (16, 128, 1024, 7168), (16, 512, 2048),
            (1, 2, 8, 32), (4, 32, 256, 768)))
        assert tcost.seg_norm_method(S, Di, Do, Bb, G) == \
            jcost.seg_norm_method(S, Di, Do, Bb, G)


# ---------------------------------------------------------------------------
# The model lanes: reduced Granite-3.0-1B-A400M and DeepSeek-V3-671B

LMS = {"granite": lambda get: get("granite-moe-1b-a400m").reduced()
       .replace(attn_impl="flash"),
       "deepseek": lambda get: get("deepseek-v3-671b").reduced()}


@pytest.fixture(scope="module", params=list(LMS))
def lm(request):
    jm = JLM(LMS[request.param](jget))
    tm = TLM(LMS[request.param](tget))
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    ds = SyntheticLMDataset(jm.cfg.vocab, MT, n_examples=64)
    batches = [ds.batch(range(i * MB, (i + 1) * MB)) for i in range(3)]
    return request.param, jm, tm, jparams, tparams, batches


def test_configs_match_reference():
    for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b"):
        t, j = tget(arch), jget(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.reduced()) == \
            dataclasses.asdict(j.reduced())
        assert isinstance(build_model(t), TLM)


def _routing_of(params, caps, cfg):
    """Each layer's router probabilities, from the router's captured
    input: (L, B, T, E)."""
    x = np.asarray(caps["blocks/moe/router"]["x"], np.float64)
    w = np.asarray(params["blocks"]["moe"]["router"]["w"], np.float64)
    logits = np.einsum("lbtd,lde->lbte", x, w)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def captured(lm):
    _, jm, tm, jparams, tparams, batches = lm
    jb = jax.tree.map(jnp.asarray, batches[0])
    _, jmetas, _ = jprobe(jm.apply, jparams, jb)
    jl, jcaps, jdtaps = jax.jit(
        lambda p, b: jstrat._capture(jm.apply, p, b)[:3])(jparams, jb)
    before = dict(ops.LAUNCHES)
    tl, tcaps, tdtaps, tmetas = capture_backward(
        tm.apply, tparams, _t(batches[0]), with_metas=True)
    assert ops.LAUNCHES == before          # CPU tensors never launch
    return (jmetas, jcaps, jdtaps, jl), (tmetas, tcaps, tdtaps, tl)


def test_losses_and_cotangents_match_reference(lm, captured):
    """Routing first (every layer's top-k equal, with the margin), then
    the per-example losses (the load-balance term included) and every
    tap's cotangent."""
    _, jm, tm, jparams, tparams, _ = lm
    (jmetas, jcaps, jdtaps, jl), (tmetas, tcaps, tdtaps, tl) = captured
    _routing_equal(_routing_of(jparams, jcaps, jm.cfg),
                   _routing_of(params_to_numpy(tparams), tcaps, tm.cfg),
                   tm.cfg.topk)
    assert list(tmetas) == list(jmetas)
    assert tmetas["blocks/moe/w_up"].segmented
    assert tmetas["blocks/moe/w_up"].scanned == 2
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jmetas:
        want = np.asarray(jdtaps[n])
        assert tdtaps[n].shape == want.shape, n
        np.testing.assert_allclose(tdtaps[n].numpy(), want, rtol=1e-5,
                                   atol=COT_ATOL * np.abs(want).max(),
                                   err_msg=n)
        for k in jcaps[n]:
            if k == "seg":
                np.testing.assert_array_equal(tcaps[n][k].numpy(),
                                              np.asarray(jcaps[n][k]))


def test_group_norms_match_reference(lm, captured):
    """Per-group norms under ghost / bk's realizations (the experts'
    segmented norms included)."""
    jparams, tparams = lm[3], lm[4]
    (jmetas, jcaps, jdtaps, _), (tmetas, tcaps, tdtaps, _) = captured
    jkeys, jn = jstrat.group_norms_from_captures(jparams, jcaps, jdtaps,
                                                 jmetas)
    tkeys, tn = tstrat.group_norms_from_captures(
        tparams, tcaps, tdtaps, tmetas, embed_method="segsum")
    assert tkeys == jkeys and "blocks/moe/w_gate" in tkeys
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)


@pytest.mark.parametrize("strategy,mode", [("ghost", "flat"),
                                           ("auto", "flat"),
                                           ("auto", "stale")])
def test_private_steps_match_reference(lm, strategy, mode):
    """Three σ = 0 AdamW private steps: losses (rtol 1e-4), per-example
    norms (rtol 1e-5) and params (rtol 1e-4, atol 1e-6).  The stale plan
    fuses the reference's layers and never an expert's."""
    _, jm, tm, jparams, tparams, batches = lm
    jdp = jcore.DPConfig(l2_clip=1.0, strategy=strategy, clipping=mode)
    tdp = tcore.DPConfig(l2_clip=1.0, strategy=strategy, clipping=mode)
    b0 = batches[0]
    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, b0, dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, _t(b0), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    if strategy == "auto":
        tplan, jplan = teng.plan(), jeng.plan()
        assert {n: (lp.kind, lp.norm_method, lp.stash, lp.fused)
                for n, lp in tplan.layers.items()} == \
            {n: (lp.kind, lp.norm_method, lp.stash, lp.fused)
             for n, lp in jplan.layers.items()}
        assert tplan.layers["blocks/moe/w_down"].kind == "seg_dense"
        assert not any(lp.fused for lp in tplan.layers.values()
                       if lp.kind == "seg_dense")
        assert any(lp.fused for lp in tplan.layers.values()) == \
            (mode == "stale")
    jp, tp = jparams, tparams
    jopt, topt = jadamw_init(jp), tadamw_init(tp)
    for b in batches:
        jp, jopt, jloss, jaux = jeng.private_step(
            jp, jopt, jax.tree.map(jnp.asarray, b))
        tp, topt, tloss, taux = teng.private_step(tp, topt, _t(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                                   np.asarray(jaux["per_example_norms"]),
                                   rtol=1e-5)
    _tree_close(params_to_numpy(tp), jax.tree.map(np.asarray, jp),
                rtol=1e-4, atol=1e-6)


def _decisions(plan):
    return ({n: (lp.kind, lp.norm_method, lp.stash, lp.fused)
             for n, lp in plan.layers.items()},
            {"/".join(map(str, g.path)): (g.members, g.norm_mode,
                                          g.sum_method)
             for g in plan.groups}, plan.needs_backward, plan.capture_bytes)


_TORCH_DT = {jnp.dtype(jnp.float32): torch.float32,
             jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("width", ("reduced", "full"))
@pytest.mark.parametrize("mode", ("flat", "stale"))
def test_granite_plan_matches_reference(width, mode):
    """``get_plan`` on Granite (reduced at B = 2, T = 16; full width at
    B = 8, T = 1024, bf16, the card lane's shape, by shape only): the
    same per-layer decisions, groups, backward and capture bytes; the
    experts take "seg_dense" with the stream norm; the plan round-trips
    through JSON."""
    cfg = jget("granite-moe-1b-a400m")
    tcfg = tget("granite-moe-1b-a400m")
    Bb, Tt = (MB, MT) if width == "reduced" else (8, 1024)
    if width == "reduced":
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    jm = JLM(cfg.replace(attn_impl="flash"))
    tm = TLM(tcfg.replace(attn_impl="flash"))
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=_TORCH_DT[jnp.dtype(s.dtype)], device="meta"), jp)
    jb = {k: jax.ShapeDtypeStruct((Bb, Tt), jnp.int32)
          for k in ("tokens", "labels")}
    tb = {k: torch.empty((Bb, Tt), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    jplan = jcost.get_plan(jm.apply, jp, jb, clip_mode=mode)
    tplan = tcost.get_plan(tm.apply, tp, tb, clip_mode=mode)
    assert _decisions(tplan) == _decisions(jplan)
    for n in ("blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down"):
        lp = tplan.layers[n]
        assert (lp.kind, lp.norm_method, lp.fused) == \
            ("seg_dense", "stream", False)
        assert lp.norm_flops == jplan.layers[n].norm_flops
        assert lp.contrib_flops == jplan.layers[n].contrib_flops
    back = tcost.ExecPlan.from_json(tplan.to_json())
    assert back == tplan and back.layers["blocks/moe/w_up"].kind == \
        "seg_dense"
    assert back.metas["blocks/moe/w_up"].static == {"n_examples": Bb}


def test_prefill_and_decode_match_reference(lm):
    """Prefill + 4 greedy decode steps (B = 2, 8 prompt tokens):
    logits rtol 1e-5 / atol 1e-6, tokens equal, ``pos`` equal."""
    _, jm, tm, jparams, tparams, _ = lm
    jm = JLM(jm.cfg.replace(attn_impl="xla"))
    tm = TLM(tm.cfg.replace(attn_impl="xla"))
    prompts = np.random.RandomState(4).randint(
        0, jm.cfg.vocab, (2, 8)).astype(np.int32)
    jl, jc = jm.prefill(jparams, jnp.asarray(prompts), max_len=14)
    tl, tc = tm.prefill(tparams, torch.from_numpy(prompts), max_len=14)
    for i in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6, err_msg=f"call {i}")
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert tc["pos"] == int(jc["pos"]) == 8 + i
        if i < 4:
            jl, jc = jm.decode_step(jparams, jc, jtok)
            tl, tc = tm.decode_step(tparams, tc, ttok)
