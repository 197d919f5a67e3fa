"""The static DP verifier (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), its mutation suite, and the kernel ops it
sees as graph nodes.

* **Clean lanes.**  Reduced AlexNet (flat, per_layer, stale, and stale
  with the fused kernel planned), reduced Llama-3.2-1B with flash (flat,
  stale) and with ``dp_attn`` (flat): both packages verify their own step
  clean, with the same warning codes, and the census of their graphs
  agrees — noise draws, ``group_norm`` markers by group and method,
  realization methods by layer path, fused layers, clip modes.  The JAX
  params are loaded into the port; the batch is the CLIs' numpy batch.
  The port's clean lanes also take no conservative fallback.
* **Mutants** (the false-negative guard), each flagged by its finding
  code on the port's own terms: the dropped clip (under ``auto``,
  ``naive`` and two microbatches, which also verify clean), the sum
  before the clip under ``naive``, key reuse (tagged
  draws from a fresh generator per leaf with the step's seed), double
  noise, reduce before clip, bf16 norms, ``raise_on_error``, the default
  generator, and ``gram_norm_fused`` fed weights of ones.  The JAX
  package's own key-reuse mutant reports ``noise_missing`` (ROADMAP.md,
  reference caveats), so it is no oracle here.
* **No side effects.**  A ``private_step`` after ``verify()`` gives
  params bitwise equal to one without it; ``STATS``, ``LAUNCHES`` and
  the clip state are unchanged.
* **The ops.**  ``torch.library.opcheck`` passes for the eight kernel
  ops and the marker on the CPU at small shapes; each fake
  implementation's shapes and dtypes equal the plain version's; a
  vmapped flash attention (the ``multi`` path) equals the loop over
  examples.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.analysis.verifier as jverifier  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import ClipPolicy as JClip  # noqa: E402
from repro.core import DPConfig as JDP  # noqa: E402
from repro.core import PrivacyEngine as JEngine  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
import repro_torch.core.clipping as tclipping  # noqa: E402
import repro_torch.core.engine as tengine  # noqa: E402
import repro_torch.core.kinds as tkinds  # noqa: E402
import repro_torch.core.strategies as tstrat  # noqa: E402
from repro_torch.analysis import DPVerificationError  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import ClipPolicy, DPConfig, PrivacyEngine  # noqa
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core.tapper import STATS, Tapper  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.train import make_batch_fn  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths, tree_map  # noqa
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_slice import _t  # noqa: E402

B, SEQ = 8, 64
FUSED = {"conv*": "ghost", "fc0": "gram"}
LANES = {
    "alexnet-flat": ("alexnet", "flat", {}, ()),
    "alexnet-per_layer": ("alexnet", "per_layer", {}, ()),
    "alexnet-stale": ("alexnet", "stale", {}, ()),
    "alexnet-stale-fused": ("alexnet", "stale", {}, FUSED),
    "llama-flash-flat": ("llama3.2-1b", "flat", {"attn_impl": "flash"}, ()),
    "llama-flash-stale": ("llama3.2-1b", "stale", {"attn_impl": "flash"},
                          ()),
    "llama-dp_attn-flat": ("llama3.2-1b", "flat",
                           {"attn_impl": "flash", "dp_attn": True}, ()),
}
_JAX_PARAMS = {}


@pytest.fixture(autouse=True)
def _fresh_plans():
    # Mutants change what the traced step looks like; a cached plan from
    # an earlier trace would mask or fabricate mismatches.
    tcost.clear_plan_cache()
    jcost.clear_plan_cache()
    yield
    tcost.clear_plan_cache()
    jcost.clear_plan_cache()


def _models(arch, cfg_kw):
    jcfg = jget(arch).reduced().replace(**cfg_kw)
    tcfg = tget(arch).reduced().replace(**cfg_kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    if jcfg not in _JAX_PARAMS:
        _JAX_PARAMS[jcfg] = jax.jit(lambda k: jm.init(k)[0])(
            jax.random.PRNGKey(0))
    jparams = _JAX_PARAMS[jcfg]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    return jm, tm, jparams, tparams, make_batch_fn(tcfg, B, SEQ)(0)


def _port_engine(lane="alexnet-flat", noise=0.8, run_seed=0,
                 strategy="auto", microbatches=1):
    arch, mode, cfg_kw, overrides = LANES[lane]
    _, tm, _, tparams, nb = _models(arch, cfg_kw)
    dp = DPConfig(l2_clip=1.0, noise_multiplier=noise, strategy=strategy,
                  microbatches=microbatches, overrides=dict(overrides),
                  clipping=ClipPolicy(mode=mode))
    eng = PrivacyEngine(tm.apply, tparams, _t(nb), dp=dp, optimizer="adamw",
                        lr=1e-3, run_seed=run_seed, device="cpu")
    return eng, tparams, _t(nb)


def _reference(lane, monkeypatch):
    """The JAX package's report on the lane, and the census of the graph
    its verifier read."""
    arch, mode, cfg_kw, overrides = LANES[lane]
    jm, _, jparams, _, nb = _models(arch, cfg_kw)
    dp = JDP(l2_clip=1.0, noise_multiplier=0.8, strategy="auto",
             overrides=dict(overrides), clipping=JClip(mode=mode))
    eng = JEngine(jm.apply, jparams, jax.tree.map(jnp.asarray, nb), dp=dp,
                  optimizer="adamw", lr=1e-3, run_seed=0)
    graphs = []
    flatten = jverifier.graphlib.flatten

    def capture(closed):
        graphs.append(flatten(closed))
        return graphs[-1]

    monkeypatch.setattr(jverifier.graphlib, "flatten", capture)
    report = eng.verify()
    monkeypatch.setattr(jverifier.graphlib, "flatten", flatten)
    census = {"noise": 0, "clip_coef": [],
              "group_norm": collections.Counter(), "realization": {},
              "fused_impl": set()}
    for node, _ in graphs[-1].markers():
        p = node.params
        kind = p.get("kind")
        if kind == "noise":
            census["noise"] += 1
        elif kind == "clip_coef":
            census["clip_coef"].append(p.get("mode"))
        elif kind == "group_norm":
            census["group_norm"][f"{p.get('group')}|{p.get('method')}"] += 1
        elif kind == "realization":
            census["realization"].setdefault(p.get("path"), set()).add(
                p.get("method"))
        elif kind == "fused_impl":
            census["fused_impl"].add(p.get("path"))
    census["clip_coef"] = sorted(census["clip_coef"])
    census["group_norm"] = dict(census["group_norm"])
    census["realization"] = {k: sorted(v) for k, v in
                             sorted(census["realization"].items())}
    census["fused_impl"] = sorted(census["fused_impl"])
    return report, census


def _codes(report):
    return sorted({f.code for f in report.errors})


# ---------------------------------------------------------------------------
# Clean lanes, against the reference


@pytest.mark.parametrize("lane", list(LANES))
def test_clean_lane_matches_reference(lane, monkeypatch):
    jrep, jcensus = _reference(lane, monkeypatch)
    trep = _port_engine(lane)[0].verify()
    assert jrep.ok, jrep.summary()
    assert trep.ok, trep.summary()
    assert sorted(f.code for f in trep.warnings) \
        == sorted(f.code for f in jrep.warnings)
    assert not trep.has("taint_approximation"), trep.summary()
    got = {k: trep.census[k] for k in jcensus}
    assert got == jcensus
    assert got["noise"] == len(leaf_paths(_port_engine(lane)[1]))
    for section in ("taint", "clip", "noise", "sharding", "plan"):
        assert section in trep.checked
    if lane == "alexnet-stale-fused":
        assert trep.census["kernels"] == {"gram_norm_fused": 3}


def test_verify_report_surface():
    eng = _port_engine()[0]
    report = eng.verify()
    assert "PASS" in report.summary()
    assert report.errors == [] and report.warnings == []
    assert "no mesh" in eng.verify(coll_bytes_warn=2 ** 20).checked[
        "sharding"]
    eng.verify(raise_on_error=True)


# ---------------------------------------------------------------------------
# Mutants: classic DP bugs, each flagged by its code


def _verify_mutated(monkeypatch, patches, lane="alexnet-flat", **kw):
    for obj, attr, value in patches:
        monkeypatch.setattr(obj, attr, value)
    return _port_engine(lane, **kw)[0].verify()


# The step's other loops: ``naive``'s batch-1 passes, stacked, and a
# microbatch loop of two microbatches.
PATHS = [{"strategy": "naive"}, {"microbatches": 2}]


@pytest.mark.parametrize("path", PATHS, ids=["naive", "microbatches2"])
def test_other_paths_verify_clean(path):
    report = _port_engine(**path)[0].verify()
    assert report.errors == [] and report.warnings == [], report.summary()


def _no_clip(norms_sq, l2_clip, eps=1e-12, *, mode="flat"):
    return torch.ones_like(norms_sq)


@pytest.mark.parametrize("path", [{}] + PATHS,
                         ids=["auto", "naive", "microbatches2"])
def test_mutant_dropped_clip(monkeypatch, path):
    codes = _codes(_verify_mutated(
        monkeypatch, [(tstrat, "clip_coefficients", _no_clip)], **path))
    assert "clip_missing" in codes, codes
    assert "unclipped_batch_reduction" in codes, codes


def test_mutant_key_reuse(monkeypatch):
    """A fresh generator a leaf, each seeded with the step's seed: every
    leaf draws the same stream.  The draws carry the noise marker, so
    the count is right and only the stream check can see it."""
    def reuse(grad_sum, generator, noise_multiplier, l2_clip):
        sigma = noise_multiplier * l2_clip
        out = grad_sum
        for path in leaf_paths(grad_sum):
            g = get_subtree(grad_sum, path)
            fresh = torch.Generator(device=g.device)
            fresh.manual_seed(generator.initial_seed())
            noise = tclipping.tag(
                sigma * torch.randn(g.shape, generator=fresh,
                                    dtype=torch.float32, device=g.device),
                kind="noise", sigma=float(sigma),
                noise_multiplier=float(noise_multiplier),
                l2_clip=float(l2_clip))
            out = tclipping.set_subtree(out, path, g + noise)
        return out

    codes = _codes(_verify_mutated(
        monkeypatch, [(tclipping, "add_noise", reuse)]))
    assert codes == ["key_reuse"], codes


def test_mutant_double_noise(monkeypatch):
    orig = tclipping.add_noise

    def double(grad_sum, generator, noise_multiplier, l2_clip):
        g1 = orig(grad_sum, generator, noise_multiplier, l2_clip)
        return orig(g1, generator, noise_multiplier, l2_clip)

    codes = _codes(_verify_mutated(
        monkeypatch, [(tclipping, "add_noise", double)]))
    assert "noise_duplicated" in codes, codes


def test_mutant_default_generator(monkeypatch):
    orig = tclipping.add_noise

    def default_gen(grad_sum, generator, noise_multiplier, l2_clip):
        return orig(grad_sum, None, noise_multiplier, l2_clip)

    codes = _codes(_verify_mutated(
        monkeypatch, [(tclipping, "add_noise", default_gen)]))
    assert codes == ["key_constant"], codes


def test_mutant_reduce_before_clip(monkeypatch):
    """The textbook bug: clip the *mean* gradient by its global norm
    instead of clipping each example's gradient before summing."""
    def mean_then_scale(apply_fn, params, batch, *, cfg, key=None,
                        denom=None, plan=None, clip_state=None):
        paths = leaf_paths(params)
        p = {k: v for k, v in params.items()}
        leaves = [get_subtree(p, q).detach().requires_grad_(True)
                  for q in paths]
        for q, leaf in zip(paths, leaves):
            p = tclipping.set_subtree(p, q, leaf)
        with torch.enable_grad():
            loss = apply_fn(p, batch, Tapper()).mean()
            grads = torch.autograd.grad(loss, leaves)
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(cfg.l2_clip / (gnorm + 1e-12), max=1.0)
        grad = {}
        for q, g in zip(paths, grads):
            grad = tclipping.set_subtree(grad, q, g * scale)
        grad = tclipping.add_noise(grad, key, cfg.noise_multiplier,
                                   cfg.l2_clip)
        return loss.detach(), grad, {"clip_fraction": torch.zeros(())}

    codes = _codes(_verify_mutated(
        monkeypatch, [(tengine, "dp_gradient", mean_then_scale)]))
    assert "unclipped_batch_reduction" in codes, codes
    assert "clip_missing" in codes, codes


def test_mutant_naive_reduce_before_clip(monkeypatch):
    """``naive``: each example's gradient comes from its own batch-1
    pass and the passes are stacked.  Summing the stack before the clip
    (then scaling by the mean coefficient) is a reduction over the
    examples: the stack's axis carries them."""
    def sum_then_scale(pe, coef):
        return tree_map(lambda g: g.float().sum(0) * coef.mean(), pe)

    codes = _codes(_verify_mutated(
        monkeypatch, [(tstrat, "_weighted_sum", sum_then_scale)],
        strategy="naive"))
    assert codes == ["unclipped_batch_reduction"], codes


def test_mutant_bf16_norms(monkeypatch):
    orig = tkinds.dense_norm_sq

    def bf16_norms(meta, cap, dy, method="auto"):
        return orig(meta, cap, dy, method=method).to(torch.bfloat16)

    codes = _codes(_verify_mutated(
        monkeypatch, [(tkinds, "dense_norm_sq", bf16_norms)]))
    assert "norm_low_precision" in codes, codes


def test_mutant_raises_with_raise_on_error(monkeypatch):
    monkeypatch.setattr(tstrat, "clip_coefficients", _no_clip)
    with pytest.raises(DPVerificationError, match="clip"):
        _port_engine()[0].verify(raise_on_error=True)


def test_mutant_fused_kernel_unweighted(monkeypatch):
    """``gram_norm_fused`` fed weights of ones instead of the clip
    coefficients: its contribution sums unclipped gradients over the
    batch.  Only the fused op's own handler can see it."""
    orig = ops.gram_norm_fused

    def ones(x, dy, w, *, has_bias=False):
        return orig(x, dy, torch.ones_like(w), has_bias=has_bias)

    codes = _codes(_verify_mutated(
        monkeypatch, [(ops, "gram_norm_fused", ones)],
        lane="alexnet-stale-fused"))
    assert codes == ["unclipped_batch_reduction"], codes


# ---------------------------------------------------------------------------
# No side effects


def test_verify_leaves_the_engine_as_it_found_it():
    """Stale mode after its bootstrap step: the clip state is live.  A
    step after verify() equals a step without it, bitwise."""
    runs = []
    for verify in (False, True):
        eng, params, batch = _port_engine("alexnet-stale-fused")
        opt = adamw_init(params)
        params, opt, _, _ = eng.private_step(params, opt, batch, step=0)
        if verify:
            state = eng.clip_state_dict()
            stats = (STATS.snapshot(), STATS.fused, STATS.recomputes)
            launches = dict(ops.LAUNCHES)
            plan = eng._plan
            assert eng.verify().ok
            assert (STATS.snapshot(), STATS.fused, STATS.recomputes) \
                == stats
            assert ops.LAUNCHES == launches
            assert eng._plan is plan
            after = eng.clip_state_dict()
            assert sorted(after) == sorted(state)
            for k in state:
                np.testing.assert_array_equal(after[k], state[k])
        runs.append(eng.private_step(params, opt, batch, step=1)[0])
    for q in leaf_paths(runs[0]):
        assert torch.equal(get_subtree(runs[0], q), get_subtree(runs[1], q))


# ---------------------------------------------------------------------------
# The kernel ops


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    q, k, v = r(2, 8, 4, 16), r(2, 8, 2, 16), r(2, 8, 2, 16)
    o, lse = ref.flash_fwd_ref(q, k, v, causal=True)
    do = r(2, 8, 4, 16)
    delta = ref.flash_delta(o, do)
    return {
        "gram_norm": ((r(2, 5, 3), r(2, 5, 4), True),
                      lambda x, dy, b: ref.gram_norm_ref(x, dy, has_bias=b)),
        "gram_norm_fused": (
            (r(2, 5, 3), r(2, 5, 4), torch.rand(2, generator=g), True),
            lambda x, dy, w, b: ref.gram_norm_fused_ref(x, dy, w,
                                                        has_bias=b)),
        "gram_norm_tokmask": (
            (torch.randint(0, 4, (2, 5), generator=g), r(2, 5, 3)),
            ref.gram_norm_tokmask_ref),
        "pe_conv_grad_1d": ((r(2, 3, 8), r(2, 4, 6), 3),
                            ref.pe_conv_grad_1d_ref),
        "pe_conv_grad_2d": ((r(2, 3, 6, 6), r(2, 4, 4, 4), 3, 3, -1),
                            lambda x, dy, kh, kw, _: ref.pe_conv_grad_2d_ref(
                                x, dy, kh, kw)),
        "flash_fwd": ((q, k, v, True),
                      lambda q, k, v, c: ref.flash_fwd_ref(q, k, v,
                                                           causal=c)),
        "flash_dq": ((q, k, v, do, lse, delta, True),
                     lambda *a: ref.flash_dq_ref(*a[:6], causal=a[6])),
        "flash_dkv": ((q, k, v, do, lse, delta, True),
                      lambda *a: ref.flash_dkv_ref(*a[:6], causal=a[6])),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_kernel_op_opcheck_and_fake_shapes(name):
    """One op a kernel: opcheck (schema, fake impl against the real one,
    autograd registration, AOT dispatch) on the CPU, and the fake
    implementation's shapes and dtypes equal to the plain version's."""
    args, plain = _op_cases()[name]
    op = getattr(torch.ops.repro_torch, name)
    torch.library.opcheck(op, args)
    from torch._subclasses.fake_tensor import FakeTensorMode
    fm = FakeTensorMode()
    fake_args = [fm.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with fm:
        fake = op(*fake_args)
    want = plain(*args)
    fake = fake if isinstance(fake, tuple) else (fake,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in fake] \
        == [(tuple(t.shape), t.dtype) for t in want]
    before = dict(ops.LAUNCHES)
    got = op(*args)
    assert ops.LAUNCHES == before   # the CPU takes the plain version
    for a, b in zip(got if isinstance(got, tuple) else (got,), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_marker_op_opcheck_and_identity():
    x = torch.randn(3, 4)
    torch.library.opcheck(torch.ops.repro_torch.dp_tag, (x, '{"kind": "x"}'))
    assert tclipping.tag(x, kind="noise") is x   # no graph recorded
    with pytest.raises(TypeError):
        tclipping.tag(x, kind="noise", sigma=[1.0])
    with pytest.raises(ValueError):
        tclipping.tag(x, sigma=1.0)


def test_vmapped_flash_equals_the_loop():
    """The ``multi`` strategy's vmap(grad) over a model that calls the
    flash ops: the ops' vmap rules fold the vmapped axis into the
    example axis, and the gradients equal a loop over examples."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(3, 8, 4, 16, generator=g),
               torch.randn(3, 8, 2, 16, generator=g),
               torch.randn(3, 8, 2, 16, generator=g))

    def f(q1, k1, v1):
        return ops.flash_attention(q1[None], k1[None], v1[None]).square() \
            .sum()

    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, v)
    for b in range(3):
        want = torch.func.grad(f, argnums=(0, 1, 2))(q[b], k[b], v[b])
        for a, w in zip(got, want):
            torch.testing.assert_close(a[b], w, rtol=1e-5, atol=1e-6)
