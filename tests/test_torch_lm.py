"""The LM slice as a whole: the port's DP-SGD step on Llama-3.2-1B
against the JAX package's, through the entry points.

``get_config("llama3.2-1b").reduced().replace(attn_impl="flash")`` in
both packages: params from the JAX package's ``init`` pass through
numpy into the port (``weights.params_from_numpy``, checked leaf for
leaf: stacked ``blocks``, no ``head`` with tied embeddings); batches come
from the shared ``SyntheticLMDataset``.  The JAX package's flash kernel
runs in interpret mode, the port's flash wrapper its plain version.
Per-example losses and every tap's cotangent agree to rtol 1e-5, the
per-group norms under bk (the tied embedding/head group included) to
rtol 1e-5, and three σ = 0 ``private_step``s of bk and of ``auto`` flat
leave the same params (rtol 1e-4 / atol 1e-6; AdamW eps 1e-6, lr 1e-4 in
both, as the CNN lanes run it); so do bk and ``auto`` under per_layer
(uniform and auto budgets) and stale clipping, with the stale plan
fusing the reference's layers.  ``remat=True`` equals ``remat=False``
bitwise and the reference's ``remat=True``.  Reduced MLA (with
per-projection taps and with the block-level ``"attn"`` tap) gives the
reference's losses, cotangents and group norms.
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
from repro.core import strategies as jstrat  # noqa: E402
from repro.core.tapper import probe as jprobe  # noqa: E402
from repro.data import SyntheticLMDataset  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models.lm import TransformerLM as JLM  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.core.tapper import STATS, capture_backward  # noqa: E402
from repro_torch.data import SyntheticLMDataset as TSyntheticLM  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.core.tapper import Tapper  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import adamw_init as tadamw_init  # noqa: E402
from repro_torch.optim import adamw_update as tadamw_update  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa

B, T = 2, 16


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


@pytest.fixture(scope="module")
def lm():
    jm = JLM(jget("llama3.2-1b").reduced().replace(attn_impl="flash"))
    tm = TLM(tget("llama3.2-1b").reduced().replace(attn_impl="flash"))
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    ds = SyntheticLMDataset(jm.cfg.vocab, T, n_examples=64)
    batches = [ds.batch(range(i * B, (i + 1) * B)) for i in range(3)]
    return jm, tm, jparams, tparams, batches


def test_config_and_data_match_reference():
    t, j = tget("llama3.2-1b"), jget("llama3.2-1b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.torch_dtype == torch.bfloat16 and t.hd == 64
    assert t.padded_vocab == j.padded_vocab == 128256
    a = TSyntheticLM(512, T, n_examples=8).batch(range(4))
    b = SyntheticLMDataset(512, T, n_examples=8).batch(range(4))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


def test_common_blocks_match_reference():
    """Norms (rmsnorm, layernorm, the non-parametric layernorm), RoPE,
    the masked per-example cross entropy and both MLPs, f32."""
    from repro.core.tapper import Tapper as JTapper
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 16).astype(np.float32)
    g = {"g": rng.rand(16).astype(np.float32) + 0.5,
         "b": rng.randn(16).astype(np.float32)}
    for kind, p in (("rmsnorm", {"g": g["g"]}), ("layernorm", g),
                    ("layernorm_np", None)):
        want = jcm.apply_norm(JTapper(), "n", None if p is None else
                              jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x), kind)
        got = tcm.apply_norm(Tapper(), "n", None if p is None else _t(p),
                             torch.from_numpy(x), kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=kind)
    q = rng.randn(2, 5, 3, 8).astype(np.float32)
    pos = np.broadcast_to(np.arange(5)[None], (2, 5))
    jc, js = jcm.rope_angles(jnp.asarray(pos), 8, 5e5)
    tc, ts = tcm.rope_angles(torch.from_numpy(pos.copy()), 8, 5e5)
    np.testing.assert_allclose(
        tcm.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(jcm.apply_rope(jnp.asarray(q), jc, js)), rtol=1e-5,
        atol=1e-6)
    logits = rng.randn(2, 5, 40).astype(np.float32)
    labels = rng.randint(0, 30, (2, 5)).astype(np.int32)
    mask = (rng.rand(2, 5) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jcm.per_example_xent(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m),
                                    vocab_valid=30)
        got = tcm.per_example_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m),
                                   vocab_valid=30)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for kind in ("swiglu", "gelu"):
        p = jax.tree.map(np.asarray, jax.tree.map(
            lambda a: a.value, jmlp.mlp_init(jax.random.PRNGKey(0), 16, 24,
                                             kind, bias=True),
            is_leaf=jcm.is_pm))
        want = jmlp.mlp_apply(JTapper(), "mlp", jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x), kind)
        got = tmlp.mlp_apply(Tapper(), "mlp", _t(p), torch.from_numpy(x),
                             kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=kind)


def test_int64_tokens_give_the_same_step(lm):
    """The token batch may be int64 or int32."""
    _, tm, _, tparams, batches = lm
    cfg = tcore.DPConfig(l2_clip=1.0, strategy="bk")
    b32 = _t(batches[2])
    b64 = {k: v.long() for k, v in b32.items()}
    l32, g32, _ = tcore.dp_gradient(tm.apply, tparams, b32, cfg=cfg)
    l64, g64, _ = tcore.dp_gradient(tm.apply, tparams, b64, cfg=cfg)
    assert float(l32) == float(l64)
    _tree_close(params_to_numpy(g64), params_to_numpy(g32), rtol=0, atol=0)


@pytest.fixture(scope="module")
def captured(lm):
    """Both packages' capture pass on the first batch: (JAX metas,
    captures, cotangents, losses), then the port's."""
    jm, tm, jparams, tparams, batches = lm
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
    (jmetas, _, jdtaps, jl), (tmetas, _, tdtaps, tl) = captured
    assert list(tmetas) == list(jmetas)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jmetas:
        want = np.asarray(jdtaps[n])
        assert tdtaps[n].shape == want.shape, n
        np.testing.assert_allclose(tdtaps[n].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)
    assert tdtaps["blocks/attn/wq"].shape[0] == lm[1].cfg.n_layers


def test_bk_group_norms_match_reference(lm, captured):
    """Per-group norms under bk's realizations, the tied embedding/head
    group's cross term included."""
    jparams, tparams = lm[2], lm[3]
    (jmetas, jcaps, jdtaps, _), (tmetas, tcaps, tdtaps, _) = captured
    jkeys, jn = jstrat.group_norms_from_captures(jparams, jcaps, jdtaps,
                                                 jmetas)
    tkeys, tn = tstrat.group_norms_from_captures(
        tparams, tcaps, tdtaps, tmetas, embed_method="segsum")
    assert tkeys == jkeys and "tok_emb" in tkeys
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)


@pytest.mark.parametrize("strategy,embed", [("bk", "auto"),
                                            ("auto", "auto"),
                                            ("auto", "segsum")],
                         ids=["bk", "auto", "auto_tied"])
def test_private_steps_match_reference(lm, strategy, embed):
    """σ = 0 clipped sums, then three AdamW private steps.  ``auto_tied``
    plans the tied group with the cross term (segsum on the table)
    instead of materializing its small per-example grads."""
    jm, tm, jparams, tparams, batches = lm
    norm = dict(embed=embed)
    jdp = jcore.DPConfig(l2_clip=1.0, strategy=strategy,
                         norm=jcore.NormCfg(**norm))
    tdp = tcore.DPConfig(l2_clip=1.0, strategy=strategy,
                         norm=tcore.NormCfg(**norm))
    b0 = batches[0]
    jl, jsum, jn = jax.jit(functools.partial(
        jcore.clipped_grad_sum, jm.apply, l2_clip=1.0, strategy=strategy,
        embed_method=embed))(jparams, jax.tree.map(jnp.asarray, b0))
    tloss, tgrad, taux = tcore.dp_gradient(tm.apply, tparams, _t(b0),
                                           cfg=tdp)
    np.testing.assert_allclose(float(tloss), float(np.mean(jl)), rtol=1e-5)
    np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                               np.sqrt(np.asarray(jn) + 1e-12), rtol=1e-5)
    _tree_close(params_to_numpy(tgrad),
                jax.tree.map(lambda g: np.asarray(g) / B, jsum),
                rtol=1e-4, atol=1e-7)

    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, b0, dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, _t(b0), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    if strategy == "auto":
        tied = next(g for g in teng.plan().groups if g.path == ("tok_emb",))
        assert tied.norm_mode == ("tied" if embed == "segsum"
                                  else "group_pe")
    jp, tp = jparams, tparams
    jopt, topt = jadamw_init(jp), tadamw_init(tp)
    for b in batches:
        jp, jopt, jloss, _ = jeng.private_step(
            jp, jopt, jax.tree.map(jnp.asarray, b))
        tp, topt, tloss, _ = teng.private_step(tp, topt, _t(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    _tree_close(params_to_numpy(tp), jax.tree.map(np.asarray, jp),
                rtol=1e-4, atol=1e-6)


# The non-flat clipping lanes: (strategy, clipping) by test id.  The
# first four cases are the refusals this slice lifted.
CLIP_MODES = {"per_layer": "per_layer", "stale": "stale",
              "per_layer_auto": dict(mode="per_layer", budgets="auto",
                                     ema=0.5)}


@pytest.mark.parametrize("strategy,mode", [("bk", "per_layer"),
                                           ("bk", "stale"),
                                           ("auto", "per_layer"),
                                           ("auto", "stale"),
                                           ("bk", "per_layer_auto"),
                                           ("auto", "per_layer_auto")])
def test_non_flat_clipping_raises(lm, strategy, mode):
    """per_layer (uniform and auto budgets) and stale clipping over the
    scanned and shared layers are served: three σ = 0 ``private_step``s
    equal the JAX package's (losses, per-example norms, clip fractions,
    budgets and per-layer norms rtol 1e-5; params rtol 1e-5 / atol 1e-7),
    and the stale plan fuses the layers the reference's plan fuses.  The
    clip bound (0.05) is below every example's norm, so every step
    clips."""
    jm, tm, jparams, tparams, batches = lm
    spec = CLIP_MODES[mode]

    def policy(pkg):
        return spec if isinstance(spec, str) else pkg.ClipPolicy(**spec)

    jdp = jcore.DPConfig(l2_clip=0.05, strategy=strategy,
                         clipping=policy(jcore))
    tdp = tcore.DPConfig(l2_clip=0.05, strategy=strategy,
                         clipping=policy(tcore))
    b0 = batches[0]
    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, b0, dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, _t(b0), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    if strategy == "auto":
        fused = {n for n, lp in teng.plan().layers.items() if lp.fused}
        assert fused == {n for n, lp in jeng.plan().layers.items()
                         if lp.fused}
        assert bool(fused) == (mode == "stale")
    keys = ("per_example_norms", "clip_fraction", "clip_fraction_lagged",
            "per_layer_norms", "per_layer_clip_fraction", "clip_budgets")
    jp, tp = jparams, tparams
    jopt, topt = jadamw_init(jp), tadamw_init(tp)
    for b in batches:
        jp, jopt, jloss, jaux = jeng.private_step(
            jp, jopt, jax.tree.map(jnp.asarray, b))
        tp, topt, tloss, taux = teng.private_step(tp, topt, _t(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert {k for k in keys if k in taux} == {k for k in keys
                                                  if k in jaux}
        for k in keys:
            if k in jaux:
                np.testing.assert_allclose(taux[k].numpy(),
                                           np.asarray(jaux[k]), rtol=1e-5,
                                           err_msg=k)
    assert float(taux["clip_fraction"]) == 1.0
    _tree_close(params_to_numpy(tp), jax.tree.map(np.asarray, jp),
                rtol=1e-5, atol=1e-7)


def test_remat_is_refused_by_name(lm):
    """``remat=True`` is served (per-layer ``torch.utils.checkpoint``):
    the captures, cotangents and clipped sums equal ``remat=False``'s
    bitwise on the CPU, and the backward recomputes each layer once
    (``STATS.recomputes``) while the capture pass still counts one
    forward and one backward."""
    _, tm, _, tparams, batches = lm
    rm = TLM(tm.cfg.replace(remat=True))
    b = _t(batches[1])
    STATS.reset()
    got = capture_backward(rm.apply, tparams, b)
    assert STATS.recomputes == tm.cfg.n_layers
    assert STATS.snapshot() == {"forwards": 1, "backwards": 1, "probes": 0}
    want = capture_backward(tm.apply, tparams, b)
    assert torch.equal(got[0], want[0])
    for n in want[2]:
        assert torch.equal(got[2][n], want[2][n]), n
        for k in want[1][n]:
            assert torch.equal(got[1][n][k], want[1][n][k]), n
    for strategy in ("bk", "auto", "ghost"):
        g = tcore.clipped_grad_sum(rm.apply, tparams, b, l2_clip=0.05,
                                   strategy=strategy)
        w = tcore.clipped_grad_sum(tm.apply, tparams, b, l2_clip=0.05,
                                   strategy=strategy)
        assert torch.equal(g[2], w[2]), strategy
        _tree_close(params_to_numpy(g[1]), params_to_numpy(w[1]), rtol=0,
                    atol=0)


def test_remat_matches_reference_remat(lm):
    """The port's ``remat=True`` against the JAX package's (each scanned
    block under ``jax.checkpoint``): losses, cotangents and bk's clipped
    sum and norms, rtol 1e-5."""
    jm, tm, jparams, tparams, batches = lm
    jr = JLM(jm.cfg.replace(remat=True, attn_impl="xla"))
    tr = TLM(tm.cfg.replace(remat=True, attn_impl="xla"))
    b = batches[2]
    jl, _, jdtaps = jax.jit(
        lambda p, bb: jstrat._capture(jr.apply, p, bb)[:3])(
        jparams, jax.tree.map(jnp.asarray, b))
    tl, _, tdtaps = capture_backward(tr.apply, tparams, _t(b))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jdtaps:
        want = np.asarray(jdtaps[n])
        np.testing.assert_allclose(tdtaps[n].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)
    _, jsum, jn = jax.jit(functools.partial(
        jcore.clipped_grad_sum, jr.apply, l2_clip=0.05, strategy="bk"))(
        jparams, jax.tree.map(jnp.asarray, b))
    _, tsum, tn = tcore.clipped_grad_sum(tr.apply, tparams, _t(b),
                                         l2_clip=0.05, strategy="bk")
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    _tree_close(params_to_numpy(tsum), jax.tree.map(np.asarray, jsum),
                rtol=1e-5, atol=1e-7)


def test_params_from_numpy_checks_the_lm_tree(lm):
    jm, tm, jparams, _, _ = lm
    like = tm.init(0, device="cpu")[0]
    assert "head" not in like and like["blocks"]["mlp"]["w_up"]["w"] \
        .shape == (2, 64, 128)
    pnp = jax.tree.map(np.asarray, jparams)
    extra = dict(pnp, head={"w": np.zeros((64, 512), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(extra, like=like, device="cpu")
    short = dict(pnp, blocks=dict(pnp["blocks"], ln1={
        "g": pnp["blocks"]["ln1"]["g"][:1]}))
    with pytest.raises(ValueError, match="blocks/ln1/g"):
        params_from_numpy(short, like=like, device="cpu")
    # bf16 leaves come over from JAX in numpy's extension dtype
    bf = params_from_numpy({"g": np.asarray(jnp.ones(3, jnp.bfloat16))},
                           device="cpu")
    assert bf["g"].dtype == torch.bfloat16


def test_unserved_models_raise():
    """Every LM config of the JAX package builds: the SSM xLSTM-125M and
    the hybrid Zamba2-2.7B too (``tests/test_torch_ssm.py`` and
    ``tests/test_torch_hybrid.py`` hold them against the JAX package);
    only an unknown family or arch raises.  The MoE and enc-dec configs
    build (Granite-3.0-1B-A400M, DeepSeek-V3-671B with MLA + MoE,
    SeamlessM4T-large-v2; ``tests/test_torch_moe.py`` and
    ``tests/test_torch_encdec.py`` hold them against the JAX package).
    MLA builds (``test_mla_matches_reference``), and MLA with
    ``attn_impl="flash"`` raises by name: the flash kernels take one head
    dim for q, k and v."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.deepseek_v3_671b import CONFIG as DSV3
    from repro_torch.models.attention import FlashUnsupportedError
    from repro_torch.models.encdec import EncDecLM
    for arch in ARCH_IDS:
        assert build_model(tget(arch)).cfg.name == arch
    for arch in ("xlstm-125m", "zamba2-2.7b"):
        assert isinstance(build_model(tget(arch)), TLM)
    cfg = tget("llama3.2-1b").reduced()
    with pytest.raises(ValueError, match="family 'rnn'"):
        build_model(cfg.replace(family="rnn"))
    with pytest.raises(ValueError, match="LM family 'rnn'"):
        TLM(cfg.replace(family="rnn"))
    with pytest.raises(KeyError, match="unknown arch"):
        tget("mamba-3b")
    for good in (cfg.replace(family="moe", n_experts=4, topk=2), DSV3,
                 tget("granite-moe-1b-a400m"), tget("deepseek-v3-671b")):
        assert isinstance(build_model(good), TLM)
    assert isinstance(build_model(tget("seamless-m4t-large-v2")), EncDecLM)
    mla = tget("llama3.2-1b").replace(mla=True).reduced()
    assert isinstance(build_model(mla), TLM)
    assert isinstance(build_model(tget("chameleon-34b").reduced()), TLM)
    fm = build_model(mla.replace(attn_impl="flash"))
    params, _ = fm.init(0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(FlashUnsupportedError, match="MLA"):
        fm.apply(params, {"tokens": tokens, "labels": tokens}, Tapper())


@pytest.mark.parametrize("dp_attn", (False, True), ids=("taps", "dp_attn"))
def test_mla_matches_reference(dp_attn):
    """Reduced Llama-3.2-1B with MLA (``replace(mla=True).reduced()``:
    q / kv ranks 32, nope 16, rope 8, v 16; f32, the plain softmax) in
    both packages: per-example losses and every tap's cotangent to rtol
    1e-5, the per-group norms under bk's realizations to rtol 1e-5, with
    per-projection taps or the block-level ``"attn"`` tap.  DeepSeek-V3's
    config and the reduced MLA configs are the JAX package's field for
    field."""
    from repro.configs.deepseek_v3_671b import CONFIG as JDSV3
    from repro_torch.configs.deepseek_v3_671b import CONFIG as DSV3
    for t, j in ((DSV3, JDSV3), (DSV3.reduced(), JDSV3.reduced()),
                 (tget("llama3.2-1b").replace(mla=True).reduced(),
                  jget("llama3.2-1b").replace(mla=True).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jm = JLM(jget("llama3.2-1b").replace(mla=True, dp_attn=dp_attn)
             .reduced())
    tm = TLM(tget("llama3.2-1b").replace(mla=True, dp_attn=dp_attn)
             .reduced())
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    assert sorted(tparams["blocks"]["attn"]) == [
        "kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    b = SyntheticLMDataset(jm.cfg.vocab, T, n_examples=8).batch(range(B))
    jb = jax.tree.map(jnp.asarray, b)
    _, jmetas, _ = jprobe(jm.apply, jparams, jb)
    jl, jcaps, jdtaps = jax.jit(
        lambda p, bb: jstrat._capture(jm.apply, p, bb)[:3])(jparams, jb)
    tl, tcaps, tdtaps, tmetas = capture_backward(tm.apply, tparams, _t(b),
                                                 with_metas=True)
    assert list(tmetas) == list(jmetas)
    assert ("blocks/attn" in tmetas) == dp_attn
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jmetas:
        want = np.asarray(jdtaps[n])
        np.testing.assert_allclose(tdtaps[n].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)
    jkeys, jn = jstrat.group_norms_from_captures(jparams, jcaps, jdtaps,
                                                 jmetas)
    tkeys, tn = tstrat.group_norms_from_captures(
        tparams, tcaps, tdtaps, tmetas, embed_method="segsum")
    assert tkeys == jkeys
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
