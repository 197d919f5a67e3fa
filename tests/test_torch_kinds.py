"""The port's tapper and layer kinds against ``repro.core``.

A toy CNN's captures come from both packages' capture backward on the
same params and batch (compared first), then the *same* numpy captures
feed every kind operation of both packages: ``pe_grad``, ``norm_sq`` for
every method, and ``contrib``.  The port's ``"pallas"`` methods run the
kernels' plain versions on the CPU and are held against the JAX
package's jnp realizations of the same function (``gram`` / ``ghost`` /
``fgc``).  Synthetic captures add a strided, a dilated and a grouped
conv, and a dense layer with a sequence long enough to take the chunked
Gram.  The LM kinds come from a reduced Llama-3.2-1B's captures (JAX
params, the port's capture checked first, with its stacked ``blocks/*``
taps): the embedding gather (segsum / gram / pe), the scales, scanned
dense layers (one stacked layer at a time, fused under stale clipping
too), the shared transposed head, shared scanned layers (folded into the
sequence axis, or materialized), and the tied embedding/head cross term.
The other dense LM configs (OLMo-1B, GLM-4-9B, StableLM-12B,
Chameleon-34B) equal the JAX package's field by field, and reduced, their
losses, cotangents and group norms.  f32, rtol 1e-5 (sums in another
order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kinds as jkinds  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.core.tapper import LayerMeta as JMeta  # noqa: E402
from repro.models.cnn import CNN as JCNN  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.cnn import toy_cnn_config as jtoy  # noqa: E402
from repro.models.lm import TransformerLM as JLM  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import kinds as tkinds  # noqa: E402
from repro_torch.core.tapper import LayerMeta as TMeta  # noqa: E402
from repro_torch.core.tapper import capture_backward  # noqa: E402
from repro_torch.models.cnn import CNN as TCNN  # noqa: E402
from repro_torch.models.cnn import toy_cnn_config as ttoy  # noqa: E402
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _close(got, want, rtol=1e-5):
    got = [np.asarray(g) for g in jax.tree.leaves(
        jax.tree.map(lambda a: a.numpy() if hasattr(a, "numpy") else a, got))]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30))


@pytest.fixture(scope="module")
def toy():
    """(JAX metas, numpy captures, numpy cotangents, numpy params) of a
    toy CNN, after checking that the port captures the same."""
    jcfg = jtoy(2, 2.0, c0=4, img=16)
    jm = JCNN(jcfg)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    pnp = _np(jparams)
    rng = np.random.RandomState(0)
    batch = {"img": rng.randn(3, 3, 16, 16).astype(np.float32),
             "label": rng.randint(0, 10, 3).astype(np.int32)}
    jl, jcaps, jdtaps, jmetas = jstrat._capture(
        jm.apply, jparams, jax.tree.map(jnp.asarray, batch))
    tm = TCNN(ttoy(2, 2.0, c0=4, img=16))
    tparams = params_from_numpy(pnp, like=tm.init(0, device="cpu")[0],
                                device="cpu")
    tl, tcaps, tdtaps, tmetas = capture_backward(
        tm.apply, tparams, _t(batch), with_metas=True)
    assert list(tmetas) == list(jmetas)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jmetas:
        assert tmetas[n].kind == jmetas[n].kind
        assert tmetas[n].static == jmetas[n].static
        np.testing.assert_allclose(tcaps[n]["x"].numpy(),
                                   np.asarray(jcaps[n]["x"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tdtaps[n].numpy(), np.asarray(jdtaps[n]),
                                   rtol=1e-5, atol=1e-7)
    return jmetas, _np(jcaps), _np(jdtaps), pnp


def _synthetic_conv(stride, dilation, padding, groups, seed):
    rng = np.random.RandomState(seed)
    B, C, D, K, H = 3, 4, 6, 3, 11
    x = rng.randn(B, C, H, H).astype(np.float32)
    w = rng.randn(D, C // groups, K, K).astype(np.float32)
    from repro.models.convops import conv_forward
    y = conv_forward(jnp.asarray(x), jnp.asarray(w), stride=stride,
                     dilation=dilation, padding=padding, groups=groups)
    dy = rng.randn(*y.shape).astype(np.float32)
    fields = dict(kind="conv", path=("sconv",), bias_key="b",
                  static={"stride": stride, "dilation": dilation,
                          "padding": padding, "groups": groups,
                          "kernel_shape": w.shape})
    return fields, {"x": x}, dy, {"w": w, "b": np.zeros(D, np.float32)}


def _synthetic_dense_seq():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 1100, 6).astype(np.float32)
    dy = rng.randn(2, 1100, 5).astype(np.float32)
    fields = dict(kind="dense", path=("sfc",), bias_key="b")
    return fields, {"x": x}, dy, {"w": np.zeros((6, 5), np.float32),
                                  "b": np.zeros(5, np.float32)}


def _layer(toy, name):
    if name == "conv_strided":
        return _synthetic_conv(2, 1, 1, 1, 1)
    if name == "conv_dilated":
        return _synthetic_conv(1, 2, 2, 1, 2)
    if name == "conv_grouped":
        return _synthetic_conv(2, 1, 1, 2, 3)
    if name == "dense_seq":
        return _synthetic_dense_seq()
    jmetas, caps, dtaps, pnp = toy
    m = jmetas[name]
    fields = dict(kind=m.kind, path=m.path, bias_key=m.bias_key,
                  static=dict(m.static))
    return fields, caps[name], dtaps[name], pnp[m.path[0]]


CONV_LAYERS = ["conv0", "conv1", "conv_strided", "conv_dilated",
               "conv_grouped"]
DENSE_LAYERS = ["fc0", "dense_seq"]
# (op, port kwargs, JAX kwargs): "pallas" in the port is held against the
# JAX package's jnp realization of the same function.
CONV_OPS = [
    ("pe_grad", {"conv_impl": "fgc"}, {"conv_impl": "fgc"}),
    ("pe_grad", {"conv_impl": "pallas"}, {"conv_impl": "fgc"}),
    ("norm_sq", {"conv_norm": "pe"}, {"conv_norm": "pe"}),
    ("norm_sq", {"conv_norm": "ghost"}, {"conv_norm": "ghost"}),
    ("norm_sq", {"conv_norm": "pallas"}, {"conv_norm": "ghost"}),
    ("norm_sq", {"conv_norm": "auto"}, {"conv_norm": "auto"}),
    ("contrib", {}, {}),
]
DENSE_OPS = [
    ("pe_grad", {}, {}),
    ("norm_sq", {"norm_method": "rank1"}, {"norm_method": "rank1"}),
    ("norm_sq", {"norm_method": "stream"}, {"norm_method": "stream"}),
    ("norm_sq", {"norm_method": "gram"}, {"norm_method": "gram"}),
    ("norm_sq", {"norm_method": "pallas"}, {"norm_method": "gram"}),
    ("norm_sq", {"norm_method": "auto"}, {"norm_method": "auto"}),
    ("contrib", {}, {}),
]
CASES = ([(n, *op) for n in CONV_LAYERS for op in CONV_OPS]
         + [(n, *op) for n in DENSE_LAYERS for op in DENSE_OPS])


@pytest.mark.parametrize("name,op,tkw,jkw", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'-'.join(c[2].values())}"
                              for c in CASES])
def test_kind_parity(toy, name, op, tkw, jkw):
    fields, cap, dy, psub = _layer(toy, name)
    B = dy.shape[0]
    w = np.random.RandomState(11).rand(B).astype(np.float32)
    weights = {"weights": w} if op == "contrib" else {}
    want = jkinds.apply_kind(
        op, JMeta(**fields), jax.tree.map(jnp.asarray, cap), jnp.asarray(dy),
        params_sub=jax.tree.map(jnp.asarray, psub),
        **{k: jnp.asarray(v) for k, v in weights.items()}, **jkw)
    got = tkinds.apply_kind(
        op, TMeta(**fields), _t(cap), _t(dy), params_sub=_t(psub),
        **{k: _t(v) for k, v in weights.items()}, **tkw)
    _close(got, _np(want))


def test_unported_kinds_raise(toy):
    """Every kind of the JAX package is ported.  The local_vjp kind on
    fc0 written as a pure layer ``fn(p, x) = x @ w + b`` gives the
    reference's local_vjp norms and fc0's own dense norms (rtol 1e-5);
    ``tests/test_torch_ssm.py`` and ``tests/test_torch_hybrid.py`` hold
    it on the SSM scans.  Segmented (MoE) layers:
    fc0's captures read as one group of B slots, each slot its own
    example, give fc0's own per-example norms (``tests/test_torch_moe.py``
    holds the kinds against the JAX package's).  The attn kind is ported
    (``tests/test_torch_attn_kind.py``); an attn meta without its block's
    rebuild closure (one read back from a plan's JSON) is refused by
    name."""
    fields, cap, dy, psub = _layer(toy, "fc0")
    vjp_fields = dict(fields, kind="local_vjp")
    want = jkinds.apply_kind(
        "norm_sq", JMeta(**dict(vjp_fields, fn=lambda p, x: x @ p["w"]
                                + p["b"])),
        {"inputs": (jnp.asarray(cap["x"]),)}, jnp.asarray(dy),
        params_sub=jax.tree.map(jnp.asarray, psub))
    got = tkinds.apply_kind(
        "norm_sq", TMeta(**dict(vjp_fields, fn=lambda p, x: x @ p["w"]
                                + p["b"])),
        {"inputs": (_t(cap)["x"],)}, _t(dy), params_sub=_t(psub))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    dense = tkinds.apply_kind("norm_sq", TMeta(**fields), _t(cap), _t(dy),
                              params_sub=_t(psub))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5)
    x, g = _t(cap)["x"], _t(dy)
    B = g.shape[0]
    seg_meta = TMeta(**dict(fields, segmented=True, scanned=1,
                            static={"n_examples": B}))
    seg_cap = {"x": x.reshape(1, B, -1),
               "seg": torch.arange(B, dtype=torch.int32)[None]}
    want = tkinds.apply_kind("norm_sq", TMeta(**fields), _t(cap), g,
                             params_sub=_t(psub), norm_method="stream")
    for method in ("stream", "gram"):
        got = tkinds.apply_kind("norm_sq", seg_meta, seg_cap,
                                g.reshape(1, B, -1), norm_method=method)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="rebuild closure"):
        tkinds.apply_kind("norm_sq", TMeta(**dict(fields, kind="attn")),
                          _t(cap), _t(dy), params_sub=_t(psub))


# ---------------------------------------------------------------------------
# LM kinds


@pytest.fixture(scope="module")
def lm():
    """(JAX metas, numpy captures, cotangents, params) of a reduced
    Llama-3.2-1B (B = 3, T = 12), after checking that the port captures
    the same (stacked blocks included)."""
    jm = JLM(jget("llama3.2-1b").reduced().replace(attn_impl="xla"))
    tm = TLM(tget("llama3.2-1b").reduced().replace(attn_impl="xla"))
    jparams, _ = jm.init(jax.random.PRNGKey(1))
    pnp = _np(jparams)
    rng = np.random.RandomState(1)
    # repeated ids, so segsum and the Gram's masks have runs to merge
    batch = {k: rng.randint(0, 40, (3, 12)).astype(np.int32)
             for k in ("tokens", "labels")}
    jl, jcaps, jdtaps, jmetas = jstrat._capture(
        jm.apply, jparams, jax.tree.map(jnp.asarray, batch))
    tparams = params_from_numpy(pnp, like=tm.init(0, device="cpu")[0],
                                device="cpu")
    tl, tcaps, tdtaps, tmetas = capture_backward(
        tm.apply, tparams, _t(batch), with_metas=True)
    assert list(tmetas) == list(jmetas)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n, m in jmetas.items():
        t = tmetas[n]
        assert (t.kind, t.path, t.param_key, t.bias_key, t.w_transposed,
                t.scanned, t.shared) == (m.kind, m.path, m.param_key,
                                         m.bias_key, m.w_transposed,
                                         m.scanned, m.shared)
        _close(tcaps[n], _np(jcaps[n]))
        _close(tdtaps[n], np.asarray(jdtaps[n]))
    return jmetas, _np(jcaps), _np(jdtaps), pnp


def _lm_layer(lm, name):
    jmetas, caps, dtaps, pnp = lm
    m = jmetas[name]
    fields = dict(kind=m.kind, path=m.path, param_key=m.param_key,
                  bias_key=m.bias_key, w_transposed=m.w_transposed,
                  scanned=m.scanned, shared=m.shared)
    sub = pnp
    for k in m.path:
        sub = sub[k]
    return fields, caps[name], dtaps[name], sub


def _fold_case(lm, kind):
    """A shared parameter applied at every stacked layer: the reduced
    model's stacked captures under a shared (absolute-path) meta."""
    jmetas, caps, dtaps, pnp = lm
    src = {"dense": "blocks/mlp/w_up", "scale": "blocks/ln1",
           "embed": "tok_emb"}[kind]
    fields, cap, dy, sub = _lm_layer(lm, src)
    if kind == "embed":       # stack the gather twice
        cap = {"ids": np.stack([cap["ids"], cap["ids"][::-1]])}
        dy = np.stack([dy, dy[:, ::-1] * 0.5])
        return dict(fields, scanned=1, shared=True), cap, dy, sub
    sub = {k: v[0] for k, v in sub.items()}
    return dict(fields, shared=True), cap, dy, sub


LM_LAYERS = {
    "tok_emb": [("pe_grad", {}), ("norm_sq", {"embed_method": "segsum"}),
                ("norm_sq", {"embed_method": "gram"}),
                ("norm_sq", {"embed_method": "pe"}),
                ("norm_sq", {"embed_method": "auto"}), ("contrib", {})],
    "blocks/ln1": [("pe_grad", {}), ("norm_sq", {}), ("contrib", {})],
    "final_norm": [("pe_grad", {}), ("norm_sq", {}), ("contrib", {})],
    "blocks/attn/wk": [("pe_grad", {}), ("norm_sq", {"norm_method": "gram"}),
                       ("norm_sq", {"norm_method": "stream"}),
                       ("norm_sq", {"norm_method": "auto"}),
                       ("contrib", {})],
    "blocks/mlp/w_down": [("norm_sq", {"norm_method": "gram"}),
                          ("contrib", {})],
    "~tok_emb": [("pe_grad", {}), ("norm_sq", {"norm_method": "gram"}),
                 ("norm_sq", {"norm_method": "stream"}), ("contrib", {})],
    "fold:dense": [("pe_grad", {}), ("norm_sq", {"norm_method": "gram"}),
                   ("contrib", {})],
    "fold:scale": [("norm_sq", {}), ("contrib", {})],
    "fold:embed": [("pe_grad", {}), ("norm_sq", {}), ("contrib", {})],
}
LM_CASES = [(n, op, kw) for n, ops_ in LM_LAYERS.items() for op, kw in ops_]


@pytest.mark.parametrize("name,op,kw", LM_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'-'.join(c[2].values())}"
                              for c in LM_CASES])
def test_lm_kind_parity(lm, name, op, kw):
    if name.startswith("fold:"):
        fields, cap, dy, psub = _fold_case(lm, name[5:])
    else:
        fields, cap, dy, psub = _lm_layer(lm, name)
    B = dy.shape[fields["scanned"]]
    weights = ({"weights": np.random.RandomState(5).rand(B)
                .astype(np.float32)} if op == "contrib" else {})
    want = jkinds.apply_kind(
        op, JMeta(**fields), jax.tree.map(jnp.asarray, cap), jnp.asarray(dy),
        params_sub=jax.tree.map(jnp.asarray, psub),
        **{k: jnp.asarray(v) for k, v in weights.items()}, **kw)
    got = tkinds.apply_kind(
        op, TMeta(**fields), _t(cap), _t(dy), params_sub=_t(psub),
        **{k: _t(v) for k, v in weights.items()}, **kw)
    _close(got, _np(want))


def test_tied_cross_term(lm):
    _, caps, dtaps, _ = lm
    want = jkinds.tied_embed_head_cross(
        jax.tree.map(jnp.asarray, caps["tok_emb"]),
        jnp.asarray(dtaps["tok_emb"]),
        jax.tree.map(jnp.asarray, caps["~tok_emb"]),
        jnp.asarray(dtaps["~tok_emb"]))
    got = tkinds.tied_embed_head_cross(_t(caps["tok_emb"]),
                                       _t(dtaps["tok_emb"]),
                                       _t(caps["~tok_emb"]),
                                       _t(dtaps["~tok_emb"]))
    _close(got, np.asarray(want))


def test_scanned_fused_contrib_refused(lm):
    """Stale clipping's fused pass over a scanned layer is served: the
    port takes the stack one layer at a time through ``gram_norm_fused``
    (its plain version here) and equals the JAX package's ``lax.map``
    over the same captures, and the unfused pair; a shared scanned layer
    folds its stack into the sequence axis first."""
    for name in ("blocks/mlp/w_up", "fold:dense"):
        if name.startswith("fold:"):
            fields, cap, dy, psub = _fold_case(lm, "dense")
        else:
            fields, cap, dy, psub = _lm_layer(lm, name)
        w = np.random.RandomState(6).rand(dy.shape[1]).astype(np.float32)
        jn, jc = jkinds.apply_norm_contrib(
            JMeta(**fields), jax.tree.map(jnp.asarray, cap), jnp.asarray(dy),
            weights=jnp.asarray(w), params_sub=jax.tree.map(jnp.asarray,
                                                             psub))
        n, c = tkinds.apply_norm_contrib(TMeta(**fields), _t(cap), _t(dy),
                                         weights=_t(w), params_sub=_t(psub))
        _close((n, c), _np((jn, jc)))
        n_u, c_u = tkinds.apply_norm_contrib(
            TMeta(**fields), _t(cap), _t(dy), weights=_t(w),
            params_sub=_t(psub), fused=False, norm_method="gram")
        _close((n, c), (n_u.numpy(), {k: v.numpy() for k, v in c_u.items()}))
        assert n.shape == (dy.shape[fields["scanned"]],)
        assert c["w"].shape == psub["w"].shape


# ---------------------------------------------------------------------------
# The other dense LM configs


NEW_LMS = ("olmo-1b", "glm4-9b", "stablelm-12b", "chameleon-34b")


@pytest.mark.parametrize("arch", NEW_LMS)
def test_lm_configs_match_reference(arch):
    """Each config and its ``.reduced()`` form equal the JAX package's
    field by field, and build the port's model."""
    import dataclasses
    t, j = tget(arch), jget(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert isinstance(TLM(t.reduced()), TLM)


@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-12b",
                                  "chameleon-34b"])
def test_lm_config_step_parity(arch):
    """Reduced OLMo-1B (non-parametric LayerNorm, tied), StableLM-12B
    (LayerNorm with bias) and Chameleon-34B (family ``vlm``, qk-norm):
    per-example losses, every tap's cotangent and bk's per-group norms
    equal the JAX package's (rtol 1e-5), on JAX params and the same
    batch."""
    jm, tm = JLM(jget(arch).reduced()), TLM(tget(arch).reduced())
    jparams, _ = jm.init(jax.random.PRNGKey(2))
    pnp = _np(jparams)
    tparams = params_from_numpy(pnp, like=tm.init(0, device="cpu")[0],
                                device="cpu")
    rng = np.random.RandomState(2)
    batch = {k: rng.randint(0, 60, (3, 10)).astype(np.int32)
             for k in ("tokens", "labels")}
    jl, jcaps, jdtaps, jmetas = jstrat._capture(
        jm.apply, jparams, jax.tree.map(jnp.asarray, batch))
    tl, tcaps, tdtaps, tmetas = capture_backward(
        tm.apply, tparams, _t(batch), with_metas=True)
    assert list(tmetas) == list(jmetas)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jmetas:
        _close(tdtaps[n], np.asarray(jdtaps[n]))
    jkeys, jn = jstrat.group_norms_from_captures(jparams, jcaps, jdtaps,
                                                 jmetas)
    from repro_torch.core import strategies as tstrat
    tkeys, tn = tstrat.group_norms_from_captures(tparams, tcaps, tdtaps,
                                                 tmetas)
    assert tkeys == jkeys
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    norms = {"olmo-1b": "layernorm_np", "stablelm-12b": "layernorm",
             "chameleon-34b": "layernorm"}[arch]
    assert tm.cfg.norm == norms
    assert ("blocks/ln1" in tmetas) == (norms == "layernorm")
    assert ("blocks/attn/qn" in tmetas) == (arch == "chameleon-34b")
