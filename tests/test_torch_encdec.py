"""The enc-dec family (cross attention, ``models/encdec.py``) in the port
against the JAX package's.

``gqa_apply(x_kv=)`` (cross attention: K and V from a source of another
length, no RoPE, no mask) at T = 6 queries over S = 10 and S = 3 source
positions, through the plain softmax and the flash wrapper (the JAX
package's Pallas flash in interpret mode, the port's plain version):
forward and the VJP of a random cotangent, rtol 2e-4 / atol 2e-5 as
``tests/test_torch_attention.py`` holds attention.  Then reduced
SeamlessM4T-large-v2 (2 encoder + 2 decoder layers, d_model 64, LayerNorm,
GELU; ``attn_impl="flash"``): params from the JAX package's ``init``
through numpy, batches from both packages' ``launch.train.make_batch_fn``
(bitwise equal), per-example losses (rtol 1e-5) and every tap's
cotangent (rtol 1e-5, atol 1e-6 of the largest entry), the per-group
norms (rtol 1e-5), three σ = 0 ``private_step``s of bk and ``auto`` flat
(params rtol 1e-4, atol 1e-6, as ``tests/test_torch_lm.py``),
``remat=True`` bitwise ``remat=False``, and serving: prefill + 4 greedy
decode steps (logits rtol 1e-5 / atol 1e-6, tokens and ``pos`` equal, the
cross K/V cache rtol 1e-5) and decode equal to one training forward
(rtol 2e-4 / atol 2e-5, as ``tests/test_torch_serve.py``).
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
from repro.core.tapper import Tapper as JTapper  # noqa: E402
from repro.core.tapper import probe as jprobe  # noqa: E402
from repro.launch.train import make_batch_fn as jmake_batch_fn  # noqa
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models.encdec import EncDecLM as JED  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.core.tapper import STATS, Tapper, capture_backward  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import make_batch_fn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.encdec import EncDecLM as TED  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import adamw_init as tadamw_init  # noqa: E402
from repro_torch.optim import adamw_update as tadamw_update  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa

ARCH = "seamless-m4t-large-v2"
# make_batch_fn's batch: B examples, SEQ // 2 source frames and as many
# target tokens
B, SEQ = 2, 32
RTOL, ATOL = 2e-4, 2e-5


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


@pytest.mark.parametrize("S", (10, 3))
@pytest.mark.parametrize("impl", ("xla", "flash"))
def test_cross_attention_matches_reference(S, impl):
    """T = 6 queries, 4 heads over 2 KV heads at head_dim 16: forward
    and VJP (x, x_kv and every weight) against the JAX package's."""
    D, H, Hkv, hd, T = 32, 4, 2, 16, 6
    p = jax.tree.map(np.asarray, jcm.split_tree(jattn.gqa_init(
        jax.random.PRNGKey(2), D, H, Hkv, hd))[0])
    rng = np.random.RandomState(2)
    x = rng.randn(2, T, D).astype(np.float32)
    src = rng.randn(2, S, D).astype(np.float32)
    ct = rng.randn(2, T, D).astype(np.float32)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=hd, attn_impl=impl)

    def jf(pp, xx, ss):
        return jattn.gqa_apply(JTapper(), "cross", pp, xx, x_kv=ss, **kw)[0]

    jy, vjp = jax.vjp(jf, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                      jnp.asarray(src))
    jgp, jgx, jgs = vjp(jnp.asarray(ct))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(src).requires_grad_(True)
    ty, none = tattn.gqa_apply(Tapper(), "cross", tp, tx, x_kv=ts, **kw)
    assert none is None
    leaves = [tp[n]["w"] for n in ("wq", "wk", "wv", "wo")]
    grads = torch.autograd.grad(ty, leaves + [tx, ts], torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    for g, n in zip(grads, ("wq", "wk", "wv", "wo")):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[n]["w"]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    np.testing.assert_allclose(grads[4].numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(grads[5].numpy(), np.asarray(jgs), rtol=RTOL,
                               atol=ATOL)


def test_cross_attention_falls_back_to_projection_taps():
    """Under ``dp_attn`` a cross call site is tapped per projection (the
    block-level tap rebuilds from x alone), as in the reference; wk and
    wv capture the source."""
    D, H, hd = 16, 2, 8
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                     jcm.split_tree(jattn.gqa_init(jax.random.PRNGKey(3), D,
                                                   H, H, hd))[0])
    x, src = torch.randn(2, 4, D), torch.randn(2, 7, D)
    tp = Tapper("capture")
    tattn.gqa_apply(tp, "cross", p, x, x_kv=src, n_heads=H, n_kv=H,
                    head_dim=hd, dp_attn=True)
    assert sorted(tp.metas) == ["cross/wk", "cross/wo", "cross/wq",
                                "cross/wv"]
    assert torch.equal(tp.captures["cross/wk"]["x"], src)
    assert torch.equal(tp.captures["cross/wq"]["x"], x)


def test_config_and_batches_match_reference():
    """The config field for field, and ``make_batch_fn``'s enc-dec batches
    (numpy ``RandomState(step)`` frames, half-length tokens) bitwise."""
    t, j = tget(ARCH), jget(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert isinstance(build_model(t), TED)
    for cfg, jcfg in ((t, j), (t.reduced(), j.reduced())):
        for step in (0, 3):
            got = make_batch_fn(cfg, 4, 64)(step)
            want = jmake_batch_fn(jcfg, 4, 64)(step)
            assert sorted(got) == sorted(want) == ["labels", "src_frames",
                                                   "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["src_frames"].shape == (4, 32, cfg.d_model)


@pytest.fixture(scope="module")
def ed():
    jm = JED(jget(ARCH).reduced().replace(attn_impl="flash"))
    tm = TED(tget(ARCH).reduced().replace(attn_impl="flash"))
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    fn = jmake_batch_fn(jm.cfg, B, SEQ)
    batches = [fn(s) for s in range(3)]
    return jm, tm, jparams, tparams, batches


def test_params_tree_matches_reference(ed):
    _, tm, jparams, _, _ = ed
    like = tm.init(0, device="cpu")[0]
    assert sorted(like) == ["dec", "enc", "final_norm", "head", "tok_emb"]
    assert sorted(like["dec"]) == ["cross", "ln1", "ln2", "ln3", "mlp",
                                   "self"]
    assert sorted(like["enc"]) == ["attn", "ln1", "ln2", "mlp"]
    assert like["dec"]["cross"]["wk"]["w"].shape == (2, 64, 32)


@pytest.fixture(scope="module")
def captured(ed):
    jm, tm, jparams, tparams, batches = ed
    jb = jax.tree.map(jnp.asarray, batches[0])
    _, jmetas, _ = jprobe(jm.apply, jparams, jb)
    jl, jcaps, jdtaps = jax.jit(
        lambda p, b: jstrat._capture(jm.apply, p, b)[:3])(jparams, jb)
    before = dict(ops.LAUNCHES)
    tl, tcaps, tdtaps, tmetas = capture_backward(
        tm.apply, tparams, _t(batches[0]), with_metas=True)
    assert ops.LAUNCHES == before          # CPU tensors never launch
    return (jmetas, jcaps, jdtaps, jl), (tmetas, tcaps, tdtaps, tl)


def test_losses_and_cotangents_match_reference(captured):
    (jmetas, _, jdtaps, jl), (tmetas, _, tdtaps, tl) = captured
    assert list(tmetas) == list(jmetas)
    assert "dec/cross/wk" in tmetas and "enc/attn/wq" in tmetas
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jmetas:
        want = np.asarray(jdtaps[n])
        assert tdtaps[n].shape == want.shape, n
        np.testing.assert_allclose(tdtaps[n].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)
    # cross K/V project the source: (L, B, S, D) captures and cotangents
    assert tdtaps["dec/cross/wk"].shape == (2, B, SEQ // 2, 32)


def test_group_norms_match_reference(ed, captured):
    jparams, tparams = ed[2], ed[3]
    (jmetas, jcaps, jdtaps, _), (tmetas, tcaps, tdtaps, _) = captured
    jkeys, jn = jstrat.group_norms_from_captures(jparams, jcaps, jdtaps,
                                                 jmetas)
    tkeys, tn = tstrat.group_norms_from_captures(
        tparams, tcaps, tdtaps, tmetas, embed_method="segsum")
    assert tkeys == jkeys and "dec/cross/wv" in tkeys
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)


@pytest.mark.parametrize("strategy", ("bk", "auto"))
def test_private_steps_match_reference(ed, strategy):
    """Three σ = 0 AdamW private steps (flat): losses rtol 1e-4, norms
    rtol 1e-5, params rtol 1e-4 / atol 1e-6; the plans' per-layer
    decisions equal."""
    jm, tm, jparams, tparams, batches = ed
    jdp = jcore.DPConfig(l2_clip=1.0, strategy=strategy)
    tdp = tcore.DPConfig(l2_clip=1.0, strategy=strategy)
    b0 = batches[0]
    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, b0, dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, _t(b0), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    if strategy == "auto":
        assert {n: (lp.norm_method, lp.stash)
                for n, lp in teng.plan().layers.items()} == \
            {n: (lp.norm_method, lp.stash)
             for n, lp in jeng.plan().layers.items()}
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


def test_remat_is_bitwise(ed):
    """The decoder under ``remat=True`` (the config's setting at full
    width): captures, cotangents and bk's clipped sum equal
    ``remat=False``'s bitwise; each decoder layer is recomputed once."""
    _, tm, _, tparams, batches = ed
    rm = TED(tm.cfg.replace(remat=True))
    b = _t(batches[1])
    STATS.reset()
    got = capture_backward(rm.apply, tparams, b)
    assert STATS.recomputes == tm.cfg.n_dec_layers
    want = capture_backward(tm.apply, tparams, b)
    assert torch.equal(got[0], want[0])
    for n in want[2]:
        assert torch.equal(got[2][n], want[2][n]), n
    g = tcore.clipped_grad_sum(rm.apply, tparams, b, l2_clip=0.05,
                               strategy="bk")
    w = tcore.clipped_grad_sum(tm.apply, tparams, b, l2_clip=0.05,
                               strategy="bk")
    assert torch.equal(g[2], w[2])
    _tree_close(params_to_numpy(g[1]), params_to_numpy(w[1]), rtol=0, atol=0)


def test_prefill_and_decode_match_reference(ed):
    """Prefill (the source encoded once, each decoder layer's cross K/V
    cached) + 4 greedy decode steps against the JAX package's: logits
    rtol 1e-5 / atol 1e-6, tokens and ``pos`` equal, cross K/V rtol 1e-5;
    then decode equals one training forward over the same tokens."""
    jm, tm, jparams, tparams, _ = ed
    rng = np.random.RandomState(4)
    src = rng.randn(2, 5, 64).astype(np.float32)
    prompts = rng.randint(0, jm.cfg.vocab, (2, 8)).astype(np.int32)
    jl, jc = jm.prefill(jparams, jnp.asarray(src), jnp.asarray(prompts),
                        max_len=14)
    tl, tc = tm.prefill(tparams, torch.from_numpy(src),
                        torch.from_numpy(prompts), max_len=14)
    for k in ("cross_k", "cross_v"):
        want = np.asarray(jc[k])
        assert tc[k].shape == want.shape == (2, 2, 5, 2, 16)
        np.testing.assert_allclose(tc[k].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    toks, outs = [], []
    for i in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6, err_msg=f"call {i}")
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert tc["pos"] == int(jc["pos"]) == 8 + i
        outs.append(tl.numpy())
        toks.append(ttok)
        if i < 4:
            jl, jc = jm.decode_step(jparams, jc, jtok)
            tl, tc = tm.decode_step(tparams, tc, ttok)
    tokens = torch.cat([torch.from_numpy(prompts).long(),
                        torch.stack(toks[:-1], 1)], 1)
    with torch.no_grad():
        full = tm.logits(tparams, torch.from_numpy(src), tokens).numpy()
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, full[:, 7 + i], rtol=2e-4, atol=2e-5,
                                   err_msg=f"call {i}")


def test_serve_generate_batch_encdec():
    """``launch.serve.generate_batch`` serves the enc-dec family (zero
    source frames of the prompt's length, as the JAX package's) and the
    CLI runs reduced Seamless, Granite and DeepSeek-V3 on the CPU."""
    tm = TED(tget(ARCH).reduced())
    params, _ = tm.init(0, device="cpu")
    prompts = torch.zeros((2, 5), dtype=torch.int64)
    out = serve.generate_batch(tm, params, prompts, max_len=9, gen=4)
    assert tuple(out.shape) == (2, 4)
    for arch in (ARCH, "granite-moe-1b-a400m", "deepseek-v3-671b"):
        serve.main(["--arch", arch, "--device", "cpu", "--n-requests", "2",
                    "--batch", "2", "--gen", "3", "--prompt-len", "4"])


def test_train_cli_runs_the_new_archs(capsys):
    """``launch.train --arch`` takes the MoE and enc-dec ids (reduced, on
    the CPU): two ``auto`` steps, finite losses in the JSON summary."""
    import json
    from repro_torch.launch import train
    for arch in (ARCH, "granite-moe-1b-a400m"):
        train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--strategy", "auto"])
        last = capsys.readouterr().out.strip().splitlines()[-1]
        summary = json.loads(last)["train_summary"]
        assert summary["arch"] == arch and summary["steps"] == 2
        assert all(np.isfinite(summary["losses_last_segment"]))
