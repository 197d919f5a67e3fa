"""The port's attention against the JAX package's.

``ops.flash_attention`` runs its autograd Function on the CPU too, where
the forward, dq and dk/dv wrappers take their plain versions
(``kernels/ref.py``: the full-softmax forward, and the backward that
recomputes P from the saved lse), the versions the kernels are held
against on the card.  It is held against the JAX package's Pallas flash
kernel run in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_attention.py`` run it: the forward and the vjp of a random
cotangent, over their sweeps (GQA rep 1 / 2 / 4, causal and full,
bq != bk, query padding) and the ``FlashShapeError`` raises; the lse
rows are held against the JAX package's.  ``attend`` is compared for the
xla, chunked and flash
implementations, ``gqa_apply`` through the KV cache and under the
block-level ``dp_attn`` tap, and MLA's ``mla_apply`` (train path, and
decode through the latent cache with and without the absorbed decode).
Tolerance rtol 2e-4 / atol 2e-5 (f32; sums in another order).  The CUDA kernels run only on the card:
``tests/test_torch_flash_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.tapper import Tapper as JTapper  # noqa: E402
from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.core.tapper import Tapper  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


def _qkv(seed, B, T, H, hd, S=None, Hkv=None):
    rng = np.random.RandomState(seed)
    S = T if S is None else S
    Hkv = H if Hkv is None else Hkv
    return (rng.randn(B, T, H, hd).astype(np.float32),
            rng.randn(B, S, Hkv, hd).astype(np.float32),
            rng.randn(B, S, Hkv, hd).astype(np.float32),
            rng.randn(B, T, H, hd).astype(np.float32))


def _jax_fwd_vjp(fn, q, k, v, w):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _torch_fwd_vjp(fn, q, k, v, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(w))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# (B, T, S, H, Hkv, hd, causal, bq, bk): tests/test_kernels.py's sweep,
# then tests/test_attention.py's GQA, rectangular-block and padding cases.
FLASH_CASES = [
    (2, 64, 64, 4, 2, 16, True, 32, 32),
    (1, 128, 128, 2, 2, 8, True, 64, 32),
    (2, 32, 32, 4, 1, 16, False, 16, 16),
    (2, 64, 64, 4, 4, 8, True, 16, 16),
    (2, 64, 64, 4, 2, 8, False, 16, 16),
    (2, 64, 64, 4, 1, 8, True, 16, 16),
    (2, 64, 64, 2, 1, 8, True, 8, 32),
    (2, 64, 64, 2, 1, 8, True, 32, 8),
    (1, 40, 40, 2, 2, 8, True, 16, 8),
    (2, 24, 48, 8, 2, 16, False, 16, 16),
]


@pytest.mark.parametrize("cfg", FLASH_CASES,
                         ids=["-".join(map(str, c)) for c in FLASH_CASES])
def test_flash_attention_vs_pallas(cfg):
    B, T, S, H, Hkv, hd, causal, bq, bk = cfg
    q, k, v, w = _qkv(sum(cfg), B, T, H, hd, S=S, Hkv=Hkv)
    want = _jax_fwd_vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, bq=bq, bk=bk, interpret=True), q, k, v, w)
    before = dict(ops.LAUNCHES)
    got = _torch_fwd_vjp(lambda a, b, c: ops.flash_attention(
        a, b, c, causal=causal, bq=bq, bk=bk), q, k, v, w)
    assert ops.LAUNCHES == before          # CPU tensors never launch
    _close(got, want)
    # The forward's saved lse rows, which the backward recomputes P from,
    # against the JAX kernel's (on queries padded to a multiple of bq).
    bq = min(bq, T)
    qp = np.pad(q, ((0, 0), (0, -T % bq), (0, 0), (0, 0)))
    _, jlse = jfa._fwd_call(jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v),
                            causal, bq, min(bk, S), True)
    _, lse = ref.flash_fwd_ref(*(torch.from_numpy(a) for a in (qp, k, v)),
                               causal=causal)
    np.testing.assert_allclose(lse.numpy()[..., :T],
                               np.asarray(jlse)[..., :T], rtol=RTOL,
                               atol=ATOL)


def test_flash_shape_errors_and_meta():
    q, k, v, _ = _qkv(40, 1, 40, 2, 8)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ops.FlashShapeError):      # S % bk != 0
        ops.flash_attention(qt, kt, vt, causal=True, bq=16, bk=16)
    with pytest.raises(ops.FlashShapeError):      # no kv heads
        ops.flash_attention(qt, kt[:, :, :0], vt[:, :, :0], bq=16, bk=8)
    with pytest.raises(ops.FlashShapeError):      # H % Hkv != 0
        ops.flash_attention(torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 2, 8),
                            torch.zeros(1, 8, 2, 8))
    with pytest.raises(TypeError):
        ops.flash_attention(qt, kt.double(), vt)
    # The planner's probe: shape only, nothing launched.
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(qt.to("meta"), kt.to("meta"), vt.to("meta"),
                              bq=16, bk=8)
    assert out.device.type == "meta" and out.shape == qt.shape
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("impl,causal", [("xla", True), ("xla", False),
                                         ("chunked", True), ("flash", True),
                                         ("flash", False), ("auto", True)])
def test_attend_vs_reference(impl, causal):
    q, k, v, w = _qkv(7, 2, 32, 4, 16)
    want = _jax_fwd_vjp(lambda a, b, c: jattn.attend(
        a, b, c, causal=causal, impl=impl), q, k, v, w)
    got = _torch_fwd_vjp(lambda a, b, c: tattn.attend(
        a, b, c, causal=causal, impl=impl), q, k, v, w)
    _close(got, want)


def test_chunked_and_masks_vs_reference():
    """sdpa_chunked with window / offset / valid_len, and the causal
    mask, as the JAX package builds them."""
    q, k, v, _ = _qkv(9, 1, 32, 2, 8, S=48)
    for kw in (dict(chunk=8), dict(chunk=16, window=5),
               dict(chunk=8, offset=16, valid_len=40)):
        want = jattn.sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
        got = tattn.sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                 **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        tattn._causal_mask(5, 7, offset=2, window=3).numpy(),
        np.asarray(jattn._causal_mask(5, 7, offset=2, window=3)))
    with pytest.raises(tattn.FlashUnsupportedError):
        tattn.attend(*(torch.from_numpy(a) for a in (q, k, v)), window=4,
                     impl="flash")


def test_unserved_attention_paths_raise():
    """The KV cache is served: a prefill through the cache equals the
    JAX package's (output, written K/V slots, ``pos``).  So is the
    block-level ``dp_attn`` tap: under an active tapper the block's
    output equals the JAX package's and is tapped as one ``"attn"``
    layer capturing only its input; under an inactive one it is the
    plain block.  Cross attention is served too (``x_kv``: its output
    equals the JAX package's; ``tests/test_torch_encdec.py`` holds its
    VJP); the windowed flash attention that Zamba2 needs (item 12, part
    2) raises, and so does MLA with ``attn_impl="flash"`` (one head dim
    for q, k and v)."""
    rng = np.random.RandomState(12)
    x = rng.randn(2, 4, 8).astype(np.float32)
    p = {n: {"w": rng.randn(8, 8).astype(np.float32) * 0.3}
         for n in ("wq", "wk", "wv", "wo")}
    kw = dict(n_heads=2, n_kv=2, head_dim=4)
    tp = {n: {"w": torch.from_numpy(v["w"])} for n, v in p.items()}
    want, jc = jattn.gqa_apply(
        JTapper(), "attn", jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        cache=jattn.gqa_cache(2, 6, 2, 4), **kw)
    got, tc = tattn.gqa_apply(Tapper(), "attn", tp, torch.from_numpy(x),
                              cache=tattn.gqa_cache(2, 6, 2, 4), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == 4
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=RTOL, atol=ATOL)
    xt = torch.from_numpy(x)
    jtp = JTapper(None, "capture")
    want, _ = jattn.gqa_apply(jtp, "attn", jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x), dp_attn=True, **kw)
    ttp = Tapper("capture")
    got, none = tattn.gqa_apply(ttp, "attn", tp, xt, dp_attn=True, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert none is None and list(ttp.metas) == list(jtp.metas) == ["attn"]
    meta, jmeta = ttp.metas["attn"], jtp.metas["attn"]
    assert meta.kind == jmeta.kind == "attn"
    assert meta.static == jmeta.static and callable(meta.fn)
    assert list(ttp.captures["attn"]) == ["x"]
    plain, _ = tattn.gqa_apply(Tapper(), "attn", tp, xt, dp_attn=True, **kw)
    assert torch.equal(plain, got.detach())
    src = rng.randn(2, 7, 8).astype(np.float32)
    want, _ = jattn.gqa_apply(JTapper(), "attn",
                              jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              x_kv=jnp.asarray(src), **kw)
    got, none = tattn.gqa_apply(Tapper(), "attn", tp, xt,
                                x_kv=torch.from_numpy(src), **kw)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(tattn.FlashUnsupportedError, match="window=2"):
        tattn.gqa_apply(Tapper(), "attn", tp, xt, window=2,
                        **dict(kw, attn_impl="flash"))
    pm = tcm.split_tree(tattn.mla_init(torch.Generator().manual_seed(0), 8,
                                       2, **_MLA_DIMS))[0]
    with pytest.raises(tattn.FlashUnsupportedError, match="MLA"):
        tattn.mla_apply(Tapper(), "m", pm, xt, n_heads=2,
                        attn_impl="flash", **_MLA_DIMS)


_MLA_DIMS = dict(q_lora_rank=8, kv_lora_rank=12, qk_nope_dim=6,
                 qk_rope_dim=4, v_head_dim=6)


@pytest.mark.parametrize("q_lora", (8, 0), ids=("q_lora", "wq"))
@pytest.mark.parametrize("absorbed", (False, True),
                         ids=("decompressed", "absorbed"))
def test_mla_matches_reference(absorbed, q_lora):
    """``mla_apply`` against the JAX package's, after
    ``tests/test_attention.py::test_mla_decode_matches_train`` (D = 24,
    2 heads, kv rank 12, nope / rope / v 6 / 4 / 6; a q rank of 8, or
    none and a plain ``wq``): the train path; then token-by-token decode
    through the latent cache, each step's output and the final cache
    slots against the reference's, and the decoded sequence against the
    train path."""
    dims = dict(_MLA_DIMS, q_lora_rank=q_lora)
    kw = dict(n_heads=2, **dims)
    tree = jattn.mla_init(jax.random.PRNGKey(4), 24, 2, **dims)
    jp = jcm.split_tree(tree)[0]
    tp = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
          for k, v in jp.items()}
    assert sorted(tp) == sorted(
        (["wq_a", "q_norm", "wq_b"] if q_lora else ["wq"])
        + ["wkv_a", "kv_norm", "wkv_b", "wo"])
    B, T = 2, 7
    x = np.random.RandomState(4).randn(B, T, 24).astype(np.float32)
    jfull, _ = jattn.mla_apply(JTapper(), "m", jp, jnp.asarray(x), **kw)
    full, _ = tattn.mla_apply(Tapper(), "m", tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=RTOL,
                               atol=ATOL)
    jcache = jattn.mla_cache(B, T, 12, 4)
    cache = tattn.mla_cache(B, T, 12, 4)
    outs = []
    for t in range(T):
        jo, jcache = jattn.mla_apply(JTapper(), "m", jp,
                                     jnp.asarray(x[:, t:t + 1]),
                                     cache=jcache, absorbed_decode=absorbed,
                                     **kw)
        o, cache = tattn.mla_apply(Tapper(), "m", tp,
                                   torch.from_numpy(x[:, t:t + 1]),
                                   cache=cache, absorbed_decode=absorbed,
                                   **kw)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
        outs.append(o)
    assert cache["pos"] == int(jcache["pos"]) == T
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               full.numpy(), rtol=3e-4, atol=3e-5)
