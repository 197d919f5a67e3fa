"""Serving in the port (KV cache, prefill, decode, ``launch/serve.py``)
against the JAX package's.

Reduced Llama-3.2-1B, reduced GLM-4-9B and reduced Llama-3.2-1B with
MLA (its cache the latent KV; decompressed and absorbed decode) in f32:
params from the JAX
package's ``init`` pass through numpy into the port, and the same numpy
prompts (B = 2, 8 tokens, from a seed) go through both packages'
``prefill`` and then 4 greedy ``decode_step``s.  After each call the
logits agree to rtol 1e-5 / atol 1e-6 (f32, sums in another order), the
greedy tokens are equal, the caches' ``pos`` is equal and so are the
written slots of every layer's K and V (MLA: ``ckv`` and ``krope``;
rtol 1e-5, atol 1e-6 of the
largest entry, as the other parity tests hold captures), the rest zero.
The port's own properties mirror ``tests/test_attention.py``'s: incremental decode equals the full
causal forward, prefill then decode equals it, and a ring cache of the
window's size equals windowed attention (rtol 2e-4 / atol 2e-5, as
there); at the model level prefill plus decode equals one training
forward's logits.  ``launch/serve.py`` runs on the CPU (``--device
cpu``), with ``--dp-plan`` a plan store written by ``launch/train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models.lm import TransformerLM as JLM  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.tapper import Tapper  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

B, TP, STEPS = 2, 8, 4
MAX_LEN = TP + STEPS + 2
# id -> the reduced config, built alike from either package's get_config
ARCHS = {
    "llama3.2-1b": lambda get: get("llama3.2-1b").reduced(),
    "glm4-9b": lambda get: get("glm4-9b").reduced(),
    "llama3.2-1b+mla": lambda get: get("llama3.2-1b").replace(
        mla=True).reduced(),
    "llama3.2-1b+mla_absorbed": lambda get: get("llama3.2-1b").replace(
        mla=True, mla_absorbed_decode=True).reduced()}


def _cache_shapes(cfg):
    """Each cache entry's shape per layer past (L, B, MAX_LEN)."""
    if cfg.mla:
        return {"ckv": (cfg.kv_lora_rank,), "krope": (cfg.qk_rope_dim,)}
    return {k: (cfg.n_kv, cfg.hd) for k in ("k", "v")}


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    """Both packages' prefill and decode steps on the same prompts:
    ([(logits, tokens, cache)] of each call, JAX then port), and the
    port's model and params."""
    arch = request.param
    jm, tm = JLM(ARCHS[arch](jget)), TLM(ARCHS[arch](tget))
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    prompts = np.random.RandomState(4).randint(
        0, jm.cfg.vocab, (B, TP)).astype(np.int32)
    jl, jc = jm.prefill(jparams, jnp.asarray(prompts), max_len=MAX_LEN)
    tl, tc = tm.prefill(tparams, torch.from_numpy(prompts), max_len=MAX_LEN)
    jcalls, tcalls = [], []
    for _ in range(STEPS + 1):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        jcalls.append((np.asarray(jl), np.asarray(jtok),
                       jax.tree.map(np.asarray, jc)))
        tcalls.append((tl.numpy(), ttok.numpy(), tc))
        if len(jcalls) <= STEPS:
            jl, jc = jm.decode_step(jparams, jc, jtok)
            tl, tc = tm.decode_step(tparams, tc, ttok)
    return arch, jcalls, tcalls, tm, tparams, prompts


def test_prefill_and_decode_match_reference(served):
    arch, jcalls, tcalls, tm, _, _ = served
    for i, ((jl, jtok, jc), (tl, ttok, tc)) in enumerate(zip(jcalls,
                                                             tcalls)):
        what = f"{arch} call {i}"
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6,
                                   err_msg=what)
        np.testing.assert_array_equal(ttok, jtok, err_msg=what)
        assert tc["pos"] == int(jc["pos"]) == TP + i, what
        for k, shape in _cache_shapes(tm.cfg).items():
            want = jc["layers"][k]
            got = tc["layers"][k].numpy()
            assert got.shape == want.shape == (
                tm.cfg.n_layers, B, MAX_LEN) + shape
            n = TP + i
            np.testing.assert_allclose(
                got[:, :, :n], want[:, :, :n], rtol=1e-5,
                atol=1e-6 * np.abs(want).max(), err_msg=what)
            assert not got[:, :, n:].any() and not want[:, :, n:].any()


def test_decode_equals_training_forward(served):
    """The logits of prefill plus k decode steps are those of one causal
    forward (the training path) over the same tokens."""
    arch, _, tcalls, tm, tparams, prompts = served
    toks = np.concatenate([prompts] + [t[1][:, None] for t in tcalls[:-1]],
                          axis=1)
    with torch.no_grad():
        full = tm.logits(tparams, torch.from_numpy(toks)).numpy()
    for i, (tl, _, _) in enumerate(tcalls):
        np.testing.assert_allclose(tl, full[:, TP - 1 + i], rtol=2e-4,
                                   atol=2e-5, err_msg=f"{arch} call {i}")


def _gqa(seed, D, H, KV, hd):
    gen = torch.Generator().manual_seed(seed)
    p = tcm.split_tree(tattn.gqa_init(gen, D, H, KV, hd))[0]
    return p, dict(n_heads=H, n_kv=KV, head_dim=hd)


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_decode_matches_full_forward():
    p, kw = _gqa(0, 16, 4, 2, 8)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 10, 16)
                         .astype(np.float32))
    full, _ = tattn.gqa_apply(Tapper(), "a", p, x, causal=True, **kw)
    cache = tattn.gqa_cache(2, 10, 2, 8)
    outs = []
    for t in range(10):
        o, cache = tattn.gqa_apply(Tapper(), "a", p, x[:, t:t + 1],
                                   cache=cache, **kw)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full)


def test_prefill_then_decode_matches_full():
    p, kw = _gqa(1, 16, 4, 4, 8)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 16)
                         .astype(np.float32))
    full, _ = tattn.gqa_apply(Tapper(), "a", p, x, causal=True, **kw)
    cache = tattn.gqa_cache(2, 8, 4, 8)
    pre, cache = tattn.gqa_apply(Tapper(), "a", p, x[:, :5], cache=cache,
                                 **kw)
    _close(pre, full[:, :5])
    o5, cache = tattn.gqa_apply(Tapper(), "a", p, x[:, 5:6], cache=cache,
                                **kw)
    _close(o5[:, 0], full[:, 5])
    assert cache["pos"] == 6


def test_sliding_window_ring_cache():
    """Ring-buffer decode == full attention restricted to the window."""
    p, kw = _gqa(2, 16, 2, 2, 8)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 12, 16)
                         .astype(np.float32))
    full, _ = tattn.gqa_apply(Tapper(), "a", p, x, causal=True, window=4,
                              **kw)
    cache = tattn.gqa_cache(1, 4, 2, 8)          # ring size == window
    outs = []
    for t in range(12):
        o, cache = tattn.gqa_apply(Tapper(), "a", p, x[:, t:t + 1],
                                   cache=cache, window=4, **kw)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full)


def test_generate_batch_serves_mla(served):
    """``launch.serve.generate_batch`` serves every config of the lane
    (MLA too) through the same ``prefill`` / ``decode_step``: its greedy
    tokens are those of the calls above."""
    arch, _, tcalls, tm, tparams, prompts = served
    toks = serve.generate_batch(tm, tparams, torch.from_numpy(prompts),
                                max_len=MAX_LEN, gen=STEPS + 1)
    np.testing.assert_array_equal(
        toks.numpy(), np.stack([t[1] for t in tcalls], axis=1), err_msg=arch)


def test_serving_never_records():
    """Serving runs without autograd: no output requires grad, even with
    params that do."""
    tm = TLM(tget("llama3.2-1b").reduced())
    params, _ = tm.init(0, device="cpu")
    params = tree_map(lambda a: a.requires_grad_(True), params)
    logits, cache = tm.prefill(params, torch.zeros(1, 3, dtype=torch.long),
                               max_len=5)
    logits2, cache = tm.decode_step(params, cache,
                                    torch.zeros(1, dtype=torch.long))
    assert not logits.requires_grad and not logits2.requires_grad
    assert cache["pos"] == 4


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "glm4-9b", "--device", "cpu", "--n-requests", "3",
                "--batch", "2", "--prompt-len", "6", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("batch done: (2, 4)") for ln in out) == 2
    assert out[-1].startswith("served 4 requests in ")


def test_serve_cli_preloads_a_train_plan_store(tmp_path, capsys):
    store = str(tmp_path / "plans.json")
    train.main(["--arch", "llama3.2-1b", "--device", "cpu", "--steps", "1",
                "--batch", "2", "--seq", "8", "--strategy", "auto",
                "--plan-json", store])
    capsys.readouterr()
    serve.main(["--arch", "llama3.2-1b", "--device", "cpu", "--n-requests",
                "2", "--batch", "2", "--prompt-len", "4", "--gen", "2",
                "--dp-plan", store])
    out = capsys.readouterr().out
    assert f"[dp] pre-loaded 1 exec plan(s) from {store}" in out
    assert "served 2 requests in " in out
