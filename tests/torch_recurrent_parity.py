"""Shared checks of the recurrent LM families (xLSTM, Zamba2) in the port
against the JAX package's, for ``tests/test_torch_ssm.py`` and
``tests/test_torch_hybrid.py``.

A reduced config (the JAX package's ``.reduced()``), params from the JAX
package's ``init`` through numpy (``weights.params_from_numpy``), and
three batches of B = 3, T = 8 token ids from a numpy seed.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.core as jcore
from repro.configs import get_config as jget
from repro.core import costmodel as jcost
from repro.core import kinds as jkinds
from repro.core import strategies as jstrat
from repro.core.tapper import probe as jprobe
from repro.models.lm import TransformerLM as JLM
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
import repro_torch.core as tcore
from repro_torch.configs import get_config as tget
from repro_torch.core import costmodel as tcost
from repro_torch.core import kinds as tkinds
from repro_torch.core import strategies as tstrat
from repro_torch.core.tapper import capture_backward
from repro_torch.kernels import ops
from repro_torch.models.lm import TransformerLM as TLM
from repro_torch.optim import adamw_init as tadamw_init
from repro_torch.optim import adamw_update as tadamw_update
from repro_torch.tree import get_subtree, leaf_paths, tree_map
from repro_torch.weights import params_from_numpy, params_to_numpy

B, T = 3, 8
# The reference's exactness tolerances (tests/test_ghost_archs.py): norms
# rtol 3e-4 against naive, clipped sums 5e-5 of the largest entry.
NORM_RTOL, SUM_TOL = 3e-4, 5e-5
# Cotangents and captures: rtol 1e-5 and an absolute floor of COT_ATOL of
# the tap's largest entry.  The f32 recurrences sum in another order in
# each package; the spread measured over every tap of both reduced models
# is at most 6e-6 of the largest entry (the dense LMs' 1e-6 is below it).
COT_ATOL = 2e-5
_TORCH_DT = {jnp.dtype(jnp.float32): torch.float32,
             jnp.dtype(jnp.bfloat16): torch.bfloat16}


def t_(tree):
    """numpy / JAX tree -> torch tree (CPU)."""
    if isinstance(tree, dict):
        return {k: t_(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(t_(v) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True))


def tree_close(got, want, rtol, atol, what=""):
    for k in want:
        if isinstance(want[k], dict):
            tree_close(got[k], want[k], rtol, atol, f"{what}/{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), rtol=rtol,
                                       atol=atol, err_msg=f"{what}/{k}")


def setup(arch, **cfg_kw):
    """(JAX model, port model, JAX params, port params, numpy batches)."""
    jm = JLM(jget(arch).reduced().replace(**cfg_kw))
    tm = TLM(tget(arch).reduced().replace(**cfg_kw))
    jparams = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                like=tm.init(0, device="cpu")[0],
                                device="cpu")
    rng = np.random.RandomState(1)
    batches = [{k: rng.randint(0, jm.cfg.vocab, (B, T)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    return jm, tm, jparams, tparams, batches


def capture_both(jm, tm, jparams, tparams, batch):
    jb = jax.tree.map(jnp.asarray, batch)
    _, jmetas, _ = jprobe(jm.apply, jparams, jb)
    jl, jcaps, jdtaps = jax.jit(
        lambda p, b: jstrat._capture(jm.apply, p, b)[:3])(jparams, jb)
    before = dict(ops.LAUNCHES)
    tl, tcaps, tdtaps, tmetas = capture_backward(tm.apply, tparams,
                                                 t_(batch), with_metas=True)
    assert ops.LAUNCHES == before          # CPU tensors never launch
    return (jmetas, jcaps, jdtaps, jl), (tmetas, tcaps, tdtaps, tl)


def check_losses_and_cotangents(captured):
    """Per-example losses rtol 1e-5; every tap's meta field by field (but
    ``fn``), its captures and cotangent rtol 1e-5, atol ``COT_ATOL`` of
    the largest entry."""
    (jmetas, jcaps, jdtaps, jl), (tmetas, tcaps, tdtaps, tl) = captured
    assert list(tmetas) == list(jmetas)
    for n, jmeta in jmetas.items():
        tmeta = tmetas[n]
        for f in ("kind", "path", "param_key", "bias_key", "w_transposed",
                  "segmented", "scanned", "shared", "static"):
            assert getattr(tmeta, f) == getattr(jmeta, f), (n, f)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for n in jmetas:
        want = np.asarray(jdtaps[n])
        assert tuple(tdtaps[n].shape) == want.shape, n
        np.testing.assert_allclose(tdtaps[n].numpy(), want, rtol=1e-5,
                                   atol=COT_ATOL * np.abs(want).max(),
                                   err_msg=n)
        for k, jc in jcaps[n].items():
            pairs = (zip(tcaps[n][k], jc) if isinstance(jc, tuple)
                     else [(tcaps[n][k], jc)])
            for got, want in pairs:
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-5,
                    atol=COT_ATOL * max(np.abs(want).max(), 1e-30),
                    err_msg=f"{n}/{k}")
    return tmetas


def check_group_norms(jparams, tparams, captured):
    (jmetas, jcaps, jdtaps, _), (tmetas, tcaps, tdtaps, _) = captured
    jkeys, jn = jstrat.group_norms_from_captures(jparams, jcaps, jdtaps,
                                                 jmetas)
    tkeys, tn = tstrat.group_norms_from_captures(
        tparams, tcaps, tdtaps, tmetas, embed_method="segsum")
    assert tkeys == jkeys
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    return tkeys


def naive_norms(tm, tparams, batch):
    """The port's ``naive`` per-example grads and their squared norms."""
    _, pe = tstrat.naive_per_example_grads(tm.apply, tparams, t_(batch))
    n = sum(get_subtree(pe, q).double().square().flatten(1).sum(1)
            for q in leaf_paths(pe))
    return pe, n


def check_against_naive(tm, tparams, batch, strategy):
    """``strategy``'s per-example squared norms (rtol 3e-4) against the
    squared norms of ``naive``'s per-example grads, and its clipped sum
    against ``naive``'s (5e-5 of the largest entry)."""
    _, want = naive_norms(tm, tparams, batch)
    b = t_(batch)
    _, ref, _ = tcore.clipped_grad_sum(tm.apply, tparams, b, l2_clip=1.0,
                                       strategy="naive")
    scale = max(max(get_subtree(ref, q).abs().max().item()
                    for q in leaf_paths(ref)), 1.0)
    _, g, n = tcore.clipped_grad_sum(tm.apply, tparams, b, l2_clip=1.0,
                                     strategy=strategy)
    np.testing.assert_allclose(n.double().numpy(), want.numpy(),
                               rtol=NORM_RTOL)
    worst = max((get_subtree(g, q) - get_subtree(ref, q)).abs().max()
                .item() for q in leaf_paths(ref))
    assert worst < SUM_TOL * scale, (strategy, worst, scale)


def check_private_steps(jm, tm, jparams, tparams, batches, strategy, mode):
    """Three σ = 0 AdamW private steps: losses rtol 1e-4, per-example
    norms rtol 1e-5, params rtol 1e-4 / atol 1e-6; an ``auto`` plan's
    per-layer decisions equal the reference's."""
    jdp = jcore.DPConfig(l2_clip=1.0, strategy=strategy, clipping=mode)
    tdp = tcore.DPConfig(l2_clip=1.0, strategy=strategy, clipping=mode)
    jeng = jcore.PrivacyEngine(
        jm.apply, jparams, batches[0], dp=jdp, lr=1e-4,
        optimizer=functools.partial(jadamw_update, eps=1e-6))
    teng = tcore.PrivacyEngine(
        tm.apply, tparams, t_(batches[0]), dp=tdp, lr=1e-4, device="cpu",
        optimizer=functools.partial(tadamw_update, eps=1e-6))
    if strategy == "auto":
        assert plan_decisions(teng.plan()) == plan_decisions(jeng.plan())
    jp, tp = jparams, tparams
    jopt, topt = jadamw_init(jp), tadamw_init(tp)
    for b in batches:
        jp, jopt, jloss, jaux = jeng.private_step(
            jp, jopt, jax.tree.map(jnp.asarray, b))
        tp, topt, tloss, taux = teng.private_step(tp, topt, t_(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(taux["per_example_norms"].numpy(),
                                   np.asarray(jaux["per_example_norms"]),
                                   rtol=1e-5)
    tree_close(params_to_numpy(tp), jax.tree.map(np.asarray, jp),
               rtol=1e-4, atol=1e-6)
    return teng


def plan_decisions(plan):
    return ({n: (lp.kind, lp.norm_method, lp.stash, lp.fused,
                 lp.norm_flops, lp.contrib_flops, lp.stash_bytes)
             for n, lp in plan.layers.items()},
            {"/".join(map(str, g.path)): (g.members, g.norm_mode,
                                          g.sum_method)
             for g in plan.groups}, plan.needs_backward, plan.capture_bytes)


def plans_by_shape(arch, cfg_fn, Bb, Tt, **opts):
    """``get_plan`` in both packages by shape only (JAX: ``eval_shape``
    params, the port: meta tensors) -> (JAX plan, port plan)."""
    jm = JLM(cfg_fn(jget(arch)))
    tm = TLM(cfg_fn(tget(arch)))
    jp = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    tp = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=_TORCH_DT[jnp.dtype(s.dtype)], device="meta"), jp)
    jb = {k: jax.ShapeDtypeStruct((Bb, Tt), jnp.int32)
          for k in ("tokens", "labels")}
    tb = {k: torch.empty((Bb, Tt), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    return (jcost.get_plan(jm.apply, jp, jb, **opts),
            tcost.get_plan(tm.apply, tp, tb, **opts))


def check_plans(arch, cfg_fn, Bb, Tt, mode):
    """``plans_by_shape`` under ``mode``: the same per-layer decisions and
    FLOP estimates, groups, backward and capture bytes; every local_vjp
    layer is a stashed "pe"; the plan round-trips through JSON (format 3
    carries the kind; the meta's fn stays behind)."""
    jplan, tplan = plans_by_shape(arch, cfg_fn, Bb, Tt, clip_mode=mode)
    assert plan_decisions(tplan) == plan_decisions(jplan)
    vjp = {n: lp for n, lp in tplan.layers.items() if lp.kind == "local_vjp"}
    assert vjp and all((lp.norm_method, lp.stash) == ("pe", True)
                       for lp in vjp.values())
    back = tcost.ExecPlan.from_json(tplan.to_json())
    assert back == tplan
    assert all(back.metas[n].fn is None and back.metas[n].kind ==
               "local_vjp" for n in vjp)
    return tplan


def close(got, want, rtol=1e-5, what=""):
    """Trees of tensors against trees of arrays: rtol, and atol rtol of
    the largest entry."""
    if isinstance(want, dict):
        for k in want:
            close(got[k], want[k], rtol, f"{what}/{k}")
        return
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def check_local_vjp_kind(jparams, tparams, captured, name, layer, op,
                         scanned):
    """``apply_kind(op)`` on the captured local_vjp tap ``name`` against
    the reference's; ``layer`` (a tuple of stack indices) takes that
    layer alone, unstacked."""
    (jmetas, jcaps, jdtaps, _), (tmetas, tcaps, tdtaps, _) = captured
    jmeta, tmeta = jmetas[name], tmetas[name]
    assert tmeta.kind == "local_vjp" and callable(tmeta.fn)
    assert tmeta.scanned == jmeta.scanned == scanned
    jcap, jdy = jcaps[name], jdtaps[name]
    tcap, tdy = tcaps[name], tdtaps[name]
    jps = get_subtree(jparams, jmeta.path)
    tps = get_subtree(tparams, tmeta.path)
    if layer:
        jmeta = dataclasses.replace(jmeta, scanned=0)
        tmeta = dataclasses.replace(tmeta, scanned=0)
        jcap = {"inputs": tuple(a[layer] for a in jcap["inputs"])}
        tcap = {"inputs": tuple(a[layer] for a in tcap["inputs"])}
        jdy, tdy = jdy[layer], tdy[layer]
        jps = jax.tree.map(lambda a: a[layer], jps)
        tps = {k: v[layer] for k, v in tps.items()}
    w = np.random.RandomState(5).rand(B).astype(np.float32)
    kw = dict(weights=jnp.asarray(w)) if op == "contrib" else {}
    want = jkinds.apply_kind(op, jmeta, jcap, jdy, params_sub=jps, **kw)
    kw = dict(weights=torch.from_numpy(w)) if op == "contrib" else {}
    got = tkinds.apply_kind(op, tmeta, tcap, tdy, params_sub=tps, **kw)
    close(got, jax.tree.map(np.asarray, want), what=op)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.float() if isinstance(tree, torch.Tensor)
                      else tree)


def check_prefill_and_decode(jm, tm, jparams, tparams, *, max_len=14,
                             prompt_len=8):
    """Prefill (one decode step a prompt token) + 4 greedy decode steps:
    logits rtol 1e-5 / atol 1e-6, tokens and ``pos`` equal, every
    recurrent state and cache slot rtol 1e-5 / atol 1e-6 of its largest
    entry; then decode equals one training forward over the same tokens
    (rtol 2e-4 / atol 2e-5, as ``tests/test_torch_serve.py``)."""
    prompts = np.random.RandomState(4).randint(
        0, jm.cfg.vocab, (2, prompt_len)).astype(np.int32)
    jl, jc = jm.prefill(jparams, jnp.asarray(prompts), max_len=max_len)
    tl, tc = tm.prefill(tparams, torch.from_numpy(prompts),
                        max_len=max_len)
    toks, outs = [], []
    for i in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6, err_msg=f"call {i}")
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert tc["pos"] == int(jc["pos"]) == prompt_len + i
        want, got = _np_tree(jc["layers"]), _np_tree(tc["layers"])
        for q in leaf_paths(want):
            w, g = get_subtree(want, q), get_subtree(got, q)
            assert g.shape == w.shape, q
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=COT_ATOL * max(np.abs(w).max(), 1e-30),
                err_msg=f"call {i} {'/'.join(q)}")
        outs.append(tl.numpy())
        toks.append(ttok)
        if i < 4:
            jl, jc = jm.decode_step(jparams, jc, jtok)
            tl, tc = tm.decode_step(tparams, tc, ttok)
    tokens = torch.cat([torch.from_numpy(prompts).long(),
                        torch.stack(toks[:-1], 1)], 1)
    with torch.no_grad():
        full = tm.logits(tparams, tokens).numpy()
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, full[:, prompt_len - 1 + i],
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"call {i}")
    return tc


def _jax_logits(jm, params, tokens):
    """The JAX package's training forward up to the logits (its
    ``apply`` without the loss)."""
    from repro.core.tapper import Tapper as JTapper
    from repro.models import common as jcm
    tp = JTapper()
    h = tp.embed("tok_emb", params["tok_emb"]["emb"], tokens)
    h, _ = jm._backbone_train(params, h, tp)
    h = jcm.apply_norm(tp, "final_norm", params.get("final_norm"), h,
                       jm.cfg.norm)
    return jm._head(tp, params, h)


def check_bf16_decode_against_f32(arch, *, max_len=14, prompt_len=8):
    """The bf16 decode rule that ``chip_smoke.py`` holds the recurrent
    families to (``serve_checks_f32_ref``), in both packages on the same
    bf16 weights: prefill + 4 greedy decode steps in bf16, against the
    f32 forward (the bf16 weights upcast) over the same tokens; the
    served logits must be within twice the bf16 forward's own distance
    from that f32 forward plus 2^-8 of its largest logit.  Returns each
    package's (served, bf16 forward, bound) distances."""
    jm, tm, jparams, tparams, _ = setup(arch, dtype="bfloat16")
    jm32 = JLM(jm.cfg.replace(dtype="float32"))
    tm32 = TLM(tm.cfg.replace(dtype="float32"))
    prompts = np.random.RandomState(4).randint(
        0, jm.cfg.vocab, (2, prompt_len)).astype(np.int32)
    P = prompt_len - 1

    def jax_side():
        lg, c = jm.prefill(jparams, jnp.asarray(prompts), max_len=max_len)
        outs, toks = [lg], []
        for _ in range(4):
            toks.append(jnp.argmax(outs[-1], -1).astype(jnp.int32))
            lg, c = jm.decode_step(jparams, c, toks[-1])
            outs.append(lg)
        tokens = jnp.concatenate([jnp.asarray(prompts),
                                  jnp.stack(toks, 1)], 1)
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        f = lambda m, p: np.asarray(_jax_logits(m, p, tokens)[:, P:],
                                    np.float32)
        return (np.stack([np.asarray(o, np.float32) for o in outs], 1),
                f(jm, jparams), f(jm32, p32))

    def torch_side():
        lg, c = tm.prefill(tparams, torch.from_numpy(prompts),
                           max_len=max_len)
        outs, toks = [lg], []
        for _ in range(4):
            toks.append(torch.argmax(outs[-1], -1))
            lg, c = tm.decode_step(tparams, c, toks[-1])
            outs.append(lg)
        tokens = torch.cat([torch.from_numpy(prompts).long(),
                            torch.stack(toks, 1)], 1)
        p32 = tree_map(lambda a: a.float(), tparams)
        with torch.no_grad():
            return (torch.stack(outs, 1).float().numpy(),
                    tm.logits(tparams, tokens)[:, P:].float().numpy(),
                    tm32.logits(p32, tokens)[:, P:].numpy())

    rec = {}
    for name, side in (("jax", jax_side), ("port", torch_side)):
        served, fwd, ref = side()
        err = float(np.abs(served - ref).max())
        fwd_err = float(np.abs(fwd - ref).max())
        bound = 2 * fwd_err + 2 ** -8 * float(np.abs(ref).max())
        assert err <= bound, (arch, name, err, fwd_err, bound)
        rec[name] = (err, fwd_err, bound)
    return rec
