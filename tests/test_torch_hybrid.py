"""The hybrid family (Zamba2: Mamba2 layers and one weight-shared
attention block applied once a super-block) in the port against the JAX
package's.

Reduced Zamba2-2.7B (2 super-blocks of 2 Mamba2 layers, d_model 64,
``ssm_state`` 16, window 4096; params from the JAX package's ``init``
through numpy, B = 3, T = 8): the shared block's taps (``blocks/~shared/
...``: absolute paths, ``shared``, ``scanned`` 1), losses, metas, captures
and cotangents, group norms (``tests/torch_recurrent_parity.py`` has the
tolerances), the ``local_vjp`` kind on Mamba2's SSD parameters
(``scanned`` 2, stacked and one layer alone), ghost and bk against the
port's own ``naive`` (norms rtol 3e-4, sums 5e-5 of the largest entry;
the shared block's group norm, cross terms between its applications
included, against ``naive``'s per-example grad of it), three σ = 0 steps
of bk, ``auto`` flat and ``auto`` stale against the JAX package's,
``remat=True`` bitwise ``remat=False`` (captures, cotangents, bk's
clipped sum, and ``naive``'s grads of the shared block, which the
checkpoint closes over), the plans by shape (reduced, and the card lane:
full width cut to 2 super-blocks, B = 4, T = 512), prefill + 4 decode
steps (every recurrent state and KV slot; with ``window=6`` the cache is
a ring that wraps), and the train and serve entry points on both
recurrent archs.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import kinds as tkinds  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.core.tapper import STATS, Tapper, capture_backward  # noqa
from repro_torch.models.lm import TransformerLM as TLM  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402

import torch_recurrent_parity as rp  # noqa: E402

B, T = rp.B, rp.T
ARCH = "zamba2-2.7b"
SHARED = ("blocks/~shared/ln1", "blocks/~shared/attn/wq",
          "blocks/~shared/attn/wk", "blocks/~shared/attn/wv",
          "blocks/~shared/attn/wo", "blocks/~shared/ln2",
          "blocks/~shared/mlp/w_gate", "blocks/~shared/mlp/w_up",
          "blocks/~shared/mlp/w_down")


@pytest.fixture(scope="module")
def zb():
    return rp.setup(ARCH)


@pytest.fixture(scope="module")
def captured(zb):
    jm, tm, jparams, tparams, batches = zb
    return rp.capture_both(jm, tm, jparams, tparams, batches[0])


def test_losses_and_cotangents_match_reference(captured):
    tmetas = rp.check_losses_and_cotangents(captured)
    for n in SHARED:
        m = tmetas[n]
        assert m.shared and m.scanned == 1 and m.path[0] == "shared", n
    ssd = tmetas["blocks/mamba/blk/ssd"]
    assert (ssd.kind, ssd.scanned, ssd.path) == (
        "local_vjp", 2, ("blocks", "mamba", "blk", "ssd"))


def test_group_norms_match_reference(zb, captured):
    keys = rp.check_group_norms(zb[2], zb[3], captured)
    assert "shared/attn/wq" in keys and "blocks/mamba/blk/ssd" in keys


@pytest.mark.parametrize("op", ("pe_grad", "norm_sq", "contrib"))
@pytest.mark.parametrize("layer", ((), (1, 0)), ids=["stacked", "one_layer"])
def test_local_vjp_kind_matches_reference(zb, captured, op, layer):
    """The kind on Mamba2's SSD parameters (A_log, dt_bias, D; blocks x
    mamba), stacked and one layer alone."""
    rp.check_local_vjp_kind(zb[2], zb[3], captured, "blocks/mamba/blk/ssd",
                            layer, op, scanned=2)


@pytest.mark.parametrize("strategy", ("ghost", "bk"))
def test_norms_and_sums_match_naive(zb, strategy):
    _, tm, _, tparams, batches = zb
    rp.check_against_naive(tm, tparams, batches[1], strategy)


def test_shared_group_norms_hold_the_cross_terms(zb):
    """Each shared parameter's group norm (its applications folded into
    the sequence axis) equals the squared norm of ``naive``'s per-example
    grad of it, the sum over both applications (rtol 3e-4), and differs
    from the sum of the applications' own norms."""
    _, tm, _, tparams, batches = zb
    pe, _ = rp.naive_norms(tm, tparams, batches[1])
    _, caps, dtaps, metas = capture_backward(
        tm.apply, tparams, rp.t_(batches[1]), with_metas=True)
    keys, norms = tstrat.group_norms_from_captures(tparams, caps, dtaps,
                                                   metas)
    for n in ("blocks/~shared/attn/wq", "blocks/~shared/mlp/w_down",
              "blocks/~shared/ln2"):
        key = "/".join(metas[n].path)
        sub = get_subtree(pe, metas[n].path)
        want = sum(v.double().square().flatten(1).sum(1)
                   for v in sub.values())
        got = norms[keys.index(key)]
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=rp.NORM_RTOL, err_msg=n)
    # the cross terms are not negligible: apart, the two applications'
    # norms sum to another number
    n = "blocks/~shared/attn/wq"
    apart = sum(tkinds.apply_kind(
        "norm_sq", tkinds._unscanned(metas[n]),
        {"x": caps[n]["x"][i]}, dtaps[n][i]) for i in range(2))
    assert not np.allclose(apart.numpy(),
                           norms[keys.index("shared/attn/wq")].numpy(),
                           rtol=1e-2)


@pytest.mark.parametrize("strategy,mode", [("bk", "flat"), ("auto", "flat"),
                                           ("auto", "stale")])
def test_private_steps_match_reference(zb, strategy, mode):
    rp.check_private_steps(*zb, strategy, mode)


def test_remat_is_bitwise(zb):
    """``remat=True`` (the config's setting at full width): captures,
    cotangents and bk's clipped sum equal ``remat=False``'s bitwise, each
    super-block recomputed once; ``naive``'s per-example grads too, the
    shared block's (closed over by the checkpoint) included and not
    zero."""
    _, tm, _, tparams, batches = zb
    rm = TLM(tm.cfg.replace(remat=True))
    b = rp.t_(batches[2])
    STATS.reset()
    got = capture_backward(rm.apply, tparams, b)
    assert STATS.recomputes == tm.cfg.n_layers // tm.cfg.attn_every
    want = capture_backward(tm.apply, tparams, b)
    assert torch.equal(got[0], want[0])
    for n in want[2]:
        assert torch.equal(got[2][n], want[2][n]), n
        for k, v in want[1][n].items():
            for g, w in (zip(got[1][n][k], v) if isinstance(v, tuple)
                         else [(got[1][n][k], v)]):
                assert torch.equal(g, w), (n, k)
    g = tcore.clipped_grad_sum(rm.apply, tparams, b, l2_clip=0.05,
                               strategy="bk")
    w = tcore.clipped_grad_sum(tm.apply, tparams, b, l2_clip=0.05,
                               strategy="bk")
    assert torch.equal(g[2], w[2])
    for q in leaf_paths(w[1]):
        assert torch.equal(get_subtree(g[1], q), get_subtree(w[1], q)), q
    STATS.reset()
    _, pg = tstrat.naive_per_example_grads(rm.apply, tparams, b)
    assert STATS.recomputes == B * 2
    _, pw = tstrat.naive_per_example_grads(tm.apply, tparams, b)
    for q in leaf_paths(pw):
        assert torch.equal(get_subtree(pg, q), get_subtree(pw, q)), q
    assert get_subtree(pg, ("shared", "attn", "wq", "w")).abs().sum() > 0


@pytest.mark.parametrize("lane,mode", [("reduced", "flat"),
                                       ("reduced", "stale"),
                                       ("lane", "flat")])
def test_plans_match_reference(lane, mode):
    """``get_plan`` by shape only, reduced at B = 3, T = 8 and at the card
    lane's shape (full width cut to 2 super-blocks, B = 4, T = 512):
    see ``torch_recurrent_parity.check_plans``.  The shared block's denses
    are single groups whose stack folds into the sequence axis."""
    if lane == "reduced":
        plan = rp.check_plans(ARCH, lambda c: c.reduced(), B, T, mode)
    else:
        plan = rp.check_plans(ARCH, lambda c: c.replace(n_layers=12), 4,
                              512, mode)
    g = next(g for g in plan.groups if g.path == ("shared", "attn", "wq"))
    assert g.members == ("blocks/~shared/attn/wq",) and \
        g.norm_mode == "single"


@pytest.mark.parametrize("window", (None, 6), ids=["window4096", "ring6"])
def test_prefill_and_decode_match_reference(window):
    """Prefill + 4 decode steps against the JAX package's; with
    ``window=6`` and 14 positions the shared block's KV cache is a
    6-slot ring that wraps during the prompt, and decode still equals the
    windowed training forward."""
    kw = {} if window is None else {"window": window}
    jm, tm, jparams, tparams, _ = rp.setup(ARCH, **kw)
    tc = rp.check_prefill_and_decode(jm, tm, jparams, tparams)
    S = tc["layers"]["attn"]["k"].shape[2]
    assert S == (14 if window is None else 6)
    assert tuple(tc["layers"]["mamba"]["h"].shape) == (2, 2, 2, 2, 64, 16)


def test_repeated_tap_outside_a_scan_is_refused():
    """A tap name applied twice outside a scan would drop the first call
    site's capture (the JAX package overwrites it): the port refuses."""
    tp = Tapper("capture")
    x, w = torch.randn(2, 3, 4), torch.randn(4, 5)
    tp.dense("~shared/w", x, w)
    with pytest.raises(ValueError, match="applied twice outside a scan"):
        tp.dense("~shared/w", x, w)


@pytest.mark.parametrize("arch", ("xlstm-125m", ARCH))
def test_entry_points_run_the_recurrent_archs(arch, capsys):
    """``launch.train`` (reduced, on the CPU: two ``auto`` steps, finite
    losses in the JSON summary) and ``launch.serve`` (reduced, the prompt
    prefilled a token at a time) take both ids."""
    from repro_torch.launch import serve, train
    train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "8", "--strategy", "auto"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    summary = json.loads(last)["train_summary"]
    assert summary["arch"] == arch and summary["steps"] == 2
    assert all(np.isfinite(summary["losses_last_segment"]))
    serve.main(["--arch", arch, "--device", "cpu", "--n-requests", "2",
                "--batch", "2", "--gen", "3", "--prompt-len", "4"])
    assert "served 2 requests" in capsys.readouterr().out


def test_bf16_decode_rule_holds_in_both_packages():
    """The bf16 decode-equals-forward rule ``chip_smoke.py`` holds this
    family to on the card (served logits within twice the bf16 forward's
    distance from the f32 forward, plus 2^-8 of the largest) holds for
    the JAX package's own decode too, on the same reduced bf16 weights."""
    rec = rp.check_bf16_decode_against_f32(ARCH)
    assert sorted(rec) == ["jax", "port"]
