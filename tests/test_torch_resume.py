"""Kill-and-resume equivalence in the port, and its training CLI.

The port proves about itself what ``tests/test_resume_equivalence.py``
proves about the JAX package: with the deterministic noise stream (step
n's generator seeded from ``(run_seed, n)``) and a checkpointed
``DPTrainState`` (params, optimizer, cross-step clip state, ledger, plan
fingerprint), a run killed at any step (mid-checkpoint-write and during
the stale bootstrap included) resumes to bit-identical params, optimizer
state and ledger versus a run that never died.  On the CPU, at σ = 0.9,
for the toy CNN under flat / per_layer (auto budgets) / stale clipping and
for the port's copy of the suite's ``toy_model`` (conv + embedding +
scanned dense + scale + head), held here against the JAX package's.

``repro_torch.launch.train --device cpu`` runs end to end on reduced
AlexNet and Llama-3.2-1B configs: an uninterrupted run and one that fails
at step 3 and restarts from its step-1 checkpoint end on bitwise equal
checkpoints.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro_torch.checkpoint import (Checkpointer,  # noqa: E402
                                    CheckpointCorrupt, DPTrainState)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ClipPolicy, DPConfig,  # noqa: E402
                              PrivacyAccountant, PrivacyEngine, costmodel,
                              clipped_grad_sum)
from repro_torch.core.privacy import LedgerMismatch  # noqa: E402
from repro_torch.core.tapper import scan_with_taps  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models.cnn import CNN, toy_cnn_config  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import ChaosMonkey, run_with_restarts  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402

RUN_SEED = 7
NOISE = 0.9
STEPS = 5


class KillSignal(Exception):
    """A process death: not in run_with_restarts' catch set, so it unwinds
    the whole 'process' like a preemption would."""


def _leaves(tree):
    return [get_subtree(tree, p) for p in leaf_paths(tree)]


def _bitwise_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _batch_fn(batch):
    """Deterministic per-step batch stream (a pure function of step)."""
    def fn(step):
        return {k: torch.roll(v, step, 0) for k, v in batch.items()}
    return fn


# ---------------------------------------------------------------------------
# Models: the toy CNN, and the port's copy of the suite's toy_model


def _toy_cnn():
    m = CNN(toy_cnn_config(2, 2.0, c0=8, img=16))
    params, _ = m.init(0, device="cpu")
    g = torch.Generator().manual_seed(3)
    batch = {"img": torch.randn(4, 3, 16, 16, generator=g),
             "label": torch.randint(0, 10, (4,), generator=g)}
    return m.apply, params, batch


def toy_apply(params, batch, tp):
    """``tests/conftest.py``'s toy_model in the port: conv + embedding +
    scanned (dense, GELU, LayerNorm, scale) blocks + dense head."""
    img, ids, y = batch["img"], batch["ids"], batch["label"]
    h = tp.conv("conv1", img, params["conv1"]["w"], params["conv1"]["b"],
                stride=2, padding=1)
    h = torch.relu(h)
    h = h.reshape(h.shape[0], -1)[:, :125]
    e = tp.embed("emb", params["emb"]["emb"], ids)

    def block(stp, carry, p_l):
        x = stp.dense("fc", carry, p_l["fc"]["w"], p_l["fc"]["b"])
        x = F.gelu(x, approximate="tanh")        # jax.nn.gelu's default
        mu = x.mean(-1, keepdim=True)
        x = (x - mu) / torch.sqrt(x.var(-1, keepdim=True, unbiased=False)
                                  + 1e-5)
        return stp.scale("nrm", x, p_l["nrm"]["g"], p_l["nrm"]["b"])

    e = scan_with_taps(tp, "blocks", block, e, params["blocks"])
    feat = torch.cat([h, e.mean(dim=1)], dim=-1)
    logits = tp.dense("head", feat, params["head"]["w"])
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, y.long()[:, None])[:, 0]


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def port_toy(toy_model):
    """The port's toy_model: the suite's numpy params and batch."""
    _, params, batch = toy_model
    return toy_apply, _to_torch(params), _to_torch(batch)


@pytest.mark.parametrize("strategy", ["bk", "auto"])
def test_port_toy_model_matches_reference(toy_model, port_toy, strategy):
    """Losses, per-example norms and clipped sums of the port's toy_model
    equal the JAX package's (rtol 1e-5 / 1e-4, atol 1e-6)."""
    japply, jparams, jbatch = toy_model
    jl, jsum, jn = jcore.clipped_grad_sum(japply, jparams, jbatch,
                                          l2_clip=0.1, strategy=strategy)
    tl, tsum, tn = clipped_grad_sum(*port_toy, l2_clip=0.1,
                                    strategy=strategy)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-4)
    jsum = jax.tree.map(np.asarray, jsum)
    for p in leaf_paths(jsum):
        np.testing.assert_allclose(get_subtree(tsum, p).numpy(),
                                   get_subtree(jsum, p), rtol=1e-4,
                                   atol=1e-6, err_msg=str(p))


# ---------------------------------------------------------------------------
# The differential lane: killed-at-step-k == never killed, bitwise


def _engine(model, clip_mode="flat"):
    apply_fn, params, batch0 = model
    clip = (ClipPolicy(mode="per_layer", budgets="auto")
            if clip_mode == "per_layer_auto" else ClipPolicy(mode=clip_mode))
    dp = DPConfig(l2_clip=0.1, noise_multiplier=NOISE, clipping=clip)
    acct = PrivacyAccountant(sampling_rate=1 / 128, noise_multiplier=NOISE)
    return PrivacyEngine(apply_fn, params, batch0, dp=dp, lr=1e-2,
                         accountant=acct, run_seed=RUN_SEED, device="cpu")


def _drive(engine, params0, batch_fn, steps=STEPS, ckpt=None, kill_at=None,
           chaos=None, ckpt_every=1):
    """One process lifetime: restore a DPTrainState if a checkpoint
    exists, then step to ``steps`` on the deterministic noise stream,
    dying with KillSignal just before executing ``kill_at``."""
    params, opt, start = params0, adamw_init(params0), 0
    if ckpt is not None and ckpt.latest_step() is not None:
        st, at = ckpt.restore_state(params, opt)
        params, opt = st.params, st.opt
        engine.load_clip_state(st.clip_state)
        engine.accountant.load_state_dict(st.ledger)
        start = at + 1
    else:
        engine.reset_clip_state()
        engine.accountant.reset()
    for step in range(start, steps):
        if kill_at is not None and step == kill_at:
            raise KillSignal(f"killed before step {step}")
        if chaos is not None:
            chaos.maybe_fail(step)
        params, opt, _, _ = engine.private_step(params, opt, batch_fn(step),
                                                step=step)
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save_state(step, DPTrainState(
                params=params, opt=opt,
                clip_state=engine.clip_state_dict(),
                ledger=engine.accountant.state_dict(),
                plan_fingerprint=engine.fingerprint(), run_seed=RUN_SEED,
                noise_device=engine.device.type))
    return params, opt


@pytest.mark.parametrize("model,clip_mode,kill_at", [
    ("cnn", "flat", 1),
    ("cnn", "flat", 3),
    ("cnn", "stale", 0),            # killed during the stale bootstrap
    ("cnn", "stale", 1),            # killed right after it
    ("cnn", "per_layer_auto", 2),   # tracked budget quantiles live
    ("toy_model", "flat", 2),
])
def test_kill_and_resume_bit_identical(port_toy, tmp_path, model, clip_mode,
                                       kill_at):
    m = _toy_cnn() if model == "cnn" else port_toy
    params0, batch_fn = m[1], _batch_fn(m[2])
    ref_engine = _engine(m, clip_mode)
    ref_p, ref_o = _drive(ref_engine, params0, batch_fn)
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(KillSignal):
        _drive(_engine(m, clip_mode), params0, batch_fn, ckpt=ck,
               kill_at=kill_at)
    res_engine = _engine(m, clip_mode)
    got_p, got_o = _drive(res_engine, params0, batch_fn, ckpt=ck)
    assert _bitwise_equal(ref_p, got_p)
    assert _bitwise_equal(ref_o, got_o)
    assert res_engine.accountant.state_dict() == \
        ref_engine.accountant.state_dict()
    assert res_engine.accountant.steps == STEPS


def test_noise_stream_is_pure_function_of_seed_and_step():
    m = _toy_cnn()
    e1, e2 = _engine(m), _engine(m)

    def draw(e, step):
        return torch.randn(16, generator=e.noise_key(step))

    for step in (0, 3, 1 << 20):
        assert torch.equal(draw(e1, step), draw(e2, step))
    assert not torch.equal(draw(e1, 3), draw(e1, 4))
    e3 = PrivacyEngine(m[0], m[1], m[2], dp=DPConfig(l2_clip=0.1),
                       run_seed=RUN_SEED + 1, device="cpu")
    assert not torch.equal(draw(e1, 3), draw(e3, 3))


@pytest.mark.parametrize("torn", ["payload", "pointer"])
def test_kill_mid_checkpoint_write(tmp_path, monkeypatch, torn):
    """Die inside Checkpointer.save, before the payload rename (the step
    stays invisible) or before the LATEST rename (the completed directory
    is still found); either way the resumed run is bit-identical."""
    m = _toy_cnn()
    params0, batch_fn = m[1], _batch_fn(m[2])
    ref_p, ref_o = _drive(_engine(m), params0, batch_fn)
    ck = Checkpointer(str(tmp_path))
    import repro_torch.checkpoint.checkpointer as ckpt_mod
    real_rename = os.rename

    def dying_rename(src, dst):
        if torn == "payload" and "step_000000002" in src \
                and src.endswith(".tmp"):
            raise KillSignal("killed before the payload rename")
        if torn == "pointer" and src.endswith("LATEST.tmp"):
            with open(src) as f:
                if f.read().strip() == "step_000000002":
                    raise KillSignal("killed before the LATEST rename")
        return real_rename(src, dst)

    monkeypatch.setattr(ckpt_mod.os, "rename", dying_rename)
    with pytest.raises(KillSignal):
        _drive(_engine(m), params0, batch_fn, ckpt=ck)
    monkeypatch.undo()
    assert ck.available_steps()[0] == (1 if torn == "payload" else 2)
    got_p, got_o = _drive(_engine(m), params0, batch_fn, ckpt=ck)
    assert _bitwise_equal(ref_p, got_p)
    assert _bitwise_equal(ref_o, got_o)


def test_resume_falls_back_past_corrupt_checkpoint(tmp_path):
    m = _toy_cnn()
    params0, batch_fn = m[1], _batch_fn(m[2])
    ref_p, _ = _drive(_engine(m), params0, batch_fn)
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(KillSignal):
        _drive(_engine(m), params0, batch_fn, ckpt=ck, kill_at=4)
    f = os.path.join(str(tmp_path), "step_000000003", "arrays.npz")
    with open(f, "rb") as fh:
        data = fh.read()
    with open(f, "wb") as fh:
        fh.write(data[: len(data) // 2])
    with pytest.raises(CheckpointCorrupt):
        ck.restore_state(params0, adamw_init(params0), fallback=False)
    got_p, _ = _drive(_engine(m), params0, batch_fn, ckpt=ck)
    assert _bitwise_equal(ref_p, got_p)


def test_orchestrated_chaos_run_matches_reference(tmp_path):
    """ChaosMonkey trips recoverable WorkerFailures, run_with_restarts
    re-enters the segment, the segment restores its DPTrainState: the run
    equals the undisturbed one bit for bit, the ledger counted once."""
    m = _toy_cnn()
    params0, batch_fn = m[1], _batch_fn(m[2])
    ref_engine = _engine(m, "stale")
    ref_p, _ = _drive(ref_engine, params0, batch_fn)
    ck = Checkpointer(str(tmp_path))
    engine = _engine(m, "stale")
    chaos = ChaosMonkey(fail_at_steps=[1, 3])

    def segment(restart_count):
        return _drive(engine, params0, batch_fn, ckpt=ck, chaos=chaos)

    (got_p, _), restarts = run_with_restarts(segment, max_restarts=5)
    assert restarts == 2 and chaos.tripped == 2
    assert _bitwise_equal(ref_p, got_p)
    assert engine.accountant.state_dict() == \
        ref_engine.accountant.state_dict()


def test_resume_refuses_foreign_ledger(tmp_path):
    m = _toy_cnn()
    params0, batch_fn = m[1], _batch_fn(m[2])
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(KillSignal):
        _drive(_engine(m), params0, batch_fn, ckpt=ck, kill_at=3)
    engine = _engine(m)
    engine.accountant.sigma = NOISE * 2   # a changed mechanism
    with pytest.raises(LedgerMismatch, match="sigma"):
        _drive(engine, params0, batch_fn, ckpt=ck)


# ---------------------------------------------------------------------------
# The training CLI on the CPU


CLI_CASES = {
    "alexnet_flat": ["--arch", "alexnet", "--batch", "4", "--strategy",
                     "auto"],
    "alexnet_stale": ["--arch", "alexnet", "--batch", "4", "--strategy",
                      "auto", "--clip-mode", "stale"],
    "llama_flat": ["--arch", "llama3.2-1b", "--batch", "2", "--seq", "16",
                   "--strategy", "auto", "--attn-impl", "flash"],
}


def _cli(tmp_path, name, extra, steps=6):
    d = str(tmp_path / name)
    losses = cli.main(CLI_CASES[extra] + [
        "--device", "cpu", "--steps", str(steps), "--noise", "1.0",
        "--ckpt-dir", d, "--ckpt-every", "2"] + (
        ["--fail-at", "3"] if name == "killed" else []))
    return d, losses


def _final(d, step):
    """(arrays, meta) of the checkpoint a run saved last."""
    ck = Checkpointer(d)
    assert ck.latest_step() == step
    with np.load(os.path.join(d, f"step_{step:09d}", "arrays.npz")) as z:
        arrays = dict(z)
    return arrays, ck.read_meta(step)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_kill_and_resume_bitwise(tmp_path, capsys, case):
    """``launch.train --device cpu``: a run that fails at step 3 and
    restarts from its step-1 checkpoint ends on the same params,
    optimizer state, clip state and ledger, bit for bit, as one that ran
    straight through."""
    steps = 4 if case.startswith("llama") else 6
    straight, _ = _cli(tmp_path, "straight", case, steps)
    killed, losses = _cli(tmp_path, "killed", case, steps)
    out = capsys.readouterr()
    assert "[restore] resuming from step 2" in out.out
    assert len(losses) == steps - 2
    a, ma = _final(straight, steps - 1)
    b, mb = _final(killed, steps - 1)
    assert sorted(a) == sorted(b)
    assert any(k.startswith("['params']") for k in a)
    assert any(k.startswith("['opt']") for k in a)
    if "stale" in case:
        assert "['clip']['prev_norms_sq']" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype
    assert ma["ledger"] == mb["ledger"] and ma["ledger"]["steps"] == steps
    assert ma["noise_device"] == "cpu" and ma["run_seed"] == 0
    assert ma["plan_fingerprint"] == mb["plan_fingerprint"] != ""


@pytest.mark.parametrize("foreign", ["run_seed", "fingerprint",
                                     "noise_device"])
def test_cli_refuses_foreign_checkpoint(tmp_path, foreign):
    """A checkpoint of another noise stream (seed or generator device) or
    another plan fingerprint (here: another clipping mode) is refused."""
    d = str(tmp_path / "ck")
    base = CLI_CASES["alexnet_flat"] + ["--device", "cpu", "--ckpt-dir", d,
                                        "--ckpt-every", "1"]
    cli.main(base + ["--steps", "2"])
    extra = {"run_seed": ["--run-seed", "5"],
             "fingerprint": ["--clip-mode", "stale"],
             "noise_device": []}[foreign]
    if foreign == "noise_device":
        # the same state, as if its noise had been drawn on a card
        ck = Checkpointer(d)
        params, _ = CNN(get_config("alexnet").reduced()).init(0,
                                                              device="cpu")
        st, at = ck.restore_state(params, adamw_init(params))
        st.noise_device = "cuda"
        ck.save_state(at, st)
    with pytest.raises(SystemExit, match=foreign.split("_")[0]):
        cli.main(base + ["--steps", "3"] + extra)



def test_cli_plan_store_skips_the_probe(tmp_path, monkeypatch, capsys):
    """``--plan-json``: the first run writes the plan store, a second
    process-like run (fresh caches) loads it and never probes."""
    path = str(tmp_path / "plans.json")
    args = CLI_CASES["alexnet_flat"] + ["--device", "cpu", "--steps", "1",
                                        "--plan-json", path]
    cli.main(args)
    assert os.path.exists(path)
    costmodel.clear_plan_cache()
    costmodel.clear_plan_store()

    def no_probe(*a, **k):
        raise AssertionError("planned by probing despite the plan store")

    monkeypatch.setattr(costmodel, "probe", no_probe)
    try:
        cli.main(args)
    finally:
        costmodel.clear_plan_store()
    assert "[plan] loaded 1 plan(s)" in capsys.readouterr().out


def test_cli_restores_global_flags_and_rejects_unserved():
    before = torch.are_deterministic_algorithms_enabled()
    cli.main(CLI_CASES["alexnet_flat"] + ["--device", "cpu", "--steps",
                                          "1"])
    assert torch.are_deterministic_algorithms_enabled() == before
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(["--device", "cpu", "--mesh", "data:2"])
