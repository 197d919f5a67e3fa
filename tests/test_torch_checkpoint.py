"""The port's Checkpointer (``repro_torch.checkpoint``): atomic roundtrip,
corruption detection, keep-k, async, ``DPTrainState``, held to the JAX
package's ``tests/test_checkpoint.py`` cases, plus what is the port's
own (bf16 leaves by their bit pattern, an async save's error surfacing at
``wait``) and the layout both packages share: an f32 checkpoint written
by one package restores, bit for bit, through the other's
``Checkpointer.restore``."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro_torch.checkpoint import (Checkpointer,  # noqa: E402
                                    CheckpointCorrupt, DPTrainState)
from repro_torch.tree import get_subtree, leaf_paths  # noqa: E402


@pytest.fixture
def tree():
    return {"a": {"w": torch.arange(12.0).reshape(3, 4)},
            "b": torch.ones((5,), dtype=torch.int32),
            "h": torch.linspace(-3, 3, 7).to(torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}


def _leaves(tree):
    return [get_subtree(tree, p) for p in leaf_paths(tree)]


def _assert_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


def test_roundtrip(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tree)
    got, step = ck.restore(tree)
    assert step == 3
    _assert_equal(got, tree)


def test_bf16_stored_by_bits(tmp_path, tree):
    """numpy has no bf16: the leaf is stored as its int16 bits and named
    bfloat16 in the manifest, and comes back bit for bit."""
    ck = Checkpointer(str(tmp_path))
    path = ck.save(1, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["['h']"]["dtype"] == "bfloat16"
    assert leaves["['a']['w']"]["dtype"] == "float32"
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["['h']"].dtype == np.int16
        np.testing.assert_array_equal(
            data["['h']"], tree["h"].view(torch.int16).numpy())
    got, _ = ck.restore(tree)
    assert torch.equal(got["h"].view(torch.int16), tree["h"].view(
        torch.int16))


def test_latest_pointer_and_keep(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert ck.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2


def _bump_first_leaf(path):
    f = os.path.join(path, "arrays.npz")
    with np.load(f) as d:
        data = dict(d)
    key = sorted(data)[0]
    data[key] = data[key] + 1
    np.savez(f, **data)


def test_corruption_detected(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    _bump_first_leaf(ck.save(1, tree))
    with pytest.raises(CheckpointCorrupt, match="CRC"):
        ck.restore(tree)
    ck.restore(tree, verify=False)      # opt-out works


def test_async_save(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(7, tree)
    ck.wait()
    assert ck.latest_step() == 7
    _assert_equal(ck.restore(tree)[0], tree)


def test_async_save_error_surfaces_at_wait(tmp_path, tree, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    ck.save_async(1, tree)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                            # reported once


def test_interrupted_write_is_invisible(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    os.makedirs(os.path.join(tmp_path, "step_000000002.tmp"))
    assert ck.latest_step() == 1
    assert ck.restore(tree)[1] == 1


def test_truncated_arrays_falls_back_to_previous(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, tree)
    ck.save(2, {**tree, "a": {"w": tree["a"]["w"] + 1}})
    f = os.path.join(tmp_path, "step_000000002", "arrays.npz")
    with open(f, "rb") as fh:
        raw = fh.read()
    with open(f, "wb") as fh:
        fh.write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointCorrupt):
        ck.restore(tree, fallback=False)
    got, step = ck.restore(tree, fallback=True)
    assert step == 1
    _assert_equal(got, tree)
    with open(os.path.join(tmp_path, "step_000000001", "arrays.npz"),
              "wb") as fh:
        fh.write(b"not a zip")
    with pytest.raises(CheckpointCorrupt):
        ck.restore(tree, fallback=True)


def test_train_state_roundtrip(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    opt = {"m": torch.zeros((3, 4)), "step": torch.tensor(5,
                                                         dtype=torch.int32)}
    clip = {"prev_norms_sq": np.arange(4.0, dtype=np.float32),
            "budget_q": np.float64(0.7)}
    st = DPTrainState(
        params=tree, opt=opt, clip_state=clip,
        ledger={"steps": 42, "q": 0.01, "sigma": 1.1, "orders": [2.0, 4.0]},
        plan_fingerprint="abc123", monitor={"ema": 0.2}, run_seed=7,
        mesh_axes=(("data", 8),), noise_device="cuda")
    ck.save_state(3, st)
    got, step = ck.restore_state(tree, opt)
    assert step == 3
    np.testing.assert_array_equal(got.clip_state["prev_norms_sq"],
                                  clip["prev_norms_sq"])
    assert got.clip_state["prev_norms_sq"].dtype == np.float32
    np.testing.assert_array_equal(got.clip_state["budget_q"],
                                  clip["budget_q"])
    assert got.ledger == st.ledger
    assert (got.plan_fingerprint, got.monitor, got.run_seed,
            got.mesh_axes, got.noise_device) == (
        "abc123", {"ema": 0.2}, 7, (("data", 8),), "cuda")
    _assert_equal(got.params, tree)
    _assert_equal(got.opt, opt)


def test_corrupt_meta_detected_and_fallback(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    opt = {"v": torch.zeros(2)}
    for s in (1, 2):
        ck.save_state(s, DPTrainState(
            params=tree, opt=opt,
            ledger={"steps": s, "q": 0.1, "sigma": 1.0, "orders": [2.0]}))
    mf = os.path.join(tmp_path, "step_000000002", "meta.json")
    with open(mf) as fh:
        meta = json.load(fh)
    meta["ledger"]["steps"] = 0
    with open(mf, "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(CheckpointCorrupt, match="meta"):
        ck.read_meta(2)
    with pytest.raises(CheckpointCorrupt):
        ck.restore_state(tree, opt, fallback=False)
    got, step = ck.restore_state(tree, opt, fallback=True)
    assert step == 1 and got.ledger["steps"] == 1


def test_state_async_save(tmp_path, tree):
    ck = Checkpointer(str(tmp_path))
    st = DPTrainState(params=tree, opt={"v": torch.ones(3)},
                      clip_state={"budgets": np.ones(2, np.float32)},
                      run_seed=0)
    ck.save_state_async(4, st)
    ck.wait()
    got, step = ck.restore_state(tree, {"v": torch.ones(3)})
    assert step == 4 and got.run_seed == 0 and got.noise_device is None
    np.testing.assert_array_equal(got.clip_state["budgets"], np.ones(2))


# ---------------------------------------------------------------------------
# The layout both packages share (f32 and integer leaves)


def _numpy_tree():
    rng = np.random.RandomState(0)
    return {"params": {"conv0": {"w": rng.randn(4, 3, 3, 3).astype(
                np.float32), "b": rng.randn(4).astype(np.float32)},
            "fc": {"w": rng.randn(6, 2).astype(np.float32)}},
            "opt": {"m": {"fc": {"w": rng.randn(6, 2).astype(np.float32)}},
                    "step": np.asarray(3, np.int32)}}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_port_checkpoint_restores_in_jax(tmp_path):
    want = _numpy_tree()
    Checkpointer(str(tmp_path)).save(5, _map(torch.from_numpy, want))
    got, step = JCheckpointer(str(tmp_path)).restore(_map(jnp.asarray,
                                                          want))
    assert step == 5
    flat_got = _map(np.asarray, got)
    for p in leaf_paths(want):
        a, b = get_subtree(flat_got, p), get_subtree(want, p)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_restores_in_port(tmp_path):
    want = _numpy_tree()
    JCheckpointer(str(tmp_path)).save(6, _map(jnp.asarray, want))
    like = _map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        a).dtype), want)
    got, step = Checkpointer(str(tmp_path)).restore(like)
    assert step == 6
    for p in leaf_paths(want):
        a, b = get_subtree(got, p), get_subtree(want, p)
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)
