"""The step's in-place updates: the clipped sum noised and divided in
place, and the optimizer state donated (``PrivacyEngine(donate_opt=True)``,
``sgdm_update`` / ``adamw_update(inplace=True)``).

Each gives bitwise the values of its functional form; ``donate_opt``
updates the moments given to the step in place (one copy of them a step,
the memory that lets the full-width DeepSeek-V3 MoE layer at 64 routed
experts train on ``model:2``); the functional form leaves its inputs
alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DPConfig, PrivacyEngine, add_noise  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.cnn import CNN, toy_cnn_config  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update, sgdm_init,  # noqa
                               sgdm_update)
from repro_torch.tree import get_subtree, leaf_paths, tree_map  # noqa: E402


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.from_numpy(
                rng.standard_normal((7, 5)).astype(np.float32))},
            "b": {"w": torch.from_numpy(
                rng.standard_normal((11,)).astype(np.float32)).to(
                    torch.bfloat16)}}


def _bitwise(x, y):
    return all(torch.equal(get_subtree(x, q), get_subtree(y, q))
               for q in leaf_paths(x))


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("name", ["sgdm", "adamw"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_inplace_update_is_bitwise_the_functional_one(name, weight_decay):
    init, update = {"sgdm": (sgdm_init, sgdm_update),
                    "adamw": (adamw_init, adamw_update)}[name]
    params = _tree(0)
    fun_p, ip_p = params, params
    fun_s, ip_s = init(params), init(params)
    for step in range(3):
        grads = _tree(step + 1)
        fun_p, fun_s = update(grads, fun_s, fun_p, lr=1e-2,
                              weight_decay=weight_decay)
        before = _copy(ip_s)
        moments = [get_subtree(ip_s, q) for q in leaf_paths(ip_s)
                   if q[-1] != "step"]
        ip_p, new = update(grads, ip_s, ip_p, lr=1e-2,
                           weight_decay=weight_decay, inplace=True)
        # the moments given were updated in place, the step count not
        assert all(any(m is get_subtree(new, q) for q in leaf_paths(new))
                   for m in moments)
        assert torch.equal(ip_s["step"], before["step"])
        ip_s = new
    assert _bitwise(fun_p, ip_p)
    assert _bitwise(fun_s, ip_s)


def test_functional_update_leaves_the_state_alone():
    params = _tree(0)
    state = sgdm_init(params)
    state["mom"] = _tree(3)
    state["mom"]["b"]["w"] = state["mom"]["b"]["w"].float()
    kept = _copy(state)
    sgdm_update(_tree(1), state, params, lr=1e-2)
    assert _bitwise(state, kept)


def test_add_noise_takes_f32_leaves_in_place():
    tree = _tree(0)
    tree["b"]["w"] = tree["b"]["w"].clone()
    f32, bf16 = tree["a"]["w"], tree["b"]["w"]
    want = (f32.clone() + 0.5 * torch.randn(
        f32.shape, generator=torch.Generator().manual_seed(4)))
    out = add_noise(tree, torch.Generator().manual_seed(4), 1.0, 0.5)
    assert out["a"]["w"] is f32 and torch.equal(f32, want)
    # a leaf in another dtype is noised in f32 and cast: a new tensor
    assert out["b"]["w"] is not bf16
    assert out["b"]["w"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def toy():
    cfg = toy_cnn_config(2, 2.0, c0=4, img=16)
    m = CNN(cfg)
    params, _ = m.init(0, device="cpu")
    ds = tsyn.SyntheticImageDataset(16, 10, n_examples=16)
    batches = [{k: torch.from_numpy(v) for k, v in
                ds.batch(range(4 * s, 4 * s + 4)).items()} for s in range(3)]
    return m, params, batches


@pytest.mark.parametrize("optimizer,init", [("sgdm", sgdm_init),
                                            ("adamw", adamw_init)])
def test_donated_step_is_bitwise_the_plain_one(toy, optimizer, init):
    m, params, batches = toy
    dp = DPConfig(strategy="bk", noise_multiplier=1.3, l2_clip=0.5)
    out = {}
    for donate in (False, True):
        eng = PrivacyEngine(m.apply, params, batches[0], dp, device="cpu",
                            run_seed=7, optimizer=optimizer, lr=1e-2,
                            weight_decay=0.01, donate_opt=donate)
        p, opt = params, init(params)
        for s, b in enumerate(batches):
            given = opt
            p, opt, loss, _ = eng.private_step(p, opt, b, step=s)
            # donated: the moments given to the step are the ones it
            # returns, updated; else new tensors
            mine = [get_subtree(given, q) for q in leaf_paths(given)
                    if q[-1] != "step"]
            theirs = [get_subtree(opt, q) for q in leaf_paths(opt)
                      if q[-1] != "step"]
            assert all((a is b_) == donate for a, b_ in zip(mine, theirs))
        out[donate] = (p, opt, float(loss))
    assert _bitwise(out[False][0], out[True][0])
    assert _bitwise(out[False][1], out[True][1])
    assert out[False][2] == out[True][2]
    # the caller's params are never written
    fresh, _ = m.init(0, device="cpu")
    assert _bitwise(params, fresh)


def test_donate_opt_takes_a_named_optimizer(toy):
    m, params, batches = toy
    with pytest.raises(ValueError, match="named optimizer"):
        PrivacyEngine(m.apply, params, batches[0], DPConfig(), device="cpu",
                      optimizer=sgdm_update, donate_opt=True)
