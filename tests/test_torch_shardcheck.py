"""The static verifier's sharding pass (``repro_torch.analysis.
shardcheck``) and ``dpcheck --mesh``.

The step of a ``data:8`` engine is traced as ranks 0 and 7 of an
in-process fake group of 8 (``launch.mesh.fake_world``: no processes),
the port's stand-in for the JAX package's forced host devices.  The
clean lanes (reduced AlexNet under flat, per_layer with auto budgets and
stale; the suite's toy model) verify clean; each mutant of the sharded
step is flagged with its own finding:

  * noise added before the all-reduce (d times the variance):
    ``noise_before_sync``;
  * a rank-dependent noise seed: ``noise_seed_rank_dependent``;
  * one leaf left out of the all-reduce: ``grad_sync_missing``;
  * the local batch as the divisor: ``divisor_not_global``;
  * local budget quantiles (per-layer norms not gathered over the
    group): ``budget_stats_local``.

Also: the plan's collective bytes against ``coll_bytes_warn``
(``coll_bytes_high``), and fault F5's repair — the taint findings are
filtered by the backward slice of *every* released leaf (before, the
traced outputs came back flat and only the first two leaves were kept,
so an unclipped contribution to a later layer verified clean).
"""
import pytest

torch = pytest.importorskip("torch")

import torch_shard_worker as sw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ClipPolicy, DPConfig,  # noqa: E402
                              PrivacyEngine, clipping, costmodel, kinds)
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.launch import dpcheck  # noqa: E402
from repro_torch.launch.train import make_batch_fn, to_device  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.tree import get_subtree, leaf_paths, set_subtree  # noqa

CFG = get_config("alexnet").reduced()
MODEL = build_model(CFG)
PARAMS, _ = MODEL.init(0, device="cpu")
BATCH = to_device(make_batch_fn(CFG, 8, 64)(0), "cpu")


def _engine(mode="flat", mesh="data:8", noise=0.8):
    costmodel.clear_plan_cache()
    budgets = "auto" if mode == "per_layer" else "uniform"
    dp = DPConfig(l2_clip=1.0, noise_multiplier=noise, strategy="auto",
                  clipping=ClipPolicy(mode=mode, budgets=budgets))
    return PrivacyEngine(MODEL.apply, PARAMS, BATCH, dp=dp, run_seed=0,
                         device="cpu", mesh=mesh, calibration="analytic")


def _codes(report):
    return sorted({f.code for f in report.errors})


@pytest.mark.parametrize("mode", ("flat", "per_layer", "stale"))
def test_clean_lanes_data8(mode):
    report = _engine(mode).verify()
    assert report.ok, report.summary()
    assert not report.warnings, report.summary()
    for section in ("taint", "noise", "sharding", "plan"):
        assert section in report.checked
    assert "rank(s) [0, 7] of 8" in report.checked["sharding"]
    assert "mesh=data=8" in report.target


def test_clean_toy_model_data4(toy_model):
    """The suite's toy model (conv, embedding, scanned dense and scale
    layers, head) at B/d = 2."""
    _, jp, jb = toy_model
    tp, tb = sw.to_torch(jp), sw.to_torch(jb)
    batch = {k: torch.cat([v, v]) for k, v in tb.items()}
    report = sw.make_engine(tp, batch, mode="stale", sigma=1.3,
                            mesh="data:4").verify()
    assert report.ok, report.summary()


def _noise_first(gsum, key, cfg, shard=None):
    if key is not None and cfg.noise_multiplier > 0:
        gsum = clipping.add_noise(gsum, key, cfg.noise_multiplier,
                                  cfg.l2_clip)
    return gsum if shard is None else clipping.sync_grads(gsum, shard)


def _rank_seed(gsum, key, cfg, shard=None):
    gsum = clipping.sync_grads(gsum, shard)
    g = torch.Generator(device="cpu")
    g.manual_seed(key.initial_seed() + shard.rank)
    return clipping.add_noise(gsum, g, cfg.noise_multiplier, cfg.l2_clip)


def _skip_leaf(gsum, shard):
    out = gsum
    for p in leaf_paths(gsum)[1:]:
        out = set_subtree(out, p, clipping._psum(get_subtree(gsum, p),
                                                 shard))
    return out


_real_dp_gradient = tengine.dp_gradient


def _local_divisor(*a, **k):
    shard = k.get("shard")
    if shard is not None:
        k["denom"] = next(iter(a[2].values())).shape[0] // shard.size
    return _real_dp_gradient(*a, **k)


MUTANTS = {
    "noise_before_sync": ("flat", clipping, "release_sum", _noise_first),
    "noise_seed_rank_dependent": ("flat", clipping, "release_sum",
                                  _rank_seed),
    "grad_sync_missing": ("flat", clipping, "sync_grads", _skip_leaf),
    "divisor_not_global": ("flat", tengine, "dp_gradient", _local_divisor),
    "budget_stats_local": ("per_layer", clipping, "gather_examples",
                           lambda t, shard: t),
}


@pytest.mark.parametrize("code", list(MUTANTS))
def test_sharded_mutant_is_flagged(monkeypatch, code):
    mode, module, name, fn = MUTANTS[code]
    eng = _engine(mode)
    monkeypatch.setattr(module, name, fn)
    codes = _codes(eng.verify())
    assert code in codes, codes


def test_mutants_do_not_fire_off_mesh(monkeypatch):
    """With no mesh the sharded step's helpers are not on the path: a
    single-device step verifies clean under the same patches."""
    for mode, module, name, fn in MUTANTS.values():
        if name == "release_sum":
            continue
        monkeypatch.setattr(module, name, fn)
    assert _engine(mesh=None).verify().ok


def test_coll_bytes_high_warns():
    """A threshold under the plan's predicted bytes warns (the clean
    lanes, with no threshold, have no warning)."""
    eng = _engine("stale")
    report = eng.verify(coll_bytes_warn=1)
    assert "coll_bytes_high" in {f.code for f in report.warnings}
    assert report.ok


def test_unclipped_late_layer_is_caught(monkeypatch):
    """Fault F5: an unclipped contribution to the last layer (fc0, whose
    leaves are not the first two released outputs) must be flagged."""
    real = kinds.apply_kind

    def unclipped_fc0(op, meta, *a, **k):
        if op == "contrib" and meta.path == ("fc0",):
            k["weights"] = torch.ones_like(k["weights"])
        return real(op, meta, *a, **k)

    for mesh in (None, "data:8"):
        eng = _engine(mesh=mesh)
        assert eng.plan().sum_methods()["fc0"] == "contrib"
        monkeypatch.setattr(kinds, "apply_kind", unclipped_fc0)
        assert "unclipped_batch_reduction" in _codes(eng.verify())
        monkeypatch.setattr(kinds, "apply_kind", real)


def test_dpcheck_mesh_lanes_in_process(capsys):
    assert dpcheck.main(["--archs", "alexnet", "--mesh", "none", "data:8",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS  alexnet clip=flat mesh=data:8" in out
    assert "2/2 lanes clean" in out
    with pytest.raises(SystemExit, match="not divisible"):
        dpcheck.main(["--archs", "alexnet", "--mesh", "data:3",
                      "--device", "cpu"])
