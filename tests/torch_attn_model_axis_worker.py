"""Ranks of the port's qk-norm and enc-dec model-axis tests (gloo on
the CPU).

Not collected by pytest.  ``tests/test_torch_attn_model_axis.py`` spawns
one ``data:2,model:2`` world (4 ranks) and one ``model:2`` world (2
ranks), each once per module, through :func:`start` / :func:`join`;
every rank runs all the lanes of its world (:func:`lanes_4`,
:func:`lanes_2`) and saves what it got to ``rank<r>.pt`` for the parent
to compare.  The 2-rank world also computes the single-device
references, each rank half of them.  It imports no JAX: the parent
computes the JAX package's references meanwhile.  The lane helpers
(``engine``, ``run_steps``) are ``tests/torch_model_axis_worker.py``'s,
the spawning ``tests/torch_moe_model_axis_worker.py``'s.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

import torch_model_axis_worker as mw
import torch_moe_model_axis_worker as xw

ARCHS = ("chameleon-34b", "seamless-m4t-large-v2")
# Every strategy but multi under every clip mode it takes.
STEP_LANES = (("naive", "flat"), ("crb", "flat"), ("ghost", "flat"),
              ("bk", "flat"), ("bk", "per_layer"), ("bk", "stale"),
              ("auto", "flat"), ("auto", "per_layer"), ("auto", "stale"))
# (strategy, mode) run again with remat=True, each against its
# remat=False lane bitwise.
REMAT_LANES = (("ghost", "flat"), ("bk", "per_layer"), ("auto", "stale"))
# Reduced Seamless with 500 of its 512 vocabulary rows valid: the 12
# padded rows lie on the last model rank's slice.
PADDED_VOCAB = 500
# (arch, strategy, clip mode, remat) of the live verifies, one a rank of
# data:2,model:2.
VERIFY_LANES = ((ARCHS[0], "ghost", "flat", False),
                (ARCHS[1], "auto", "flat", True),
                (ARCHS[0], "auto", "stale", True),
                (ARCHS[1], "bk", "per_layer", False))


def lm_model(arch: str, **cfg_kw):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    return build_model(get_config(arch).reduced().replace(**cfg_kw))


def model_calls(model, d, mesh):
    """The model group's collective calls and bytes of one bk step
    (``COLL_STATS``)."""
    from repro_torch.launch import sharding
    eng = mw.engine(model.apply, d["params"], d["batches"][0],
                    strategy="bk", mesh=mesh, axes=d["axes"])
    p = eng.shard_params(d["params"])
    sharding.COLL_STATS.reset()
    eng.private_step(p, mw.opt_init("sgdm", p), d["batches"][0], step=0)
    st = sharding.COLL_STATS
    return st.calls["model"], st.bytes["model"]


# ---------------------------------------------------------------------------
# The mutants


class _SkipCopies:
    """``launch.sharding`` with the ``copy_to_model`` calls numbered in
    ``skip`` (from 0, in call order) made the identity."""

    def __init__(self, skip):
        self.skip, self.n = set(skip), 0

    def __getattr__(self, name):
        from repro_torch.launch import sharding
        return getattr(sharding, name)

    def copy_to_model(self, x, **kw):
        from repro_torch.launch import sharding
        i, self.n = self.n, self.n + 1
        return x if i in self.skip else sharding.copy_to_model(x, **kw)


class _CopyBeforeKn:
    """``models.common`` whose ``rmsnorm`` copies ``kn``'s input to
    ``model`` first."""

    def __getattr__(self, name):
        from repro_torch.models import common
        return getattr(common, name)

    def rmsnorm(self, tp, name, p, x, *a, **kw):
        from repro_torch.launch import sharding
        from repro_torch.models import common
        if name.endswith("/kn"):
            x = sharding.copy_to_model(x)
        return common.rmsnorm(tp, name, p, x, *a, **kw)


def _sliced_attention_with(real, cross_only, sh=None, cm=None):
    """``attention._gqa_heads_sharded`` run with ``attention.sh`` /
    ``attention.cm`` replaced (made fresh each call), on every call or
    on cross attention's only."""
    from repro_torch.models import attention

    def f(tp, name, p, x, **kw):
        if cross_only and kw["x_kv"] is None:
            return real(tp, name, p, x, **kw)
        saved = attention.sh, attention.cm
        attention.sh = sh() if sh is not None else saved[0]
        attention.cm = cm() if cm is not None else saved[1]
        try:
            return real(tp, name, p, x, **kw)
        finally:
            attention.sh, attention.cm = saved
    return f


def _qn_unsummed(pe, meta):
    """``kinds.model_partial_sum`` that marks the partial per-example
    gradient and leaves it unsummed."""
    from repro_torch.analysis.markers import tag
    return {k: tag(v, kind="partial_pe",
                   group="/".join(map(str, meta.path)))
            for k, v in pe.items()}


def mutant(name: str):
    """(module, attribute, replacement, arch) of mutant ``name``.  A
    sliced attention copies x, k, then v (qn's scale is copied by
    ``Tapper.scale``); the mutant ``kn_after_copy`` skips k's copy and
    copies kn's input instead, ``cross_no_copy`` skips cross attention's
    k and v copies."""
    from repro_torch.core import kinds
    from repro_torch.models import attention
    real = attention._gqa_heads_sharded
    return {
        "qn_unsummed": (kinds, "model_partial_sum", _qn_unsummed, ARCHS[0]),
        "kn_after_copy": (attention, "_gqa_heads_sharded",
                          _sliced_attention_with(
                              real, False, sh=lambda: _SkipCopies({1}),
                              cm=_CopyBeforeKn), ARCHS[0]),
        "cross_no_copy": (attention, "_gqa_heads_sharded",
                          _sliced_attention_with(
                              real, True, sh=lambda: _SkipCopies({1, 2})),
                          ARCHS[1]),
    }[name]


MUTANTS = ("qn_unsummed", "kn_after_copy", "cross_no_copy")
# bk under per_layer clipping at a bound every group's norm exceeds: each
# group's own norm scales its own contribution.
MUTANT_LANE = ("bk", "per_layer")


def grads_of(model, d, mesh=None):
    """One σ = 0 step's released gradient (whole arrays) and per-layer
    norms under :data:`MUTANT_LANE`."""
    strategy, mode = MUTANT_LANE
    eng = mw.engine(model.apply, d["params"], d["batches"][0],
                    strategy=strategy, mode=mode, sigma=0.0, mesh=mesh,
                    axes=d["axes"] if mesh is not None else None,
                    C=xw.MUTANT_CLIP, optimizer=mw.grad_extract)
    local = eng.shard_params(d["params"])
    g, _, _, aux = eng.private_step(
        local, {"step": torch.zeros((), dtype=torch.int32)},
        d["batches"][0])
    return eng.gather_params(g), aux["per_layer_norms"]


def with_mutant(name, fn):
    module, attr, repl, arch = mutant(name)
    real = getattr(module, attr)
    setattr(module, attr, repl)
    try:
        return fn(arch)
    finally:
        setattr(module, attr, real)


def enc_out_cotangent(d, mesh=None):
    """The cotangent of reduced Seamless's encoder output under Σ_b L_b,
    on this rank's slices under ``mesh``'s model group (the decoder's
    cross attention reads it through its sliced heads) or on one
    device."""
    from repro_torch.core.tapper import Tapper
    from repro_torch.launch import sharding
    model, params, ms = lm_model(ARCHS[1]), d["params"], None
    if mesh is not None:
        specs = sharding.param_sharding(d["axes"], mesh,
                                        shapes_tree=params)
        ms = sharding.model_shard_of(mesh, specs)
        params = sharding.shard_params(params, specs, ms)
    got, real = {}, model.encode

    def encode(*a, **kw):
        out = real(*a, **kw)
        out.register_hook(lambda g: got.setdefault("g", g))
        return out
    model.encode = encode
    batch = dict(d["batches"][0])
    src = batch["src_frames"].clone().requires_grad_(True)
    batch["src_frames"] = src
    with torch.enable_grad(), sharding.model_parallel(ms):
        torch.autograd.grad(model.apply(params, batch, Tapper()).sum(), src)
    return got["g"]


def verify_codes(arch, strategy, mode, d, mesh, remat=False):
    """(error codes, the sharding pass's summary) of ``engine.verify()``
    on the live mesh."""
    from repro_torch.core import costmodel
    costmodel.clear_plan_cache()
    eng = mw.engine(lm_model(arch, remat=remat).apply, d["params"],
                    d["batches"][0], strategy=strategy, mode=mode,
                    mesh=mesh, axes=d["axes"])
    rep = eng.verify()
    return sorted({f.code for f in rep.errors}), rep.checked["sharding"]


# ---------------------------------------------------------------------------
# The lanes


def step_lanes(data, mesh):
    """{(arch, strategy, mode, remat): (this rank's slices, whole
    params, losses)} after 2 steps at σ = 0.8."""
    out = {}
    todo = [(a, s, m, False) for a in ARCHS for s, m in STEP_LANES] + \
        [(a, s, m, True) for a in ARCHS for s, m in REMAT_LANES]
    for arch, strategy, mode, remat in todo:
        d = data[arch]
        eng = mw.engine(lm_model(arch, remat=remat).apply, d["params"],
                        d["batches"][0], strategy=strategy, mode=mode,
                        mesh=mesh, axes=d["axes"])
        p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
        out[(arch, strategy, mode, remat)] = (p, eng.gather_params(p),
                                              losses)
    return out


def lanes_4(rank, mesh, data, out_dir):
    """data:2,model:2: two σ = 0.8 steps of every lane (remat off and
    on), the model group's calls with remat on and off, one live verify
    a rank."""
    res = {"steps": step_lanes(data, mesh), "calls": {}}
    for arch in ARCHS:
        for remat in (False, True):
            res["calls"][(arch, remat)] = model_calls(
                lm_model(arch, remat=remat), data[arch], mesh)
    # The batch the model sees on a data:2,model:2 rank.
    seen = []
    model = lm_model(ARCHS[1])
    real = model.apply

    def apply(p, b, tp):
        seen.append({k: tuple(v.shape) for k, v in b.items()})
        return real(p, b, tp)
    d = data[ARCHS[1]]
    eng = mw.engine(apply, d["params"], d["batches"][0], strategy="bk",
                    mesh=mesh, axes=d["axes"])
    mw.run_steps(eng, d["params"], d["batches"][:1])
    res["batch_seen"] = seen[-1]
    arch, strategy, mode, remat = VERIFY_LANES[rank]
    res["verify"] = verify_codes(arch, strategy, mode, data[arch], mesh,
                                 remat)
    return res


def single_refs(rank, data):
    """This rank's share of the single-device references: every other
    step lane (remat off: the remat lanes are held to them too), two
    steps each, and the padded-vocabulary lane; rank 0 also the
    mutants' clean gradients."""
    from repro_torch.core import costmodel
    out = {}
    todo = [(a, s, m) for a in ARCHS for s, m in STEP_LANES]
    for arch, strategy, mode in todo[rank::2]:
        d = data[arch]
        costmodel.clear_plan_cache()
        eng = mw.engine(lm_model(arch).apply, d["params"], d["batches"][0],
                        strategy=strategy, mode=mode)
        p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
        out[(arch, strategy, mode)] = (p, losses)
    if rank == 1:
        d = data["padded"]
        eng = mw.engine(lm_model(ARCHS[1], vocab=PADDED_VOCAB).apply,
                        d["params"], d["batches"][0])
        p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
        out["padded"] = (p, losses)
    if rank == 0:
        out["mutants"] = {a: grads_of(lm_model(a), data[a]) for a in ARCHS}
    return out


def lanes_2(rank, mesh, data, out_dir):
    """model:2: σ = 0 steps of each arch and of the padded-vocabulary
    Seamless (the parent holds them to the JAX package), the padded
    lane at σ = 0.8, the mutants' released gradients, a verify with
    qn's per-example gradient unsummed; and, each rank on its own, half
    the single-device references."""
    res = {"jax": {}, "mutants": {}}
    for arch in ARCHS + ("padded",):
        d = data[arch]
        model = (lm_model(ARCHS[1], vocab=PADDED_VOCAB) if arch == "padded"
                 else lm_model(arch))
        eng = mw.engine(model.apply, d["params"], d["batches"][0],
                        sigma=0.0, mesh=mesh, axes=d["axes"])
        p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
        res["jax"][arch] = (eng.gather_params(p), losses)
    d = data["padded"]
    eng = mw.engine(lm_model(ARCHS[1], vocab=PADDED_VOCAB).apply,
                    d["params"], d["batches"][0], mesh=mesh, axes=d["axes"])
    p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
    res["padded"] = (p, eng.gather_params(p), losses)
    for arch in ARCHS:
        res["mutants"][("none", arch)] = grads_of(lm_model(arch), data[arch],
                                                  mesh)
    for name in MUTANTS:
        res["mutants"][name] = with_mutant(
            name, lambda a: grads_of(lm_model(a), data[a], mesh))
    res["enc_out_cotangent"] = enc_out_cotangent(data[ARCHS[1]], mesh)
    res["verify_mutant"] = with_mutant(
        "qn_unsummed", lambda a: verify_codes(
            a, ("bk", "auto")[rank], "flat", data[a], mesh))
    res["single"] = single_refs(rank, data)
    return res


LANES = {2: lanes_2, 4: lanes_4}


def worker(rank: int, world: int, out_dir: str):
    from torch.distributed.device_mesh import init_device_mesh
    # One intra-op thread a rank: the ranks (and the parent) share the
    # host's cores, and oversubscribed threads spin.
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=xw.TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (world // 2, 2),
                                mesh_dim_names=("data", "model"))
        data = torch.load(os.path.join(out_dir, "in.pt"))
        res = LANES[world](rank, mesh, data, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(world: int, out_dir: str, data: dict):
    """Spawn ``world`` gloo ranks over ``out_dir`` (not waiting)."""
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    torch.save(data, os.path.join(out_dir, "in.pt"))
    return mp.start_processes(worker, args=(world, out_dir), nprocs=world,
                              start_method="spawn", join=False)
