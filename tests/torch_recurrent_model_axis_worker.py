"""Ranks of the port's recurrent-family model-axis tests (gloo on the
CPU).

Not collected by pytest.  ``tests/test_torch_recurrent_model_axis.py``
spawns one world of 4 ranks (``data:2,model:2`` and ``model:4``) and one
of 2 ranks (``model:2``), each once per module, through :func:`start` /
``torch_moe_model_axis_worker.join``; every rank runs all the lanes of
its world (:func:`lanes_4`, :func:`lanes_2`) and saves what it got to
``rank<r>.pt`` for the parent to compare.  The 2-rank world also
computes the single-device references, each rank half of them.  It
imports no JAX: the parent computes the JAX package's references
meanwhile.  The lane helpers (``engine``, ``run_steps``) are
``tests/torch_model_axis_worker.py``'s.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

import torch_attn_model_axis_worker as aw
import torch_model_axis_worker as mw
import torch_moe_model_axis_worker as xw

ARCHS = ("xlstm-125m", "zamba2-2.7b")
# Reduced Zamba2 at d_model 128: 4 SSD heads of 64 (the reduced config's
# 64 gives 2), so model:4 divides them; its conv's 288 channels split at
# 72 beside the heads' 64 channels a rank (at model:2, 144 beside 128),
# as Zamba2-2.7B's 5248 split at 2624 beside 2560.
CFG_KW = {"xlstm-125m": {}, "zamba2-2.7b": {"d_model": 128}}
# Every strategy but multi under every clip mode it takes.
STEP_LANES = (("naive", "flat"), ("crb", "flat"), ("ghost", "flat"),
              ("bk", "flat"), ("bk", "per_layer"), ("bk", "stale"),
              ("auto", "flat"), ("auto", "per_layer"), ("auto", "stale"))
# Zamba2 (remat=True at full width) again with remat on, each against
# its remat=False lane bitwise.
REMAT_LANES = (("ghost", "flat"), ("auto", "stale"))
# (arch, strategy, clip mode) on model:4: one mLSTM and one sLSTM head
# a rank; one SSD head and one attention head a rank.
M4_LANES = ((ARCHS[0], "bk", "flat"), (ARCHS[0], "auto", "stale"),
            (ARCHS[0], "ghost", "flat"), (ARCHS[1], "bk", "flat"))
# (arch, strategy, clip mode, remat) of the live verifies, one a rank of
# data:2,model:2.
VERIFY_LANES = ((ARCHS[0], "bk", "flat", False),
                (ARCHS[1], "auto", "flat", True),
                (ARCHS[0], "auto", "stale", False),
                (ARCHS[1], "bk", "per_layer", False))
# The sequence lengths of the collective census: the model group's calls
# a step do not depend on T.
CENSUS_T = (8, 16)
# The verifies' sequence length: the trace holds every step of the
# recurrences, so T = 4 halves a verify's time.
VERIFY_T = 4


def lm_model(arch: str, **cfg_kw):
    return aw.lm_model(arch, **CFG_KW[arch], **cfg_kw)


def model_calls(arch, d, mesh):
    """The model group's collective calls and bytes of one bk step."""
    return aw.model_calls(lm_model(arch), d, mesh)


# ---------------------------------------------------------------------------
# The mutants


def _bias_before_sum(tp, name, p, xin, n_heads):
    """``ssm._wif_gates`` with the replicated bias added on every rank
    before the sum over model."""
    from repro_torch.launch import sharding as sh
    B, T, _ = xin.shape
    g = tp.dense(f"{name}/wif", xin, p["wif"]["w"], p["wif"]["b"])
    return sh.reduce_scatter_from_model(g.reshape(B, T, 2, n_heads),
                                        -1).unbind(2)


class _ScatterIdentityBackward:
    """``launch.sharding`` whose reduce-scatter is ``reduce_from_model``
    and a slice: an identity backward, each rank's partial product then
    takes only its own heads' cotangent."""

    def __getattr__(self, name):
        from repro_torch.launch import sharding
        return getattr(sharding, name)

    def reduce_scatter_from_model(self, x, dim):
        from repro_torch.launch import sharding
        return sharding.own(sharding.reduce_from_model(x), dim)


def mutant(name: str):
    """(module, attribute, replacement, arch) of mutant ``name``."""
    from repro_torch.core import kinds
    from repro_torch.models import ssm
    return {
        # the partial per-example gradient marked and left unsummed
        "ssd_unsummed": (kinds, "model_partial_sum", aw._qn_unsummed,
                         ARCHS[1]),
        "wif_bias_before_sum": (ssm, "_wif_gates", _bias_before_sum,
                                ARCHS[0]),
        "scatter_identity_backward": (ssm, "sh", _ScatterIdentityBackward(),
                                      ARCHS[0]),
    }[name]


MUTANTS = ("ssd_unsummed", "wif_bias_before_sum", "scatter_identity_backward")


def grads_of(arch, d, mesh=None):
    """One σ = 0 step's released gradient (whole arrays) and per-layer
    norms under ``torch_attn_model_axis_worker.MUTANT_LANE``."""
    return aw.grads_of(lm_model(arch), d, mesh)


def with_mutant(name, fn):
    module, attr, repl, arch = mutant(name)
    real = getattr(module, attr)
    setattr(module, attr, repl)
    try:
        return fn(arch)
    finally:
        setattr(module, attr, real)


def verify_codes(arch, strategy, mode, data, mesh, remat=False):
    """(error codes, the sharding pass's summary) of ``engine.verify()``
    on the live mesh, at :data:`VERIFY_T`."""
    d = data[("verify", arch)]
    from repro_torch.core import costmodel
    costmodel.clear_plan_cache()
    eng = mw.engine(lm_model(arch, remat=remat).apply, d["params"],
                    d["batches"][0], strategy=strategy, mode=mode,
                    mesh=mesh, axes=d["axes"])
    rep = eng.verify()
    return sorted({f.code for f in rep.errors}), rep.checked["sharding"]


# ---------------------------------------------------------------------------
# The lanes


def step_lanes(data, mesh, todo):
    """{(arch, strategy, mode, remat): (this rank's slices, whole
    params, losses)} after 2 steps at σ = 0.8."""
    out = {}
    for arch, strategy, mode, remat in todo:
        d = data[arch]
        eng = mw.engine(lm_model(arch, remat=remat).apply, d["params"],
                        d["batches"][0], strategy=strategy, mode=mode,
                        mesh=mesh, axes=d["axes"])
        p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
        out[(arch, strategy, mode, remat)] = (p, eng.gather_params(p),
                                              losses)
    return out


def lanes_4(rank, meshes, data, out_dir):
    """data:2,model:2: two σ = 0.8 steps of every lane (Zamba2's remat
    lanes too), one live verify a rank; model:4: one head a rank."""
    mesh2d, mesh4 = meshes
    todo = [(a, s, m, False) for a in ARCHS for s, m in STEP_LANES] + \
        [(ARCHS[1], s, m, True) for s, m in REMAT_LANES]
    res = {"steps": step_lanes(data, mesh2d, todo),
           "m4": step_lanes(data, mesh4, [lane + (False,)
                                          for lane in M4_LANES])}
    arch, strategy, mode, remat = VERIFY_LANES[rank]
    res["verify"] = verify_codes(arch, strategy, mode, data, mesh2d, remat)
    return res


def single_refs(rank, data):
    """This rank's share of the single-device references: every other
    step lane, two steps each; rank 0 also the mutants' clean
    gradients."""
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
    if rank == 0:
        out["mutants"] = {a: grads_of(a, data[a]) for a in ARCHS}
    return out


def lanes_2(rank, meshes, data, out_dir):
    """model:2: σ = 0 steps of each arch (the parent holds them to the
    JAX package), the model group's calls at two sequence lengths, the
    mutants' released gradients, a verify with the ``ssd`` per-example
    gradient unsummed; and, each rank on its own, half the single-device
    references."""
    (mesh,) = meshes
    res = {"jax": {}, "mutants": {},
           "calls": {(a, t): model_calls(a, data[("census", a, t)], mesh)
                     for a in ARCHS for t in CENSUS_T}}
    for arch in ARCHS:
        d = data[arch]
        eng = mw.engine(lm_model(arch).apply, d["params"], d["batches"][0],
                        sigma=0.0, mesh=mesh, axes=d["axes"])
        p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
        res["jax"][arch] = (eng.gather_params(p), losses)
    for arch in ARCHS:
        res["mutants"][("none", arch)] = grads_of(arch, data[arch], mesh)
    for name in MUTANTS:
        res["mutants"][name] = with_mutant(
            name, lambda a: grads_of(a, data[a], mesh))
    res["verify_mutant"] = with_mutant(
        "ssd_unsummed", lambda a: verify_codes(
            a, ("bk", "auto")[rank], "flat", data, mesh))
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
        if world == 2:
            meshes = [init_device_mesh("cpu", (2,),
                                       mesh_dim_names=("model",))]
        else:
            meshes = [init_device_mesh("cpu", (2, 2),
                                       mesh_dim_names=("data", "model")),
                      init_device_mesh("cpu", (4,),
                                       mesh_dim_names=("model",))]
        data = torch.load(os.path.join(out_dir, "in.pt"))
        res = LANES[world](rank, meshes, data, out_dir)
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
