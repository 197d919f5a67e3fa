"""Ranks of the port's MoE model-axis tests (gloo on the CPU).

Not collected by pytest.  ``tests/test_torch_moe_model_axis.py`` spawns
one ``data:2,model:2`` world (4 ranks) and one world of 2 ranks, each
once per module, through :func:`start` / :func:`join`; every rank runs
all the lanes of its world (:func:`lanes_4`, :func:`lanes_2`) and saves
what it got to ``rank<r>.pt`` for the parent to compare.  The 2-rank
world runs its lanes on ``model:2`` and, over the same two processes,
on ``data:2`` (the global-capacity lanes).  It imports no JAX: the
parent computes every reference meanwhile.  The lane helpers
(``engine``, ``run_steps``, ``drive``) are ``tests/
torch_model_axis_worker.py``'s.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_model_axis_worker as mw

TIMEOUT_S = 120
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
IMPLS = ("einsum", "gather", "sort")
# (strategy, clip mode): every strategy but multi under every clip mode
# it takes, on the configs' own dispatch (gather) ...
STEP_LANES = (("naive", "flat"), ("crb", "flat"), ("ghost", "flat"),
              ("bk", "flat"), ("bk", "per_layer"), ("bk", "stale"),
              ("auto", "flat"), ("auto", "per_layer"), ("auto", "stale"))
# ... and these on the einsum and sort dispatches.
OTHER_IMPL_LANES = (("ghost", "flat"), ("bk", "per_layer"),
                    ("auto", "stale"))
# The global-capacity lanes on data:2: a capacity factor at which
# entries drop, and the configs' roomy one.
CAPACITY_FACTORS = (0.5, 2.0)
# A clip bound every example's norm exceeds, so the coefficients (and a
# mutant's wrong norm) reach the released gradient.
MUTANT_CLIP = 0.01


def lanes(arch: str) -> list:
    """(impl, strategy, mode) of the data:2,model:2 lanes of ``arch``."""
    return ([("gather",) + sl for sl in STEP_LANES]
            + [(i,) + sl for i in ("einsum", "sort")
               for sl in OTHER_IMPL_LANES])


def lm_model(arch: str, impl: str | None = None, capacity_factor=None):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch).reduced()
    if impl is not None:
        cfg = cfg.replace(moe_impl=impl)
    if capacity_factor is not None:
        cfg = cfg.replace(capacity_factor=capacity_factor)
    return build_model(cfg)


def grads_of(model, d, mesh=None, *, strategy="ghost", C=MUTANT_CLIP):
    """One σ = 0 step's released gradient (whole arrays)."""
    eng = mw.engine(model.apply, d["params"], d["batches"][0],
                    strategy=strategy, sigma=0.0, mesh=mesh,
                    axes=d["axes"] if mesh is not None else None, C=C,
                    optimizer=mw.grad_extract)
    local = eng.shard_params(d["params"])
    g, _, _, aux = eng.private_step(
        local, {"step": torch.zeros((), dtype=torch.int32)},
        d["batches"][0])
    return eng.gather_params(g), aux["per_example_norms"]


# ---------------------------------------------------------------------------
# The mutants: a missing layout move or model sum


class SkipCopy:
    """``launch.sharding`` with call ``skip`` of every ``every``
    ``copy_to_model`` calls made the identity: a copy left out."""

    def __init__(self, skip: int, every: int):
        self.skip, self.every, self.n = skip, every, 0

    def __getattr__(self, name):
        from repro_torch.launch import sharding
        return getattr(sharding, name)

    def copy_to_model(self, x):
        from repro_torch.launch import sharding
        i, self.n = self.n % self.every, self.n + 1
        return x if i == self.skip else sharding.copy_to_model(x)


def _experts_unsummed(real):
    """``strategies.model_summed`` with the expert groups' partial norms²
    left out of the sum."""
    def model_summed(norms, paths):
        rest = [i for i, p in enumerate(paths)
                if "moe/w_" not in "/".join(map(str, p))]
        out = list(norms)
        for i, n in zip(rest, real([norms[i] for i in rest],
                                   [paths[i] for i in rest])):
            out[i] = n
        return out
    return model_summed


def mutant(name: str):
    """(module, attribute, replacement) of mutant ``name``.  A MoE layer
    copies its input, then the combine weights; MLA copies the normed
    query latent, the normed KV latent, then the RoPE key."""
    from repro_torch.core import strategies
    from repro_torch.models import attention, moe
    return {"top_w": (moe, "sh", SkipCopy(1, 2)),
            "cq": (attention, "sh", SkipCopy(0, 3)),
            "ckv": (attention, "sh", SkipCopy(1, 3)),
            "k_rope": (attention, "sh", SkipCopy(2, 3)),
            "expert_norm": (strategies, "model_summed",
                            _experts_unsummed(strategies.model_summed)),
            }[name]


MUTANTS = ("top_w", "cq", "ckv", "k_rope", "expert_norm")


# ---------------------------------------------------------------------------
# The lanes


def lanes_4(rank, meshes, data, out_dir):
    """data:2,model:2: two σ = 0.8 steps of every lane, and the
    checkpointed run the parent resumes on one device."""
    from repro_torch.checkpoint import Checkpointer
    mesh = meshes["data:2,model:2"]
    res = {"steps": {}}
    for arch in ARCHS:
        d = data[arch]
        for impl, strategy, mode in lanes(arch):
            model = lm_model(arch, impl)
            eng = mw.engine(model.apply, d["params"], d["batches"][0],
                            strategy=strategy, mode=mode, mesh=mesh,
                            axes=d["axes"])
            p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
            res["steps"][(arch, impl, strategy, mode)] = (
                p, eng.gather_params(p), losses)
    d, model = data[ARCHS[0]], lm_model(ARCHS[0])
    eng = mw.engine(model.apply, d["params"], d["batches"][0],
                    strategy="auto", mode="stale", sigma=mw.NOISE,
                    mesh=mesh, axes=d["axes"], accountant=True,
                    optimizer="adamw")
    p, _, _ = mw.drive(eng, d["params"], d["batches"],
                       ckpt=Checkpointer(os.path.join(out_dir, "ck_2d")),
                       writer=rank == 0)
    res["resume"] = eng.gather_params(p)
    # The verifier on the live mesh traces this rank over its own groups
    # (no collective runs while it traces): one lane a rank.
    arch, mode = VERIFY_LANES[rank]
    res["verify"] = verify_codes(arch, mode, data[arch], mesh)
    return res


# (arch, clip mode) of the live verifies, one a rank of data:2,model:2.
VERIFY_LANES = ((ARCHS[0], "flat"), (ARCHS[1], "flat"), (ARCHS[0], "stale"),
                (ARCHS[1], "stale"))


def verify_codes(arch, mode, d, mesh):
    """(error codes, the sharding pass's summary) of ``engine.verify()``
    on the live mesh."""
    from repro_torch.core import costmodel
    costmodel.clear_plan_cache()
    eng = mw.engine(lm_model(arch).apply, d["params"], d["batches"][0],
                    mode=mode, mesh=mesh, axes=d["axes"])
    rep = eng.verify()
    return sorted({f.code for f in rep.errors}), rep.checked["sharding"]


def single_refs(rank, data):
    """This rank's share of the single-device references: every other
    data:2,model:2 lane, in order, two steps each; rank 0 also the
    mutants' clean gradient."""
    from repro_torch.core import costmodel
    out = {}
    todo = [(a,) + lane for a in ARCHS for lane in lanes(a)]
    for arch, impl, strategy, mode in todo[rank::2]:
        d = data[arch]
        costmodel.clear_plan_cache()
        eng = mw.engine(lm_model(arch, impl).apply, d["params"],
                        d["batches"][0], strategy=strategy, mode=mode)
        p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
        out[(arch, impl, strategy, mode)] = (p, losses)
    if rank == 0:
        out["mutants"] = grads_of(lm_model(ARCHS[1]), data[ARCHS[1]])
    return out


def lanes_2(rank, meshes, data, out_dir):
    """model:2: σ = 0 steps of each dispatch (the parent holds them to
    the JAX package), the mutants' released gradients, a verify with an
    unsummed expert norm² (each rank an arch); data:2: the
    global-capacity lanes; and, each rank on its own, half the
    single-device references."""
    mesh = meshes["model:2"]
    res = {"jax": {}, "mutants": {}, "capacity": {}}
    for arch in ARCHS:
        d = data[arch]
        for impl in IMPLS:
            model = lm_model(arch, impl)
            eng = mw.engine(model.apply, d["params"], d["batches"][0],
                            sigma=0.0, mesh=mesh, axes=d["axes"])
            p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
            res["jax"][(arch, impl)] = (eng.gather_params(p), losses)
    arch = ARCHS[1]
    model = lm_model(arch)
    res["mutants"]["none"] = grads_of(model, data[arch], mesh)
    for name in MUTANTS:
        module, attr, fn = mutant(name)
        real = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            res["mutants"][name] = grads_of(model, data[arch], mesh)
        finally:
            setattr(module, attr, real)
    mesh = meshes["data:2"]
    d = data[ARCHS[0]]
    for cf in CAPACITY_FACTORS:
        for impl in ("gather", "sort"):
            model = lm_model(ARCHS[0], impl, cf)
            eng = mw.engine(model.apply, d["params"], d["batches"][0],
                            sigma=0.0, mesh=mesh)
            p, _, losses = mw.run_steps(eng, d["params"], d["batches"])
            res["capacity"][(impl, cf)] = (p, losses)
    # The verifier on model:2 with an expert group's norm² unsummed.
    module, attr, fn = mutant("expert_norm")
    real = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        res["verify_mutant"] = verify_codes(ARCHS[rank], "flat",
                                            data[ARCHS[rank]],
                                            meshes["model:2"])
    finally:
        setattr(module, attr, real)
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
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        meshes = {"data:2,model:2" if world == 4 else "model:2":
                  init_device_mesh("cpu", (world // 2, 2),
                                   mesh_dim_names=("data", "model"))}
        if world == 2:
            meshes["data:2"] = init_device_mesh("cpu", (2,),
                                                mesh_dim_names=("data",))
        data = torch.load(os.path.join(out_dir, "in.pt"))
        res = LANES[world](rank, meshes, data, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(world: int, out_dir: str, data: dict):
    """Spawn ``world`` gloo ranks over ``out_dir`` (not waiting)."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save(data, os.path.join(out_dir, "in.pt"))
    return mp.start_processes(worker, args=(world, out_dir), nprocs=world,
                              start_method="spawn", join=False)


def join(ctx, world: int, out_dir: str) -> list:
    """Wait at most TIMEOUT_S for :func:`start`'s ranks; each rank's
    results."""
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} gloo ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]
