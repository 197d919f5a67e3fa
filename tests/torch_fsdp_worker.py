"""Ranks of the port's FSDP tests (gloo on the CPU).

Not collected by pytest.  ``tests/test_torch_fsdp.py`` spawns one
``data:2,model:2`` world (4 ranks) and one ``data:2`` world (2 ranks),
each once per module, through :func:`start` / ``join`` (the MoE
model-axis worker's); every rank runs all the lanes of its world
(:func:`lanes_4`, :func:`lanes_2`) and saves what it got to
``rank<r>.pt`` for the parent to compare.  The 2-rank world also
computes the single-device references, each rank half of them.  It
imports no JAX: the parent computes the JAX package's references
meanwhile.
"""
from __future__ import annotations

import datetime
import os
import shutil

import torch
import torch.distributed as dist

import torch_model_axis_worker as mw
import torch_moe_model_axis_worker as xw

ARCHS = ("glm4-9b", "stablelm-12b", "chameleon-34b", "deepseek-v3-671b")
SIGMA = 1.0
RUN_SEED = 11
# Every strategy but multi under every clip mode it takes.
STEP_LANES = (("naive", "flat"), ("crb", "flat"), ("ghost", "flat"),
              ("bk", "flat"), ("bk", "per_layer"), ("bk", "stale"),
              ("auto", "flat"), ("auto", "per_layer"), ("auto", "stale"))
# Each mesh runs every lane once, on the archs in turn (the offset moves
# the data:2 world's lanes one arch on from the 4-rank world's).
OFFSET = {4: 0, 2: 1}
RUNS = ("replicated", "fsdp", "fsdp_again")


def lanes_of(world: int) -> tuple:
    """(arch, strategy, mode) of each step lane of a world's mesh."""
    return tuple((ARCHS[(i + OFFSET[world]) % len(ARCHS)], s, m)
                 for i, (s, m) in enumerate(STEP_LANES))


# (arch, strategy, mode) of the live verifies, one a rank.
VERIFY_LANES = {4: (("glm4-9b", "bk", "flat"),
                    ("stablelm-12b", "auto", "stale"),
                    ("chameleon-34b", "ghost", "flat"),
                    ("deepseek-v3-671b", "auto", "per_layer")),
                2: (("glm4-9b", "auto", "flat"),
                    ("deepseek-v3-671b", "bk", "stale"))}
# The resume lanes' arch and lane (AdamW, as the train CLI).
RESUME_ARCH, RESUME_LANE = "glm4-9b", ("auto", "stale")

# A toy model whose "embed" widths are 6 (which data:2 divides) and 5
# (which it does not: that leaf stays replicated over data).
TOY_AXES = {"a": {"w": ("embed", "mlp")}, "b": {"w": ("embed", None)}}


def lm_model(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    return build_model(get_config(arch).reduced())


def engine(apply_fn, d, *, strategy="auto", mode="flat", sigma=SIGMA,
           mesh=None, fsdp=False, optimizer="adamw", accountant=False):
    from repro_torch.core import DPConfig, PrivacyAccountant, PrivacyEngine
    dp = DPConfig(l2_clip=1.0, noise_multiplier=sigma, strategy=strategy,
                  clipping=mw.policy(mode))
    acct = (PrivacyAccountant(sampling_rate=1 / 128, noise_multiplier=sigma)
            if accountant else None)
    return PrivacyEngine(apply_fn, d["params"], d["batches"][0], dp=dp,
                         optimizer=optimizer, lr=1e-2, mesh=mesh,
                         param_axes=None if mesh is None else d["axes"],
                         fsdp=fsdp, run_seed=RUN_SEED, accountant=acct,
                         calibration="analytic", device="cpu")


def nbytes(tree) -> int:
    from repro_torch.tree import get_subtree, leaf_paths
    return sum(get_subtree(tree, p).numel() * get_subtree(tree, p)
               .element_size() for p in leaf_paths(tree))


def shapes(tree) -> dict:
    from repro_torch.tree import get_subtree, leaf_paths
    return {p: tuple(get_subtree(tree, p).shape) for p in leaf_paths(tree)}


def run_lane(eng, d, optimizer="adamw"):
    """Two steps from the whole params: {local shapes, local bytes of the
    params and moments, gathered params and optimizer state, losses}."""
    p, o, losses = mw.run_steps(eng, d["params"], d["batches"], optimizer)
    return {"shapes": shapes(p), "bytes": (nbytes(p), nbytes(o)),
            "params": eng.gather_params(p), "opt": eng.gather_opt(o),
            "losses": losses}


def step_lanes(world, mesh, data):
    """{(arch, strategy, mode, run): :func:`run_lane`} of every lane, run
    replicated and twice under FSDP on ``mesh`` at σ = 1."""
    from repro_torch.core import costmodel
    out = {}
    for arch, strategy, mode in lanes_of(world):
        for run in RUNS:
            costmodel.clear_plan_cache()
            eng = engine(lm_model(arch).apply, data[arch], strategy=strategy,
                         mode=mode, mesh=mesh, fsdp=run != "replicated")
            out[(arch, strategy, mode, run)] = run_lane(eng, data[arch])
    return out


def verify_codes(arch, strategy, mode, d, mesh):
    """(error codes, the sharding pass's summary) of the live FSDP
    ``engine.verify()``."""
    from repro_torch.core import costmodel
    costmodel.clear_plan_cache()
    rep = engine(lm_model(arch).apply, d, strategy=strategy, mode=mode,
                 mesh=mesh, fsdp=True).verify()
    return sorted({f.code for f in rep.errors}), rep.checked["sharding"]


def drive(mesh, fsdp, d, ckpt_dir, kill_at=None):
    """One process lifetime of a resume lane (``mw.drive``: AdamW, a
    checkpoint every step, rank 0 writing): restore the latest
    checkpoint under ``ckpt_dir`` for this mesh and ``fsdp`` setting,
    step to ``mw.STEPS`` or stop before ``kill_at``; the gathered
    params."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import costmodel
    costmodel.clear_plan_cache()
    strategy, mode = RESUME_LANE
    eng = engine(lm_model(RESUME_ARCH).apply, d, strategy=strategy,
                 mode=mode, mesh=mesh, fsdp=fsdp, accountant=True)
    ckpt = Checkpointer(ckpt_dir, keep=10)
    p, o, died = mw.drive(eng, d["params"], d["batches"], ckpt,
                          kill_at=kill_at, writer=dist.get_rank() == 0)
    return {"params": eng.gather_params(p), "opt": eng.gather_opt(o),
            "shapes": shapes(p), "died": died}


def copy_dir(src, dst):
    if dist.get_rank() == 0:
        shutil.copytree(src, dst)
    dist.barrier()


def sigma0_lanes(mesh, data):
    """σ = 0, ``auto`` flat, SGD with momentum, FSDP: each arch's gathered
    params and losses (the parent holds them to the JAX package)."""
    from repro_torch.core import costmodel
    out = {}
    for arch in ARCHS:
        costmodel.clear_plan_cache()
        eng = engine(lm_model(arch).apply, data[arch], sigma=0.0, mesh=mesh,
                     fsdp=True, optimizer="sgdm")
        p, _, losses = mw.run_steps(eng, data[arch]["params"],
                                    data[arch]["batches"])
        out[arch] = (eng.gather_params(p), losses)
    return out


def lanes_4(rank, mesh, data, out_dir):
    """data:2,model:2: every step lane replicated and twice under FSDP,
    the σ = 0 lanes, kill-and-resume under FSDP and a resume with FSDP
    off, one live verify a rank."""
    res = {"steps": step_lanes(4, mesh, data),
           "jax": sigma0_lanes(mesh, data)}
    d = data[RESUME_ARCH]
    ck = os.path.join(out_dir, "ck4")
    res["straight"] = drive(mesh, True, d, os.path.join(out_dir, "ck4s"))
    drive(mesh, True, d, ck, kill_at=mw.KILL_AT)
    copy_dir(ck, ck + "_off")
    res["resumed"] = drive(mesh, True, d, ck)
    res["resumed_fsdp_off"] = drive(mesh, False, d, ck + "_off")
    res["verify"] = verify_codes(*VERIFY_LANES[4][rank], data[
        VERIFY_LANES[4][rank][0]], mesh)
    return res


def toy_apply(p, batch, tp):
    a = torch.tanh(tp.dense("a", batch["x"], p["a"]["w"]))
    b = torch.tanh(tp.dense("b", batch["z"], p["b"]["w"]))
    return (a ** 2).sum(dim=1) + (b ** 2).sum(dim=1)


def toy_lane(mesh, data):
    """The toy on data:2 at σ = 1 (bk), replicated and under FSDP."""
    d = data["toy"]
    out = {}
    for fsdp in (False, True):
        eng = engine(toy_apply, d, strategy="bk", mesh=mesh, fsdp=fsdp)
        out[fsdp] = run_lane(eng, d)
    return out


def single_refs(rank, data):
    """This rank's half of the single-device references of both worlds'
    lanes, and of the resume lane's straight run."""
    from repro_torch.core import costmodel
    out = {}
    todo = sorted(set(lanes_of(4)) | set(lanes_of(2)))
    for arch, strategy, mode in todo[rank::2]:
        costmodel.clear_plan_cache()
        eng = engine(lm_model(arch).apply, data[arch], strategy=strategy,
                     mode=mode)
        out[(arch, strategy, mode)] = run_lane(eng, data[arch])
    return out


def lanes_2(rank, mesh, data, out_dir):
    """data:2: every step lane replicated and twice under FSDP, the toy's
    replicated leaf, resumes across data degree 2 -> 1 -> 2 (model
    degree 1 -> 2 -> 1) under FSDP, two live verifies; and half the
    single-device references."""
    from torch.distributed.device_mesh import init_device_mesh
    res = {"steps": step_lanes(2, mesh, data), "toy": toy_lane(mesh, data)}
    mesh_m = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data",
                                                             "model"))
    d = data[RESUME_ARCH]
    ck = os.path.join(out_dir, "ck2")
    res["straight"] = drive(mesh, True, d, os.path.join(out_dir, "ck2s"))
    drive(mesh, True, d, ck, kill_at=mw.KILL_AT)
    res["on_model2"] = drive(mesh_m, True, d, ck, kill_at=mw.KILL_AT + 1)
    res["back_on_data2"] = drive(mesh, True, d, ck)
    res["verify"] = verify_codes(*VERIFY_LANES[2][rank], data[
        VERIFY_LANES[2][rank][0]], mesh)
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
        mesh = (init_device_mesh("cpu", (2, 2),
                                 mesh_dim_names=("data", "model"))
                if world == 4 else
                init_device_mesh("cpu", (2,), mesh_dim_names=("data",)))
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
