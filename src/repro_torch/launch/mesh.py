"""Device meshes over ``torch.distributed`` (the JAX package's
``repro.launch.mesh``).

Functions, not module constants, so importing this module touches no
process group.  A live mesh is a ``DeviceMesh`` over the default process
group, one rank a device: launch the ranks with ``python -m
torch.distributed.run --nproc_per_node N`` and call
:func:`init_distributed` first.  :func:`fake_world` opens an in-process
fake group of N ranks instead (no processes, nothing communicated): the
port's stand-in for the JAX package's forced host devices, over which
the static verifier traces a sharded step.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.core.costmodel import format_mesh, mesh_axes

# Rendezvous and collective timeout: a rank that never arrives fails the
# run instead of hanging it.
DEFAULT_TIMEOUT_S = 120.0


def init_distributed(backend: str = "nccl", *,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device_type: str = "cuda") -> torch.device:
    """Initialize the default process group from the environment
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; a group already initialized is
    kept) and return this rank's device: rank
    ``r`` takes ``cuda:(r % device_count)`` (``device_type="cpu"``: the
    CPU).  Nothing is chosen silently: ``backend`` is the caller's
    (``nccl`` or ``gloo``), and NCCL refuses two ranks on one card."""
    if dist.is_initialized():
        rank = dist.get_rank()
    elif "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "no RANK / WORLD_SIZE in the environment: launch with "
            "python -m torch.distributed.run --nproc_per_node N ...")
    else:
        rank = int(os.environ["RANK"])
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available in this process; pass "
                "device_type='cpu' to run the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device_type)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


@contextlib.contextmanager
def fake_world(n: int, *, rank: int = 0):
    """An in-process fake default process group of ``n`` ranks, this
    process being rank ``rank`` (backend ``"fake"`` over ``FakeStore``):
    collectives record and return at once, nothing is communicated.  A
    traced sharded step then shows its ``_c10d_functional`` collectives
    with no processes.  The group is destroyed on exit; an already
    initialized group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "fake_world: a process group is already initialized in this "
            "process")
    hook = sys.excepthook   # init prefixes tracebacks with the rank
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


def mesh_groups(data: int, model: int, rank: int):
    """``(data group, model group)`` of global rank ``rank`` in a
    ``(data, model)`` mesh laid out row-major over the default group
    (rank ``i * model + j`` is data rank ``i``, model rank ``j``): every
    subgroup is created, in one fixed order, as ``new_group`` requires
    of every rank; ``None`` for an axis of size 1."""
    out = [None, None]
    if data > 1:
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if rank % model == j:
                out[0] = g
    if model > 1:
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if rank // model == i:
                out[1] = g
    return tuple(out)


@contextlib.contextmanager
def fake_mesh(data: int, model: int, *, rank: int = 0):
    """:func:`fake_world` of ``data * model`` ranks with its ``data x
    model`` subgroups (:func:`mesh_groups`): yields ``(data group, model
    group)`` of ``rank``, over which the verifier traces one rank of a
    tensor-sharded step."""
    with fake_world(data * model, rank=rank):
        yield mesh_groups(data, model, rank)


def make_mesh_from_spec(spec, *, device_type: str = "cuda"):
    """A live ``DeviceMesh`` for a planner mesh spec (``"data:8"``,
    ``"data:4,model:2"``; :func:`~repro_torch.core.costmodel.mesh_axes`)
    over the process group already initialized, or ``None`` for an empty
    spec.  The world size must equal the mesh's device count; the
    dimensions are named after the axes (``mesh.get_group("model")``),
    row-major, as :func:`mesh_groups` lays them out."""
    from torch.distributed.device_mesh import init_device_mesh
    axes = mesh_axes(spec)
    if not axes:
        return None
    n = math.prod(s for _, s in axes)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {format_mesh(axes)} needs a process group of {n} ranks; "
            f"launch with python -m torch.distributed.run "
            f"--nproc_per_node {n} and call init_distributed() first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"mesh {format_mesh(axes)} needs {n} ranks, the process group "
            f"has {world}: world size and mesh disagree")
    return init_device_mesh(device_type, tuple(s for _, s in axes),
                            mesh_dim_names=tuple(a for a, _ in axes))


def make_host_mesh(model_par: int = 1, *, device_type: str = "cpu"):
    """A ``(data, model)`` mesh over every rank of the process group
    (tests, CPU training): ``data = world // model_par``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % model_par:
        raise ValueError(f"world size {world} is not divisible by "
                         f"model_par={model_par}")
    return init_device_mesh(device_type, (world // model_par, model_par),
                            mesh_dim_names=("data", "model"))
