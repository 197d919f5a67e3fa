"""Elastic scaling: recompute parallelism after membership changes (the
JAX package's ``repro.runtime.elastic``; pure functions of axis sizes).

Checkpoints are mesh-agnostic (see the checkpointer), so elastic rescale
is: pick the new data-parallel degree that keeps the global batch
divisible, rebuild the mesh, restore onto it, and continue.  The
training CLI (``launch/train.py``) collapses a checkpoint's mesh onto the
live world size with :func:`elastic_mesh_axes` when no ``--mesh`` is
given.
"""
from __future__ import annotations

# Mesh axis names that carry data parallelism (the JAX package's
# ``costmodel.DATA_AXIS_NAMES``).
DATA_AXIS_NAMES = ("pod", "data", "batch")


def elastic_data_degree(n_devices: int, model_par: int, global_batch: int,
                        microbatches: int = 1) -> int:
    """Largest data-parallel degree usable with the surviving devices."""
    if n_devices < model_par:
        raise ValueError(
            f"cannot keep model_par={model_par} with {n_devices} devices")
    data = n_devices // model_par
    micro_global = global_batch // microbatches
    while data > 1 and micro_global % data != 0:
        data -= 1
    return data


def elastic_mesh_axes(prev_axes, n_devices: int, global_batch: int,
                      microbatches: int = 1) -> tuple:
    """The mesh a run checkpointed on ``prev_axes`` should resume on with
    ``n_devices`` surviving: model parallelism is preserved, the data axes
    collapse to the largest degree that still divides the
    per-microbatch global batch.  Returns the normalized axes tuple
    (``()`` = resume unsharded)."""
    prev = tuple((str(n), int(s)) for n, s in prev_axes)
    if not prev:
        return ()
    model_axes = tuple((n, s) for n, s in prev if n not in DATA_AXIS_NAMES)
    model_par = 1
    for _, s in model_axes:
        model_par *= s
    data = elastic_data_degree(n_devices, model_par, global_batch,
                               microbatches)
    data_name = next((n for n, _ in prev if n in DATA_AXIS_NAMES), "data")
    if data <= 1:
        return model_axes            # () when there was no model axis
    out = []
    placed = False
    for n, s in prev:
        if n in DATA_AXIS_NAMES:
            if not placed:           # collapse all data axes into one
                out.append((data_name, data))
                placed = True
        else:
            out.append((n, s))
    return tuple(out)
