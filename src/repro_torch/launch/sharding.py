"""Logical-axis sharding rules (the JAX package's ``repro.launch.
sharding``, t5x-style).

Params carry logical axis tuples built at init time (``model.init``
returns them beside the params); a rules table maps logical axes to mesh
axes.  A spec here is what the JAX package's ``PartitionSpec`` holds: a
tuple with one entry a dimension — ``None`` (replicated), a mesh axis
name, or a tuple of names — trailing ``None`` entries dropped.

Data-parallel execution (``PrivacyEngine(mesh=)`` on a pure-data mesh)
uses only :func:`batch_sharding`: the batch's leading axis over the data
axes, every param replicated.  The param specs are computed and held
against the JAX package's; executing them is model-axis sharding
(ROADMAP.md item 14 part 2).
"""
from __future__ import annotations

from repro_torch.core.costmodel import DATA_AXIS_NAMES
from repro_torch.tree import tree_map

# Default production rules.  "batch" maps to all pure-data axes; FSDP
# additionally shards the "embed" param axes over the data axes.
ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "state": None,
    "frames": None,
}

PARAM_RULES = {
    "embed": None,
    "heads": "model",
    "kv": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "layer": None,
    "conv_k": None,
    "state": None,
    "qrank": None,
    "kvrank": None,
}

FSDP_PARAM_RULES = dict(PARAM_RULES, embed=("pod", "data"))


def _mesh_sizes(mesh) -> dict:
    """Axis name -> size, unit axes kept (they name mesh dimensions, as a
    ``jax.sharding.Mesh``'s ``axis_names`` do): a ``DeviceMesh``, a
    ``"data:4,model:2"`` spec, a mapping or an ``(("data", 4), ...)``
    tuple."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    if isinstance(mesh, str):
        out = {}
        for part in mesh.split(","):
            if part.strip():
                name, _, size = part.partition(":")
                out[name.strip()] = int(size)
        return out
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(n): int(s) for n, s in mesh}


def _axes_to_spec(axes: tuple, rules: dict, mesh,
                  shape: tuple | None = None) -> tuple:
    """One leaf's spec.  Mesh axes absent from the mesh, already used by
    an earlier dimension, or (with ``shape``) not dividing the dimension
    are dropped; of several that do not divide together, the first that
    divides alone is kept."""
    sizes = _mesh_sizes(mesh)
    out = []
    used = set()
    for i, ax in enumerate(axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(x for x in ms if x in sizes and x not in used)
        if shape is not None and ms:
            total = 1
            for x in ms:
                total *= sizes[x]
            if shape[i] % total != 0:
                ms = tuple(x for x in ms if shape[i] % sizes[x] == 0)[:1]
        used.update(ms)
        if not ms:
            out.append(None)
        elif len(ms) == 1:
            out.append(ms[0])
        else:
            out.append(ms)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_sharding(axes_tree, mesh, *, fsdp: bool = False,
                   shapes_tree=None):
    """The logical-axes tree as a tree of specs.  With ``shapes_tree``
    (tensors or specs, same structure) mesh axes that do not divide a
    dimension are dropped instead of kept (4 heads on an 8-way model
    axis stay replicated)."""
    rules = FSDP_PARAM_RULES if fsdp else PARAM_RULES
    if shapes_tree is None:
        return tree_map(lambda axes: _axes_to_spec(axes, rules, mesh),
                        axes_tree)
    return tree_map(
        lambda axes, leaf: _axes_to_spec(axes, rules, mesh,
                                         tuple(leaf.shape)),
        axes_tree, shapes_tree)


def batch_sharding(batch, mesh):
    """Every batch leaf's spec: its leading (example) axis over the
    mesh's data axes, the planner's vocabulary.  A mesh with no data axis
    raises."""
    names = tuple(_mesh_sizes(mesh))
    data_axes = tuple(a for a in DATA_AXIS_NAMES if a in names)
    if not data_axes:
        raise ValueError(
            f"mesh axes {names} contain no data-parallel axis (one of "
            f"{DATA_AXIS_NAMES}) to shard the batch over")
    spec = (data_axes if len(data_axes) > 1 else data_axes[0],)
    return tree_map(lambda leaf: spec, batch)
