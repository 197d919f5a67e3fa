"""Logical-axis sharding rules (the JAX package's ``repro.launch.
sharding``, t5x-style).

Params carry logical axis tuples built at init time (``model.init``
returns them beside the params); a rules table maps logical axes to mesh
axes.  A spec here is what the JAX package's ``PartitionSpec`` holds: a
tuple with one entry a dimension — ``None`` (replicated), a mesh axis
name, or a tuple of names — trailing ``None`` entries dropped.

Data-parallel execution (``PrivacyEngine(mesh=)`` on a pure-data mesh)
uses only :func:`batch_sharding`: the batch's leading axis over the data
axes, every param replicated.

Model-axis execution (``PrivacyEngine(mesh=, param_axes=)`` on a mesh
with a ``model`` axis) partitions every leaf whose spec names ``model``:
each rank holds its contiguous slice of that dimension
(:func:`shard_params`, :func:`gather_params`).  There is no SPMD
compiler, so every layout move is an explicit collective, and the
models make it at the layout points the JAX package marks with
``shard_act``, under :func:`model_parallel` (outside one each helper is
the identity):

  * :func:`copy_to_model`   — a full activation entering a
    column-sharded layer: identity forward, its cotangent summed over
    ``model`` in the backward (Megatron's ``f``); also a replicated
    parameter read by a rank's slice (``param=True``);
  * :func:`reduce_from_model` — a row-sharded layer's partial output, a
    partial loss term: summed over ``model`` forward, identity backward
    (Megatron's ``g``);
  * :func:`gather_from_model` — a feature slice all-gathered for a
    consumer that needs the full input; the backward takes the rank's
    slice of the cotangent (a replicated consumer) or reduce-scatters it
    (``sharded_consumer=True``: a column-sharded one);
  * :func:`reduce_scatter_from_model` — a row-sharded layer's partial
    output summed over ``model``, keeping the rank's slice (its heads);
    the backward gathers the cotangent, which the partial product takes
    whole;
  * :func:`sum_over_model` — a partial statistic of a sliced activation
    (an RMSNorm's sum of squares over a sliced width) summed over
    ``model`` for the rank's slice: its cotangent, partial too, summed
    again in the backward;
  * :func:`parallel_xent` — cross entropy over vocabulary-sharded
    logits (max, sum of exponentials and target logit summed over
    ``model``; the logits are never gathered).

Layers whose forward couples the examples of the global batch read
the data group the same way (:func:`data_parallel`): the MoE dispatch's
global capacity sums each data rank's per-expert entry counts.

FSDP (``param_sharding(fsdp=True)``, :data:`FSDP_PARAM_RULES`) slices
every ``embed`` dimension over the data axes as well: between steps a
rank holds the ``(data, model)`` slice of each such leaf and of its
optimizer moments (:func:`shard_params` with ``data=``).  The step
gathers each data-sliced leaf over the data group into the rank's model
slice at its start (:func:`gather_from_data`), runs the data x model
step unchanged on those tensors, and keeps the rank's slice of each
leaf's summed clipped gradient (:func:`reduce_scatter_to_data`, in
``clipping.sync_grads``); the noise is the rank's slice of the one full
draw (``clipping.add_noise``).  A leaf whose ``embed`` dimension the
data degree does not divide stays replicated over data (the
``shapes_tree`` rule).  The values are the replicated step's: the
gather sums zero-padded slices (exact), the gradient sum is the same
all-reduce, and every later operation is elementwise.

Every one is a sum all-reduce of its group (the gathers sum
zero-padded slices, exact; the reduce-scatters all-reduce and keep the
slice): one ``_c10d_functional.all_reduce`` node a move, in a fixed
order, which the verifier's model and data halves read, and the one
collective gloo runs on CUDA tensors.  A gather or a reduce-scatter so
moves the full tensor, about twice a ring all-gather's or
reduce-scatter's bytes; ``all_gather_tensor`` /
``reduce_scatter_tensor`` under NCCL and the moves' prices in the plan
are ROADMAP.md item 14 part 3.

A param group (a layer's param dict) may mix sliced and replicated
leaves: a row-sharded layer's bias added once after the sum over
``model`` (xLSTM's ``wif``), sLSTM's gate bias ``b`` beside its
head-sliced ``R``.  Such a group is sliced: its norm² on a rank is
partial and summed over ``model`` once.  Its replicated leaves'
per-example gradients are whole on every rank, and model rank 0 alone
counts them in that partial (:meth:`ModelShard.counts`).
:data:`COLL_STATS` counts the calls and bytes by axis and, when
``timing`` is on, the host time; FSDP's param gathers are counted under
``data`` and again on their own (``COLL_STATS.gather``), so that the
gather is told apart from the gradient sum.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import torch

from repro_torch.core.costmodel import DATA_AXIS_NAMES
from repro_torch.tree import get_subtree, leaf_paths, set_subtree, tree_map

# Deferred model-axis work names this ROADMAP item.
DEFERRED = "ROADMAP.md item 14 part 3"

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
    axis stay replicated).  ``fsdp=True`` takes :data:`FSDP_PARAM_RULES`
    (``embed`` over the data axes too), over a mesh spec or a live
    ``DeviceMesh`` alike."""
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


def model_dims(spec) -> tuple:
    """The dimensions of a leaf's spec that name the ``model`` axis."""
    out = []
    for i, m in enumerate(spec or ()):
        ms = (m,) if isinstance(m, str) else tuple(m or ())
        if "model" in ms:
            out.append(i)
    return tuple(out)


def data_dims(spec) -> tuple:
    """The dimensions of a leaf's spec that name a data axis (FSDP's
    ``embed`` dimensions: ``"data"`` or ``("pod", "data")``)."""
    out = []
    for i, m in enumerate(spec or ()):
        ms = (m,) if isinstance(m, str) else tuple(m or ())
        if any(a in DATA_AXIS_NAMES for a in ms):
            out.append(i)
    return tuple(out)


def is_sharded(spec) -> bool:
    return bool(model_dims(spec))


def local_shape(shape, spec, size: int, data_size: int = 1) -> tuple:
    """A leaf's shape on one rank of a model axis of ``size`` (and, under
    FSDP, a data group of ``data_size``)."""
    out = list(shape)
    for i in model_dims(spec):
        out[i] //= size
    for i in data_dims(spec):
        out[i] //= data_size
    return tuple(out)


# ---------------------------------------------------------------------------
# Model-axis execution


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """One rank's place on the model axis: the process group the partial
    sums cross, this rank's index in it, the axis size, and the param
    spec tree (which leaves are sliced, on which dimension)."""

    group: Any
    rank: int
    size: int
    specs: Any = None

    def sharded_path(self, path: tuple) -> bool:
        """Whether the param group at ``path`` (a layer's param dict, or
        one leaf) is sliced over the model axis: any leaf of it is."""
        sub = get_subtree(self.specs, path)
        if isinstance(sub, dict):
            return any(is_sharded(get_subtree(sub, p))
                       for p in leaf_paths(sub))
        return is_sharded(sub)

    def counts(self, path: tuple, key: tuple) -> bool:
        """Whether this rank counts leaf ``key`` (a path inside the group)
        of the group at ``path`` in the group's norm²: every leaf of a
        replicated group and every sliced leaf, on each rank; a
        replicated leaf of a sliced group, whose per-example gradient is
        whole on every rank, on model rank 0 only, so that the group's
        one sum over ``model`` counts it once."""
        return (self.rank == 0 or not self.sharded_path(path)
                or self.sharded_path(tuple(path) + tuple(key)))

    def run(self, n: int) -> tuple:
        """``[lo, hi)``: this rank's contiguous run of ``n`` rows sliced
        over the axis (the experts of an ``"expert"``-sliced MoE layer:
        ``[r·E/M, (r+1)·E/M)``)."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


class CollStats:
    """Model- and data-axis collectives of the step: calls and payload
    bytes by axis, and (``timing = True``: each collective synchronized
    and timed on the host clock) seconds by axis."""

    def __init__(self):
        self.timing = False
        self.reset()

    def reset(self):
        self.calls = {"model": 0, "data": 0}
        self.bytes = {"model": 0, "data": 0}
        self.seconds = {"model": 0.0, "data": 0.0}
        # FSDP's param gathers, also counted under "data" above.
        self.gather = {"calls": 0, "bytes": 0, "seconds": 0.0}


COLL_STATS = CollStats()

_ACTIVE: list = []


@contextlib.contextmanager
def model_parallel(shard: ModelShard | None):
    """Run the block with ``shard`` as the active model group (``None``
    or a size-1 axis: nothing changes)."""
    if shard is None or shard.size == 1:
        yield
        return
    _ACTIVE.append(shard)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> ModelShard | None:
    """The model group in effect, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


_DATA: list = []


@contextlib.contextmanager
def data_parallel(shard):
    """Run the block with ``shard`` (a ``clipping.DataShard``: its group,
    rank and size) as the active data group (``None`` or a size-1 group:
    nothing changes).  A layer whose forward couples the examples of
    the global batch (the MoE dispatch's global capacity) reads it to
    keep the single-device semantics on a data rank."""
    if shard is None or shard.size == 1:
        yield
        return
    _DATA.append(shard)
    try:
        yield
    finally:
        _DATA.pop()


def active_data():
    """The data group in effect (a ``clipping.DataShard``), or ``None``."""
    return _DATA[-1] if _DATA else None


def split(local: int, full: int) -> bool:
    """Whether a dimension of full size ``full`` arrives sliced (size
    ``local``) over the active model group."""
    ms = active()
    if ms is None or local == full:
        return False
    if local * ms.size != full:
        raise ValueError(f"a dimension of {full} arrived as {local} on a "
                         f"model axis of {ms.size}")
    return True


def all_reduce(t, group, op: str = "sum", axis: str = "model",
               gather: bool = False):
    """A functional all-reduce over ``group`` (one graph node when traced),
    counted in :data:`COLL_STATS` under ``axis`` (and, ``gather``: an
    FSDP param gather, under ``COLL_STATS.gather`` too)."""
    import torch.distributed._functional_collectives as funcol
    st = COLL_STATS
    nbytes = t.numel() * t.element_size()
    st.calls[axis] += 1
    st.bytes[axis] += nbytes
    if gather:
        st.gather["calls"] += 1
        st.gather["bytes"] += nbytes
    if not st.timing:
        return funcol.wait_tensor(funcol.all_reduce(t, op, group))
    sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = funcol.wait_tensor(funcol.all_reduce(t, op, group))
    sync()
    dt = time.perf_counter() - t0
    st.seconds[axis] += dt
    if gather:
        st.gather["seconds"] += dt
    return out


def _pad_slice(t, dim: int, ms: ModelShard):
    """This rank's slice ``t`` placed in zeros of the full extent."""
    n = t.shape[dim]
    lo, hi = list(t.shape), list(t.shape)
    lo[dim] = n * ms.rank
    hi[dim] = n * (ms.size - ms.rank - 1)
    return torch.cat([t.new_zeros(lo), t, t.new_zeros(hi)], dim=dim)


def _own(t, dim: int, ms: ModelShard):
    n = t.shape[dim] // ms.size
    return t.narrow(dim, ms.rank * n, n)


def own(t, dim: int):
    """This rank's contiguous slice along ``dim`` of a tensor whole on
    every rank of the active model group (a view; ``t`` itself without
    one)."""
    ms = active()
    return t if ms is None else _own(t, dim % t.ndim, ms)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(x, ms, param):
        return torch.ops.aten.alias(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ms, ctx.param = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        if ctx.param:
            from repro_torch.analysis.markers import tag
            g = tag(g, kind="partial_grad")
        return all_reduce(g, ctx.ms.group), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(x, ms):
        return all_reduce(x, ms.group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, sharded_consumer, ms):
        return all_reduce(_pad_slice(x, dim, ms), ms.group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.sharded, ctx.ms = inputs

    @staticmethod
    def backward(ctx, g):
        if ctx.sharded:
            g = all_reduce(g, ctx.ms.group)
        return _own(g, ctx.dim, ctx.ms).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, ms):
        return _own(all_reduce(x, ms.group), dim, ms).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.dim, ctx.ms = inputs

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_pad_slice(g, ctx.dim, ctx.ms), ctx.ms.group), \
            None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(x, ms):
        return all_reduce(x, ms.group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ms = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ms.group), None


def copy_to_model(x, *, param: bool = False):
    """Identity forward; the cotangent summed over ``model`` backward.
    ``param``: ``x`` is a replicated parameter read by this rank's slice
    of a sharded activation (qk-norm's query scale on sliced heads), so
    its gradient from autograd (a weighted backward's, ``naive``'s) is a
    partial sum, and the sum over ``model`` completes it; marked
    ``partial_grad`` for the verifier's model half, which otherwise
    reads a sum of a value without the example axis as a clipped
    contribution reduced over ``model``."""
    ms = active()
    return x if ms is None else _Copy.apply(x, ms, param)


def reduce_from_model(x):
    """Summed over ``model`` forward; identity backward."""
    ms = active()
    return x if ms is None else _Reduce.apply(x, ms)


def reduce_scatter_from_model(x, dim: int):
    """A row-sharded layer's partial output ``x`` (whole extent) summed
    over ``model``, and this rank's contiguous slice along ``dim`` kept
    (the heads its recurrence runs on).  Backward: the slice's cotangent
    zero-padded and summed over ``model``, a gather: the partial product
    feeds every rank's slice, so its cotangent is the whole one (an
    identity backward would hand the layer its own heads' only)."""
    ms = active()
    if ms is None:
        return x
    return _Scatter.apply(x, dim % x.ndim, ms)


def sum_over_model(x):
    """A partial statistic of this rank's slice of an activation (an
    RMSNorm's f32 sum of squares over a sliced width) summed over
    ``model``.  Its consumers are the rank's slices, so its cotangent is
    partial too and is summed again in the backward."""
    ms = active()
    return x if ms is None else _SumBoth.apply(x, ms)


def gather_from_model(x, dim: int, *, sharded_consumer: bool = False):
    """The full tensor from every rank's slice along ``dim``.  Backward:
    this rank's slice of the cotangent (a replicated consumer, whose
    cotangent is whole on every rank) or, ``sharded_consumer``, of the
    cotangent summed over ``model`` (a reduce-scatter: a column-sharded
    consumer's is partial)."""
    ms = active()
    if ms is None:
        return x
    return _Gather.apply(x, dim % x.ndim, sharded_consumer, ms)


def gather_from_data(t, dim: int, ds):
    """FSDP's param gather: the rank's data slice ``t`` of a leaf joined
    along ``dim`` over the data group ``ds`` (a ``clipping.DataShard``):
    a sum all-reduce of the zero-padded slices (exact), marked
    ``fsdp_gather`` for the verifier, which reads it as a layout move
    and not as a sum over examples."""
    if ds is None or ds.size == 1:
        return t
    from repro_torch.analysis.markers import tag
    out = all_reduce(_pad_slice(t, dim % t.ndim, ds), ds.group, axis="data",
                     gather=True)
    return tag(out, kind="fsdp_gather", dim=int(dim % t.ndim))


def gather_over_data(params, ds):
    """Every param the data group ``ds`` slices (FSDP: ``ds.specs``;
    ``None`` without FSDP) gathered into this rank's model slice
    (:func:`gather_from_data`, in the params' order, the same on every
    rank); the rest kept."""
    if ds is None:
        return params

    def whole(t, spec):
        dims = data_dims(spec)
        return gather_from_data(t, dims[0], ds) if dims else t
    return tree_map(whole, params, ds.specs)


def reduce_scatter_to_data(t, dim: int, ds):
    """FSDP's gradient sum: ``t`` (a leaf's clipped sum, whole along
    ``dim``) summed over the data group ``ds``, and this rank's slice
    along ``dim`` kept (a copy, so the whole sum is freed)."""
    if ds is None or ds.size == 1:
        return t
    return _own(all_reduce(t, ds.group, axis="data"), dim % t.ndim,
                ds).clone()


def parallel_xent(lg, labels, *, vocab_valid: int | None = None):
    """Per-position ``logsumexp(lg) - lg[label]`` over logits ``lg``
    (f32, ``(..., V/M)``: this rank's contiguous slice of the
    vocabulary) without gathering them: the max, the sum of
    exponentials and the target logit are each summed over ``model``.
    ``vocab_valid`` masks padded vocabulary rows (global index)."""
    ms = active()
    Vl = lg.shape[-1]
    off = ms.rank * Vl
    if vocab_valid is not None and vocab_valid < Vl * ms.size:
        pad = torch.arange(off, off + Vl, device=lg.device) >= vocab_valid
        lg = lg.masked_fill(pad, -1e30)
    m = all_reduce(lg.detach().amax(dim=-1), ms.group, "max")
    se = reduce_from_model(torch.exp(lg - m[..., None]).sum(dim=-1))
    lid = labels.long() - off
    mine = (lid >= 0) & (lid < Vl)
    ll = torch.gather(lg, -1, lid.clamp(0, Vl - 1)[..., None])[..., 0]
    ll = reduce_from_model(torch.where(mine, ll, torch.zeros_like(ll)))
    return torch.log(se) + m - ll


def lookup(table, ids):
    """``(local ids, in-shard mask)`` of a lookup in this rank's slice
    of a vocabulary-sharded table: an id in the shard becomes its row
    there, any other id row 0 (which the mask zeroes)."""
    ms = active()
    Vl = table.shape[0]
    lid = ids.long() - ms.rank * Vl
    mine = (lid >= 0) & (lid < Vl)
    lid = torch.where(mine, lid, torch.zeros_like(lid))
    return lid, mine


def model_shard_of(mesh, specs=None) -> ModelShard | None:
    """This rank's :class:`ModelShard` of a live ``DeviceMesh`` (``None``
    without a model axis of size > 1)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return None
    dim = names.index("model")
    if tuple(mesh.shape)[dim] == 1:
        return None
    return ModelShard(mesh.get_group(dim), mesh.get_local_rank(dim),
                      tuple(mesh.shape)[dim], specs)


def _model_of(mesh_or_shard, specs):
    if mesh_or_shard is None or isinstance(mesh_or_shard, ModelShard):
        return mesh_or_shard
    return model_shard_of(mesh_or_shard, specs)


def _cuts(spec, ms, ds) -> list:
    """``(dim, shard)`` of each dimension of a leaf sliced over the model
    group ``ms`` or (FSDP) the data group ``ds``."""
    out = [] if ms is None else [(d, ms) for d in model_dims(spec)]
    if ds is not None and ds.size > 1:
        out += [(d, ds) for d in data_dims(spec)]
    return out


def shard_params(params, specs, mesh, *, data=None):
    """This rank's slices of a tree of whole tensors: every leaf whose
    spec names ``model`` cut to its contiguous part of that dimension
    (a copy), and with ``data`` (a ``clipping.DataShard``: FSDP) every
    dimension whose spec names a data axis cut to the rank's part too;
    the rest kept.  ``mesh``: a live ``DeviceMesh``, a
    :class:`ModelShard` or ``None`` (no model axis)."""
    ms = _model_of(mesh, specs)
    if ms is None and (data is None or data.size == 1):
        return params

    def cut(t, spec):
        cuts = _cuts(spec, ms, data)
        for d, sh in cuts:
            t = _own(t, d, sh)
        return t.contiguous().clone() if cuts else t
    return tree_map(cut, params, specs)


def gather_params(params, specs, mesh, *, data=None):
    """Whole tensors again from every rank's slices (a collective: every
    rank of the model group, and with ``data`` of the data group, calls;
    all get the whole tree)."""
    import torch.distributed as dist
    ms = _model_of(mesh, specs)
    if ms is None and (data is None or data.size == 1):
        return params

    def whole(t, spec):
        for d, sh in _cuts(spec, ms, data):
            parts = [torch.empty_like(t) for _ in range(sh.size)]
            dist.all_gather(parts, t.contiguous(), group=sh.group)
            t = torch.cat(parts, dim=d)
        return t
    return tree_map(whole, params, specs)


def derived_specs(tree, param_shapes, param_specs):
    """Specs for a tree shaped like optimizer state (the port's form of
    the JAX engine's ``_derived_opt_sharding``): a leaf shaped like a
    param whose spec is unambiguous (every param of that shape has one
    spec) takes it; scalars and ambiguous shapes stay replicated."""
    by_shape: dict = {}
    for p in leaf_paths(param_shapes):
        shape = tuple(get_subtree(param_shapes, p).shape)
        spec = tuple(get_subtree(param_specs, p))
        cur = by_shape.get(shape, spec)
        by_shape[shape] = cur if cur == spec else None

    def spec_of(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        return (by_shape.get(shape) or ()) if shape else ()
    out = {}
    for p in leaf_paths(tree):
        out = set_subtree(out, p, spec_of(get_subtree(tree, p)))
    return out
