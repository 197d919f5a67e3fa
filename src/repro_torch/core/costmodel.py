"""Per-layer execution planner for the DP-SGD pipeline.

The paper's empirical finding is that which per-example-gradient strategy
wins depends on layer geometry (depth, width, batch, kernel size).  This
module turns that into an analytic *per-layer* plan: from the tapped
layers' :class:`~repro_torch.core.tapper.LayerMeta` and capture/output
shapes (one shape-only probe on ``device="meta"``) it chooses

  norm phase (per layer)
    * ``gram``   — Gram-trick ghost norm, no per-example gradient
                   materialization (dense: FLOPs ≈ 2·B·T²·(Din+Dout);
                   conv via im2col: 2·B·T²·(C·K/g + D/g)·g);
    * ``stream`` / ``pe`` — materialize per-example grads then reduce
                   (dense: ≈ 4·B·T·Din·Dout; conv: ≈ 4·B·T·(C·K/g)·(D/g)·g),
                   bounded by a peak-memory budget;
    * ``rank1``  — no sequence axis: ‖g_b‖² = ‖x_b‖²·‖δy_b‖² exactly;

  sum phase (per parameter group)
    * ``stash``    — the norm already materialized per-example grads;
                     keep them and form Σ_b w_b·g_b by a (B,)-weighted
                     reduction (zero recompute);
    * ``contrib``  — weighted per-layer contraction from the captures
                     (the book-keeping path);
    * ``backward`` — take this group's gradient from one shared weighted
                     backward pass, chosen only when the contractions it
                     replaces pay for the backward's fixed cost.

An embedding gather picks ``segsum`` / ``gram`` / ``pe``
(:func:`embed_norm_method`); an elementwise affine (norm scale)
materializes its tiny per-example grads; an attention block tapped as one
``"attn"`` layer pays a layer-local recompute and picks ``ghost`` (each
projection's Gram norm, then a second recompute for the contraction) or
``pe`` (materialize every projection's per-example grad and stash it);
a ``local_vjp`` layer materializes its per-example grads (stashed when
they fit the budget; a standalone contraction re-runs the vmapped VJP
and is charged :data:`LOCAL_VJP_CONTRIB_PENALTY`).
Scanned layers multiply the per-application cost by the stack; shared
scanned dense/scale layers fold the stack into the sequence axis.  Taps
that share one parameter form a group with a ``norm_mode``: ``single``, ``tied`` (embedding + transposed
LM head: both norms plus the cross term) or ``group_pe`` (materialize the
summed per-example grad).

Under stale clipping the Gram-realized dense/conv layers of single-tap
groups are marked ``fused``: their norm and contribution come from one
``gram_norm_fused`` pass.

The decision rules and constants are the JAX package's
(``repro.core.costmodel``), so the two packages plan alike under the same
constants.  ``calibration=`` prices with measured constants
(:mod:`repro_torch.calibrate`; ``None`` takes the calibration registered
for this process's device and mesh, ``"analytic"`` the analytic table),
and the calibration's digest is part of every plan's identity: the cache
key, the fingerprint and the plan store.

Mesh-aware planning: with ``mesh=`` (a live ``DeviceMesh``, a
``"data:8,model:2"`` spec, an axes mapping or an ``(("data", 8), ...)``
tuple; :func:`mesh_axes`) every per-layer estimate is *per device*: the
batch-linear FLOPs and scratch shrink by the data-parallel degree (the
memory budget is one device's), and each candidate realization is also
charged the collective bytes it induces, priced per mesh axis
(:meth:`CostConstants.coll_price`): a non-materializing norm all-reduces
the (B,) scalar norms, a stash puts per-example gradients on the
gradient-sync ring, every group pays its parameter-sized sync once (a
shared weighted backward twice), and a tensor-sharded layer psums its
partial norms over the model axes.  A spec plans for a topology this
process need not have (no devices are touched).  The mesh is part of the
fingerprint, the cache key and the payload: a plan built for another
topology fails loudly (:func:`check_plan_matches`).  FSDP
(``PrivacyEngine(fsdp=True)``) is not an input: its step does the same
work on the same tensors, so the plan and the fingerprint are those of
the step without it, and its param gathers over the data axes are not
priced, as the JAX package's planner does not price them (ROADMAP.md
item 14 part 3, "pricing the moves").
:func:`predicted_step_seconds` is what the engine's mispredict loop
compares measured step times against.
Plans are cached on (model identity, batch/param shapes, knobs,
calibration): steady-state training re-plans nothing and never
re-probes (:func:`get_plan`).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import pathlib
from collections import OrderedDict
from fnmatch import fnmatchcase
from typing import Any, Mapping

import torch

from repro_torch.core.tapper import LayerMeta, TensorSpec, is_multi, probe
from repro_torch.tree import get_subtree, leaf_paths

GRAM_CHUNK = 1024
STREAM_MEM_BUDGET = 2 << 30  # bytes of per-example-grad scratch we tolerate
BYTES = 4
# A weighted second backward costs ~2x the forward on top of the wgrad
# contractions it shares with `contrib`; expressed as a multiple of the
# total per-layer wgrad FLOPs (forward ≈ Σ wgrad, dx-chain ≈ Σ wgrad).
BACKWARD_FIXED_FACTOR = 2.0

# The JAX package's analytic fallback table, verbatim: it prices its TPU,
# not the H100, and is what the port plans with when no calibration
# (repro_torch.calibrate) is given or registered, so that uncalibrated
# plans equal the reference's.  Of the three only ``hbm_flops_per_byte``
# moves a single-device decision (the fused credit under stale clipping);
# the wire price moves decisions on a mesh and the FLOP rate only converts
# FLOP-equivalents into predicted seconds.
ANALYTIC_FALLBACK = {
    "collective_flops_per_byte": 512.0,
    "hbm_flops_per_byte": 128.0,
    "flops_per_second": 197.0e12,
}


# Mesh axes treated as pure data parallelism (batch-sharded); every other
# axis is model parallelism.  The JAX package's names.
DATA_AXIS_NAMES = ("pod", "data", "batch")


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """The rates one planning pass prices against, plus provenance
    (``calibration`` is a measured calibration's digest, "" when
    analytic; it is part of every plan's identity).

    ``collective_flops_per_byte_by_axis`` holds the per-mesh-axis wire
    prices (``(("data", p), ...)``) when the calibration measured them;
    :meth:`coll_price` is the per-axis lookup every collective term goes
    through, the scalar being the fallback for unmeasured axes."""

    collective_flops_per_byte: float
    hbm_flops_per_byte: float
    flops_per_second: float
    source: str = "analytic"
    calibration: str = ""
    collective_flops_per_byte_by_axis: tuple = ()

    def coll_price(self, axis: str) -> float:
        """Wire price (FLOP-equivalents a byte) of traffic crossing
        ``axis``: its measured rate, else the scalar constant."""
        for name, price in self.collective_flops_per_byte_by_axis:
            if name == axis:
                return price
        return self.collective_flops_per_byte


ANALYTIC_CONSTANTS = CostConstants(
    collective_flops_per_byte=ANALYTIC_FALLBACK["collective_flops_per_byte"],
    hbm_flops_per_byte=ANALYTIC_FALLBACK["hbm_flops_per_byte"],
    flops_per_second=ANALYTIC_FALLBACK["flops_per_second"])

# contrib for a local_vjp layer replays the layer's VJP once *per
# example* under vmap — for scan-based layers (SSM recurrences) the
# vmapped per-example re-run costs far more than the batched backward's
# single pass, so its contraction is charged a premium over the layer's
# wgrad share.  This is what can tip a local_vjp-dominated model into the
# shared weighted backward.  The JAX package's constant.
LOCAL_VJP_CONTRIB_PENALTY = 4.0
PLAN_CACHE_SIZE = 16


# ---------------------------------------------------------------------------
# Mesh normalization: every planner entry point takes ``mesh`` as a live
# ``torch.distributed.device_mesh.DeviceMesh``, a "data:8,model:2" spec,
# an axes mapping or an (("data", 8), ...) tuple, all normalized to the
# tuple form (hashable, JSON-able, fingerprintable).


def _drop_unit_axes(axes: tuple) -> tuple:
    """Size-1 axes are topology no-ops: ``(("data", 8), ("model", 1))``
    runs as ``(("data", 8),)``, so they are normalized out and a stored
    plan keyed on one spelling does not fail against the other."""
    return tuple((n, s) for n, s in axes if int(s) != 1)


def mesh_axes(mesh) -> tuple:
    """Normalize a mesh description to ``(("data", 8), ("model", 2))``,
    size-1 axes dropped (:func:`_drop_unit_axes`): the JAX package's
    rule, which plans and calibration blobs are keyed by."""
    if mesh is None:
        return ()
    if isinstance(mesh, str):
        out = []
        for part in mesh.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, size = part.partition(":")
            if not sep or not size.strip().isdigit():
                raise ValueError(
                    f"bad mesh spec {mesh!r}; expected 'data:8' or "
                    f"'data:4,model:2'")
            out.append((name.strip(), int(size)))
        pairs = out
    elif isinstance(mesh, Mapping):
        pairs = mesh.items()
    elif getattr(mesh, "mesh_dim_names", None) is not None:   # DeviceMesh
        pairs = zip(mesh.mesh_dim_names, tuple(mesh.shape))
    else:
        pairs = mesh
    return _drop_unit_axes(tuple((str(n), int(s)) for n, s in pairs))


def mesh_data_size(axes: tuple) -> int:
    d = 1
    for name, size in axes:
        if name in DATA_AXIS_NAMES:
            d *= int(size)
    return d


def mesh_data_axes(axes: tuple) -> tuple:
    """The data-parallel (batch-sharded) axes of a normalized mesh."""
    return tuple((n, s) for n, s in axes if n in DATA_AXIS_NAMES)


def mesh_model_axes(axes: tuple) -> tuple:
    """The model-parallel (tensor-sharded) axes of a normalized mesh."""
    return tuple((n, s) for n, s in axes if n not in DATA_AXIS_NAMES)


def mesh_model_size(axes: tuple) -> int:
    m = 1
    for _, size in mesh_model_axes(axes):
        m *= int(size)
    return m


def format_mesh(axes: tuple) -> str:
    return ("x".join(f"{n}={s}" for n, s in axes)) if axes else "(no mesh)"


def _ring(d: int) -> float:
    """Per-device bytes-on-the-wire multiplier of a ring all-reduce."""
    return 2.0 * (d - 1) / d if d > 1 else 0.0


def _resolve_calibration(calibration, mesh=()):
    """An explicit Calibration wins; ``None`` consults the registry for
    this process's device and ``mesh``; ``"analytic"`` asks for the
    analytic table.  Imported lazily — repro_torch.calibrate imports this
    module."""
    if isinstance(calibration, str):
        if calibration == "analytic":
            return None
        raise TypeError(
            f"calibration={calibration!r}: the planner takes a Calibration, "
            f"None or 'analytic' (PrivacyEngine resolves paths and "
            f"'measure')")
    if calibration is not None:
        return calibration
    from repro_torch.calibrate import table
    return table.lookup(mesh=mesh_axes(mesh))


def resolve_cost_constants(calibration=None, mesh=None) -> CostConstants:
    """The :class:`CostConstants` a planning pass for ``mesh`` prices
    against: the given (or registered) calibration's measured rates, or
    :data:`ANALYTIC_CONSTANTS`.  Every measured mesh axis is priced on its
    own; a calibration that measured no collective (one device) keeps the
    analytic wire price."""
    calib = _resolve_calibration(calibration, mesh)
    if calib is None:
        return ANALYTIC_CONSTANTS
    if calib.collective_bytes_per_second:
        by_axis = tuple(
            (axis, calib.collective_flops_per_byte(axis))
            for axis in sorted(calib.collective_bytes_per_second))
        coll = max(price for _, price in by_axis)
    else:
        by_axis = ()
        coll = ANALYTIC_FALLBACK["collective_flops_per_byte"]
    return CostConstants(
        collective_flops_per_byte=coll,
        hbm_flops_per_byte=calib.hbm_flops_per_byte(),
        flops_per_second=calib.flops_per_second,
        source=calib.source, calibration=calib.digest(),
        collective_flops_per_byte_by_axis=by_axis)


# ---------------------------------------------------------------------------
# Scalar cost models (the stable, unit-tested crossover formulas)


def dense_norm_method(T: int, Di: int, Do: int, B: int,
                      mem_budget: int = STREAM_MEM_BUDGET) -> str:
    if T == 1:
        return "rank1"
    gram_flops = 2 * T * T * (Di + Do)
    stream_flops = 4 * T * Di * Do
    stream_mem = B * Di * Do * BYTES
    if stream_flops < gram_flops and stream_mem <= mem_budget:
        return "stream"
    return "gram"


def seg_norm_method(S: int, Di: int, Do: int, B: int, G: int,
                    mem_budget: int = STREAM_MEM_BUDGET) -> str:
    """MoE expert slots: gram is O(G·S²·(Di+Do+B)), stream is
    O(G·B·Di·Do) FLOPs with (B·Di·Do) scratch per expert-group step (the
    reference's prices, kept for plan parity: the stream realization
    does 2·G·B·S·Di·Do, ``kinds.seg_dense_norm_sq``)."""
    gram_flops = G * S * S * (Di + Do + B)
    stream_flops = G * B * Di * Do
    stream_mem = B * Di * Do * BYTES
    if stream_flops < gram_flops and stream_mem <= mem_budget:
        return "stream"
    return "gram"


EMBED_PE_BUDGET = 32 << 20  # materialize embed pe grads below this


def embed_norm_method(T: int, D: int, B: int | None = None,
                      vocab: int | None = None,
                      pe_budget: int = EMBED_PE_BUDGET) -> str:
    """segsum is O(T·logT + T·D); the same-token-masked Gram is O(T²·D);
    materializing the (B, V, D) per-example grad (``pe``) costs O(B·V·D)
    but needs no sort and makes the sum phase free (stash), so it is
    picked whenever the table is small enough for a hard memory bound."""
    if B is not None and vocab is not None \
            and B * vocab * D * BYTES <= pe_budget:
        return "pe"
    return "gram" if T <= 32 else "segsum"


def conv_norm_method(T: int, C: int, D: int, K: int, B: int, groups: int = 1,
                     mem_budget: int = STREAM_MEM_BUDGET) -> str:
    """Conv ghost-norm (im2col Gram over T output positions with per-group
    features F = (C/g)·K) vs materializing the per-example weight gradient
    (the paper's Algorithm 2).  Early layers (large spatial T, few
    channels) want ``pe``; late layers (tiny T, wide channels) want
    ``ghost`` — the per-layer mix of Bu et al. (2022).

    ``T`` = output positions, ``K`` = prod(kernel spatial dims).
    """
    g = max(groups, 1)
    F, Dg = (C // g) * K, D // g
    ghost_flops = 2 * T * T * (F + Dg) * g
    pe_flops = 4 * T * F * Dg * g
    pe_mem = B * D * (C // g) * K * BYTES
    if pe_flops < ghost_flops and pe_mem <= mem_budget:
        return "pe"
    return "ghost"


# ---------------------------------------------------------------------------
# Plan structures


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Per-tap decision + cost estimates, per device: with no mesh that is
    the whole batch; on a mesh the batch-linear FLOPs and scratch are for
    one device's batch shard, and ``coll_bytes`` is this device's share
    of the collective traffic the chosen realization induces a step."""

    name: str
    kind: str
    norm_method: str          # gram|stream|rank1|pallas|ghost|pe|segsum
    stash: bool               # norm phase materializes per-example grads
    norm_flops: float
    contrib_flops: float
    wgrad_flops: float        # this layer's share of a weighted backward
    stash_bytes: float = 0.0  # size of the (B, *param) grads if stashed
    fallback_norm: str = ""   # best no-stash method (cumulative demotion)
    fused: bool = False       # stale mode: single-pass gram_norm_fused
    param_bytes: float = 0.0  # parameter bytes (grad-sync unit, per shard)
    coll_bytes: float = 0.0   # predicted collective bytes per step
    ex_per_dev: float = 0.0   # examples on one device's batch shard
    model_shards: int = 1     # tensor-parallel degree this layer splits over
    coll_bytes_by_axis: tuple = ()  # (("data", bytes), ...) per mesh axis


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One parameter (tree path); >1 member means shared/tied taps."""

    path: tuple
    members: tuple                 # tap names
    norm_mode: str                 # single | tied | group_pe
    sum_method: str                # stash | contrib | backward


PLAN_FORMAT_VERSION = 4   # v4: the mesh and the per-axis collective bytes

_META_FIELDS = ("kind", "path", "param_key", "bias_key", "w_transposed",
                "segmented", "scanned", "shared", "static")


def _retuple(x):
    """JSON arrays back to tuples (paths, kernel shapes, strides...)."""
    if isinstance(x, list):
        return tuple(_retuple(v) for v in x)
    if isinstance(x, dict):
        return {k: _retuple(v) for k, v in x.items()}
    return x


def _jsonable(x):
    if isinstance(x, tuple):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True, eq=False)
class ExecPlan:
    """The per-layer execution plan — a first-class, frozen value.

    Inspect with :meth:`explain` (per-layer table of chosen norm/sum
    realizations with predicted FLOPs/bytes); serialize with
    :meth:`to_json` / :meth:`from_json`, keyed on :attr:`fingerprint`
    (model + batch/param shapes + planner knobs + the port's sources).  A
    deserialized plan executes without re-probing; its layer names are
    checked against the live capture pass, so a stale plan fails loudly.
    """

    groups: tuple
    layers: dict                   # name -> LayerPlan
    metas: dict                    # name -> LayerMeta
    needs_backward: bool
    total_norm_flops: float
    total_contrib_flops: float
    tap_shapes: dict = dataclasses.field(default_factory=dict)
    capture_bytes: float = 0.0     # captures + outputs + cotangents
    fingerprint: str = ""
    mesh: tuple = ()               # (("data", 8), ...) this plan targets
    batch_sig: tuple = ()          # batch shapes the plan was built on
    total_coll_bytes: float = 0.0  # per-device collective bytes per step
    total_coll_bytes_by_axis: tuple = ()  # (("data", bytes), ...)
    clip_mode: str = "flat"        # flat | per_layer | stale
    calibration: str = ""          # calibration digest ("" = analytic)
    _anchor: Any = None            # pins apply_fn identity while cached

    # -- inspection --------------------------------------------------------

    def sum_methods(self) -> dict:
        return {n: g.sum_method for g in self.groups for n in g.members}

    def realizations(self) -> dict:
        """name -> (norm method, sum method or "fused"): what a step
        executes, which two plans priced under different constants may
        share (the mispredict loop's ``plan_changed``)."""
        sums = self.sum_methods()
        return {n: (lp.norm_method, "fused" if lp.fused else sums[n])
                for n, lp in self.layers.items()}

    def peak_stash_bytes(self) -> float:
        """Stashes coexist from the norm phase to the sum phase; a group's
        members share one parameter, so it stashes one (B, *param) tree."""
        return sum(max(self.layers[n].stash_bytes for n in g.members)
                   for g in self.groups if g.sum_method == "stash")

    def explain(self) -> str:
        """Per-layer table of the chosen realizations and predicted costs
        (per device; ``coll MB`` is the collective traffic the realization
        induces on the plan's mesh)."""
        sums = self.sum_methods()
        header = (f"{'layer':<28} {'kind':<10} {'norm':<8} {'sum':<9} "
                  f"{'norm MF':>9} {'sum MF':>9} {'stash MB':>9} "
                  f"{'coll MB':>9}")
        lines = [header, "-" * len(header)]
        for n, lp in self.layers.items():
            stash_mb = lp.stash_bytes / 2**20 if lp.stash else 0.0
            sum_m = "fused" if lp.fused else sums.get(n, "?")
            lines.append(
                f"{n:<28} {lp.kind:<10} {lp.norm_method:<8} "
                f"{sum_m:<9} {lp.norm_flops / 1e6:>9.2f} "
                f"{lp.contrib_flops / 1e6:>9.2f} {stash_mb:>9.2f} "
                f"{lp.coll_bytes / 2**20:>9.2f}")
        passes = ("2 fwd + 2 bwd (shared weighted backward)"
                  if self.needs_backward else "1 fwd + 1 bwd")
        n_fused = sum(lp.fused for lp in self.layers.values())
        lines.append("-" * len(header))
        lines.append(
            f"steady-state passes: {passes}; total norm "
            f"{self.total_norm_flops / 1e6:.2f} MF, contrib "
            f"{self.total_contrib_flops / 1e6:.2f} MF; captures "
            f"{self.capture_bytes / 2**20:.2f} MB, peak stash "
            f"{self.peak_stash_bytes() / 2**20:.2f} MB")
        lines.append(
            f"clipping mode: {self.clip_mode}"
            + (f" ({n_fused} fused single-pass norm+contrib layer"
               f"{'s' if n_fused != 1 else ''})" if n_fused else ""))
        per_axis = ("; per axis: " + ", ".join(
            f"{a}={b / 2**20:.2f} MB"
            for a, b in self.total_coll_bytes_by_axis)
            if self.total_coll_bytes_by_axis else "")
        lines.append(
            f"mesh: {format_mesh(self.mesh)}; predicted collectives "
            f"{self.total_coll_bytes / 2**20:.2f} MB/step/device"
            + per_axis)
        lines.append(
            f"cost constants: measured calibration {self.calibration}"
            if self.calibration else
            "cost constants: analytic fallback (no calibration)")
        if self.fingerprint:
            lines.append(f"fingerprint: {self.fingerprint}")
        return "\n".join(lines)

    # -- serialization -----------------------------------------------------

    def to_payload(self) -> dict:
        metas = {n: {f: _jsonable(getattr(m, f)) for f in _META_FIELDS}
                 for n, m in self.metas.items()}
        return {
            "format": PLAN_FORMAT_VERSION,
            "fingerprint": self.fingerprint,
            "mesh": _jsonable(self.mesh),
            "batch_sig": _jsonable(self.batch_sig),
            "clip_mode": self.clip_mode,
            "needs_backward": self.needs_backward,
            "total_norm_flops": self.total_norm_flops,
            "total_contrib_flops": self.total_contrib_flops,
            "total_coll_bytes": self.total_coll_bytes,
            "total_coll_bytes_by_axis":
                _jsonable(self.total_coll_bytes_by_axis),
            "calibration": self.calibration,
            "capture_bytes": self.capture_bytes,
            "layers": {n: _jsonable(dataclasses.asdict(lp))
                       for n, lp in self.layers.items()},
            "groups": [{"path": list(g.path), "members": list(g.members),
                        "norm_mode": g.norm_mode,
                        "sum_method": g.sum_method} for g in self.groups],
            "metas": metas,
            "tap_shapes": {n: {"shape": list(s.shape),
                               "dtype": _dtype_name(s.dtype)}
                           for n, s in self.tap_shapes.items()},
        }

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_payload(), **json_kw)

    @classmethod
    def from_payload(cls, p: dict) -> "ExecPlan":
        if p.get("format") != PLAN_FORMAT_VERSION:
            raise ValueError(
                f"unsupported plan format {p.get('format')!r} "
                f"(this build reads {PLAN_FORMAT_VERSION})")
        layers = {n: LayerPlan(**{**d, "coll_bytes_by_axis": _retuple(
                      d["coll_bytes_by_axis"])})
                  for n, d in p["layers"].items()}
        groups = tuple(
            GroupPlan(tuple(g["path"]), tuple(g["members"]),
                      g["norm_mode"], g["sum_method"]) for g in p["groups"])
        metas = {n: LayerMeta(**{f: (_retuple(d[f]) if f in ("path", "static")
                                     else d[f]) for f in _META_FIELDS})
                 for n, d in p["metas"].items()}
        tap_shapes = {n: TensorSpec(tuple(s["shape"]),
                                    getattr(torch, s["dtype"]))
                      for n, s in p["tap_shapes"].items()}
        return cls(groups=groups, layers=layers, metas=metas,
                   needs_backward=p["needs_backward"],
                   total_norm_flops=p["total_norm_flops"],
                   total_contrib_flops=p["total_contrib_flops"],
                   tap_shapes=tap_shapes,
                   capture_bytes=p["capture_bytes"],
                   fingerprint=p["fingerprint"],
                   mesh=_retuple(p["mesh"]),
                   batch_sig=_retuple(p["batch_sig"]),
                   total_coll_bytes=p["total_coll_bytes"],
                   total_coll_bytes_by_axis=_retuple(
                       p["total_coll_bytes_by_axis"]),
                   clip_mode=p["clip_mode"],
                   calibration=p["calibration"])

    @classmethod
    def from_json(cls, s: str) -> "ExecPlan":
        return cls.from_payload(json.loads(s))

    def __eq__(self, other) -> bool:
        """Semantic equality: the serialized payload, so
        ``from_json(to_json(p)) == p``."""
        if not isinstance(other, ExecPlan):
            return NotImplemented
        return self.to_payload() == other.to_payload()


# ---------------------------------------------------------------------------
# Per-layer geometry + planning


def _prod(xs) -> int:
    return int(math.prod(int(x) for x in xs)) if xs else 1


def _tree_elems(tree) -> int:
    return sum(_prod(get_subtree(tree, q).shape) for q in leaf_paths(tree))


def _plan_layer(name: str, meta: LayerMeta, cap_sh: dict, dy_sh,
                *, norm_method: str, embed_method: str, conv_norm: str,
                mem_budget: int, vocab: int | None = None,
                params_sub=None, mesh: tuple = (), clip_mode: str = "flat",
                clip_fused: bool = True,
                cc: CostConstants = ANALYTIC_CONSTANTS) -> LayerPlan:
    """Costs for one tap.  Stacked (scanned) applications multiply the
    per-application cost; shared stacked dense layers fold the stack into
    the sequence axis first (matching kinds.apply_kind).

    The auto choice minimizes the *joint* norm + sum cost: a norm that
    materializes per-example grads makes the sum phase a free (B,)-weighted
    reduction over the stash, so ``stream``/``pe`` is charged once while
    ``gram``/``ghost`` is charged norm + contraction.

    On a mesh every estimate is per device (batch-linear terms use the
    per-device batch shard; the memory budget is one device's), and the
    candidates also pay their collective traffic in FLOP-equivalents:
    stash candidates put per-example grads on the wire, non-materializing
    norms all-reduce ``B`` scalars, tensor-sharded layers psum partial
    norms over the model axes."""
    if meta.kind not in ("dense", "conv", "embed", "scale", "attn",
                         "local_vjp"):
        raise ValueError(f"layer {name!r}: unknown kind {meta.kind!r}")
    k = meta.scanned
    dy_shape = tuple(dy_sh.shape)
    stack = _prod(dy_shape[:k])
    app_dy = dy_shape[k:]
    d = mesh_data_size(mesh)
    daxes = mesh_data_axes(mesh)
    maxes = mesh_model_axes(mesh)
    msize = mesh_model_size(mesh)

    def _shard(B: int) -> int:
        return max(1, -(-int(B) // d))

    def _data_wire(nbytes: float) -> float:
        # Bytes crossing the data-parallel ring(s), each axis at its own
        # price: a hierarchical all-reduce moves ring(s) bytes per axis.
        return sum(cc.coll_price(a) * nbytes * _ring(s) for a, s in daxes)

    def _model_wire(nbytes: float) -> float:
        # Bytes psum'd over the model axes: the partial-norm reduction of
        # tensor-sharded layers.
        return sum(cc.coll_price(a) * nbytes * _ring(s) for a, s in maxes)

    def _scal_cost(B: int, model_sharded: bool = False) -> float:
        # The all-reduce of the (B,) f32 per-example norms.  Per-layer
        # clipping drops the data-axis term (a layer's coefficient needs
        # only its own norm, which lives with the example); a
        # tensor-sharded layer still psums its partial norms over model.
        w = 0.0 if clip_mode == "per_layer" else _data_wire(B * BYTES)
        if model_sharded:
            w += _model_wire(B * BYTES)
        return w

    def _fused_credit(read_bytes: float, cand_flops: float) -> float:
        # Stale coefficients are known entering the pass, so the Gram
        # norm and the weighted contribution share one read of the
        # captures (gram_norm_fused) instead of two passes.  The credit
        # is capped at a sliver of the candidate's own FLOPs so it breaks
        # near-ties toward fusing but never flips a layer whose
        # materializing path holds a real compute advantage.
        if clip_mode == "stale" and clip_fused:
            return min(cc.hbm_flops_per_byte * read_bytes,
                       0.05 * cand_flops)
        return 0.0

    if meta.kind == "dense" and meta.segmented:
        x_shape = tuple(cap_sh["x"].shape)[k:]
        S, Di, Do = x_shape[-2], x_shape[-1], app_dy[-1]
        G = _prod(x_shape[:-2]) * stack
        B = meta.static["n_examples"]
        Bl = _shard(B)
        # Expert-sharded MoE layers place G/msh experts per model shard.
        msh = msize if msize > 1 and G % msize == 0 else 1
        Gl = G // msh
        m = (norm_method if norm_method not in ("auto", "pallas")
             else seg_norm_method(S, Di, Do, Bl, Gl, mem_budget))
        nf = (Gl * S * S * (Di + Do + Bl) if m == "gram"
              else Gl * Bl * Di * Do)
        cf = 2.0 * Gl * S * Di * Do
        return LayerPlan(name, "seg_dense", m, False, nf, cf, cf,
                         stash_bytes=Bl * Gl * Di * Do * BYTES,
                         param_bytes=Gl * Di * Do * BYTES, ex_per_dev=Bl,
                         model_shards=msh)

    if meta.kind == "dense":
        x_shape = tuple(cap_sh["x"].shape)[k:]
        B, Di, Do = x_shape[0], x_shape[-1], app_dy[-1]
        Bl = _shard(B)
        T = _prod(x_shape[1:-1])
        mult = stack
        if meta.shared and k:
            T, mult = T * stack, 1        # folded into the sequence axis
        # Tensor sharding over the model axes splits the output width:
        # each device contracts its Do/msh slice, the per-example norm is
        # the model-axis psum of the partial Grams.
        msh = msize if msize > 1 and Do % msize == 0 else 1
        Dol = Do // msh
        cf = 2.0 * Bl * T * Di * Dol * mult
        pbytes = Di * Dol * BYTES * mult
        # Stashing keeps (B, *stack, Di, Do) alive until the sum phase;
        # the un-stashed stream norm reduces one stacked layer at a time,
        # so it needs one layer's scratch but pays the contraction again.
        mem_stash = Bl * Di * Dol * BYTES * mult
        mem_layer = Bl * Di * Dol * BYTES
        stash = False
        fallback = norm_method
        if norm_method == "auto":
            if T == 1:
                m = fallback = "rank1"
            else:
                per_ex = Bl * mult
                gram_flops = (2.0 * T * T * (Di + Dol)
                              + 2.0 * T * Di * Dol) * per_ex
                gram_total = (gram_flops + _scal_cost(B, msh > 1)
                              - _fused_credit(
                                  T * (Di + Dol) * BYTES * per_ex,
                                  gram_flops))
                stream_stash = (4.0 * T * Di * Dol * per_ex
                                + _data_wire(mem_stash))
                stream_again = (4.0 * T * Di * Dol
                                + 2.0 * T * Di * Dol) * per_ex \
                    + _scal_cost(B, msh > 1)
                fallback = ("stream" if stream_again < gram_total
                            and mem_layer <= mem_budget else "gram")
                if stream_stash < gram_total and mem_stash <= mem_budget:
                    m, stash = "stream", True
                else:
                    m = fallback
        else:
            m = norm_method
            stash = m == "stream" and mem_stash <= mem_budget
        if m == "rank1" and T != 1:
            m = fallback = "gram"
        nf = {"gram": 2.0 * T * T * (Di + Dol),
              "pallas": 2.0 * T * T * (Di + Dol),
              "stream": 4.0 * T * Di * Dol,
              "rank1": 2.0 * T * (Di + Dol)}[m] * Bl * mult
        return LayerPlan(name, "dense", m, stash, nf, cf, cf,
                         stash_bytes=mem_stash, fallback_norm=fallback,
                         param_bytes=pbytes, ex_per_dev=Bl,
                         model_shards=msh)

    if meta.kind == "conv":
        st = meta.static
        x_shape = tuple(cap_sh["x"].shape)[k:]
        B, C = x_shape[0], x_shape[1]
        Bl = _shard(B)
        D = app_dy[1]
        T = _prod(app_dy[2:])
        K = _prod(st["kernel_shape"][2:])
        g = max(st.get("groups", 1), 1)
        F, Dg = (C // g) * K, D // g
        # Tensor sharding splits the output channels: each model shard
        # owns Dg/msh filters a group and psums its partial norms.
        msh = msize if msize > 1 and Dg % msize == 0 else 1
        Dgl = Dg // msh
        cf = 2.0 * Bl * T * F * Dgl * g * stack
        pbytes = (D // msh) * (C // g) * K * BYTES * stack
        mem_stash = Bl * (D // msh) * (C // g) * K * BYTES * stack
        mem_layer = Bl * (D // msh) * (C // g) * K * BYTES
        stash = False
        fallback = conv_norm
        if conv_norm == "auto":
            per_ex = Bl * stack
            ghost_flops = (2.0 * T * T * (F + Dgl)
                           + 2.0 * T * F * Dgl) * g * per_ex
            ghost_total = (ghost_flops + _scal_cost(B, msh > 1)
                           - _fused_credit(
                               T * (F + Dgl) * g * BYTES * per_ex,
                               ghost_flops))
            pe_stash = (4.0 * T * F * Dgl * g * per_ex
                        + _data_wire(mem_stash))
            pe_again = ((4.0 * T * F * Dgl + 2.0 * T * F * Dgl) * g * per_ex
                        + _scal_cost(B, msh > 1))
            fallback = ("pe" if pe_again < ghost_total
                        and mem_layer <= mem_budget else "ghost")
            if pe_stash < ghost_total and mem_stash <= mem_budget:
                m, stash = "pe", True
            else:
                m = fallback
        else:
            m = conv_norm
            stash = m == "pe" and mem_stash <= mem_budget
        nf = (2.0 * Bl * T * T * (F + Dgl) * g if m == "ghost"
              else 4.0 * Bl * T * F * Dgl * g) * stack
        return LayerPlan(name, "conv", m, stash, nf, cf, cf,
                         stash_bytes=mem_stash, fallback_norm=fallback,
                         param_bytes=pbytes, ex_per_dev=Bl,
                         model_shards=msh)

    if meta.kind == "embed":
        ids_shape = tuple(cap_sh["ids"].shape)[k:]
        B = ids_shape[0]
        Bl = _shard(B)
        T = _prod(ids_shape[1:])
        D = app_dy[-1]
        V = vocab or T
        # A vocab-sharded table keeps V/msh rows a model shard; its
        # partial norms psum over the model axes.
        msh = msize if msize > 1 and V % msize == 0 else 1
        Vl = V // msh
        pbytes = Vl * D * BYTES * stack
        stash_bytes = Bl * Vl * D * BYTES * stack
        seg_f = (T * max(math.log2(max(T, 2)), 1.0) + 2.0 * T * D)
        if embed_method != "auto":
            m = embed_method
        elif not mesh:
            # stack multiplies the stashed (B, V, D) scratch for the budget
            m = embed_norm_method(T, D, B * stack, vocab)
        else:
            # On a mesh the stash's ring traffic competes with the scalar
            # all-reduce of the ghost realizations.
            costs = {"pe": Bl * (T * D + Vl * D) * stack
                     + _data_wire(stash_bytes),
                     "gram": 2.0 * Bl * T * T * D * stack
                     + _scal_cost(B, msh > 1),
                     "segsum": Bl * seg_f * stack + _scal_cost(B, msh > 1)}
            m = min(costs, key=costs.get)
            if m == "pe" and stash_bytes > EMBED_PE_BUDGET:
                m = "gram" if T <= 32 else "segsum"
        nf = {"gram": 2.0 * Bl * T * T * D,
              "pe": Bl * (T * D + Vl * D),
              "segsum": Bl * seg_f}[m] * stack
        cf = 2.0 * Bl * T * D * stack
        fb = m if m != "pe" else ("gram" if T <= 32 else "segsum")
        return LayerPlan(name, "embed", m, m == "pe", nf, cf, cf,
                         stash_bytes=stash_bytes, fallback_norm=fb,
                         param_bytes=pbytes, ex_per_dev=Bl,
                         model_shards=msh)

    if meta.kind == "attn":
        # The norm phase recomputes the block forward + backward once
        # (kinds._attn_parts: ≈ 3x the projection matmuls plus the T²
        # score work), then realizes each projection's norm: "ghost" runs
        # the inner Gram contractions, "pe" materializes and stashes the
        # per-projection per-example grads so the sum phase is a free
        # weighted reduction over the stash.
        x_shape = tuple(cap_sh["x"].shape)[k:]
        B = x_shape[0]
        Bl = _shard(B)
        T = _prod(x_shape[1:-1])
        proj = tuple(meta.static["proj_dims"])
        qk = meta.static.get("qk_flops", 0)
        per_ex = Bl * stack
        proj_flops = sum(2.0 * T * Di * Do for Di, Do in proj)
        recompute = 3.0 * (proj_flops + 4.0 * T * T * qk) * per_ex
        gram = sum(2.0 * T * T * (Di + Do) for Di, Do in proj) * per_ex
        outer = 2.0 * proj_flops * per_ex
        psize = sum(Di * Do for Di, Do in proj)
        mem_stash = Bl * psize * BYTES * stack
        ghost_total = recompute + gram + _scal_cost(B)
        pe_stash = recompute + outer + _data_wire(mem_stash)
        m = norm_method if norm_method in ("ghost", "pe") else "auto"
        stash = False
        if m == "auto":
            if pe_stash < ghost_total and mem_stash <= mem_budget:
                m, stash = "pe", True
            else:
                m = "ghost"
        else:
            stash = m == "pe" and mem_stash <= mem_budget
        nf = recompute + (outer if m == "pe" else gram)
        cf = recompute + proj_flops * per_ex
        return LayerPlan(name, "attn", m, stash, nf, cf, proj_flops * per_ex,
                         stash_bytes=mem_stash, fallback_norm="ghost",
                         param_bytes=psize * BYTES * stack, ex_per_dev=Bl)

    B = app_dy[0] if app_dy else 1
    Bl = _shard(B)
    n = 2.0 * Bl * (_prod(app_dy) // max(B, 1)) * stack
    if meta.kind == "local_vjp":
        # The norm phase materializes the per-example grads and stashes
        # them when the (B, *param) scratch fits the budget, making the
        # sum free; else the contraction pays LOCAL_VJP_CONTRIB_PENALTY.
        # params_sub at meta.path carries the stacked axes in its leaf
        # shapes for scanned layers, so B * elems is the whole stash.
        psize = _tree_elems(params_sub) if params_sub is not None else 0
        stash_mem = Bl * psize * BYTES
        return LayerPlan(name, "local_vjp", "pe",
                         psize == 0 or stash_mem <= mem_budget, n,
                         LOCAL_VJP_CONTRIB_PENALTY * n, n,
                         stash_bytes=stash_mem, param_bytes=psize * BYTES,
                         ex_per_dev=Bl)
    # scale: per-example grads are (B, d): materialize and stash
    return LayerPlan(name, "scale", "pe", True, n, n, n,
                     stash_bytes=(Bl * app_dy[-1] * BYTES * stack
                                  if app_dy else 0.0),
                     param_bytes=(app_dy[-1] * BYTES * stack
                                  if app_dy else 0.0),
                     ex_per_dev=Bl)


def _vocab_of(meta: LayerMeta, params) -> int | None:
    if params is None:
        return meta.static.get("vocab")
    try:
        leaf = get_subtree(params, meta.path)[meta.param_key]
        return int(leaf.shape[-2])
    except (KeyError, TypeError, IndexError):
        return None


_OVERRIDE_METHODS = {
    "dense": {"auto", "gram", "stream", "rank1", "pallas"},
    "embed": {"auto", "segsum", "gram", "pe"},
    "conv": {"auto", "ghost", "pe", "pallas"},
    "attn": {"auto", "ghost", "pe"},
}


def normalize_overrides(overrides) -> tuple:
    """Per-layer overrides as an ordered, hashable tuple of (pattern,
    method) pairs.  Patterns are fnmatch globs over tap names (``"conv1"``,
    ``"fc*"``); the first match wins, in the order given."""
    if not overrides:
        return ()
    if isinstance(overrides, Mapping):
        overrides = overrides.items()
    return tuple((str(p), str(m)) for p, m in overrides)


def _override_for(name: str, kind: str, overrides: tuple) -> str | None:
    """First matching override for this layer.  Kinds with no override
    vocabulary (scale) ignore matches — a block-level glob like
    ``"blocks/*"`` sweeps up their taps — but a method that is wrong for
    an overridable kind is a hard error."""
    valid = _OVERRIDE_METHODS.get(kind)
    if valid is None:
        return None
    for pat, m in overrides:
        if fnmatchcase(name, pat):
            if m not in valid:
                raise ValueError(
                    f"per-layer override {pat!r}={m!r} invalid for {kind} "
                    f"layer {name!r}; choose from {sorted(valid)}")
            return m
    return None


def _nbytes(spec) -> float:
    return float(_prod(spec.shape)) * spec.dtype.itemsize


def plan_execution(metas: dict, cap_shapes: dict, tap_shapes: dict,
                   params=None, *, norm_method: str = "auto",
                   embed_method: str = "auto", conv_norm: str = "auto",
                   mem_budget: int = STREAM_MEM_BUDGET,
                   overrides=None, mesh=None, clip_mode: str = "flat",
                   clip_fused: bool = True, calibration=None) -> ExecPlan:
    """Build the per-layer plan from probed shapes (``params``: the tree
    or its specs, read for the embedding tables' vocabulary sizes),
    priced under ``calibration`` (see :func:`resolve_cost_constants`).
    ``mesh`` (anything :func:`mesh_axes` takes) makes every estimate per
    device and charges candidates their collective bytes.

    Fixed ``norm_method`` / ``embed_method`` / ``conv_norm`` override the
    analytic choice uniformly (the planner still fills in cost estimates);
    ``overrides`` pins individual layers by tap-name glob and wins over
    all three.

    ``clip_mode`` shapes the plan around the coefficient flow of the
    executing :class:`~repro_torch.core.clipping.ClipPolicy`: ``per_layer``
    never selects the shared weighted backward (one backward cannot
    realize per-layer weights); ``stale`` drops it too (the known
    coefficients make every contraction direct) and, with ``clip_fused``,
    credits and marks Gram-realized dense/conv layers for the fused
    single-pass ``gram_norm_fused`` norm+contrib.
    """
    overrides = normalize_overrides(overrides)
    ms = mesh_axes(mesh)
    d = mesh_data_size(ms)
    cc = resolve_cost_constants(calibration, ms)
    layers: dict[str, LayerPlan] = {}
    by_path: dict[tuple, list] = {}
    for name, meta in metas.items():
        psub = None
        if params is not None and meta.kind == "local_vjp":
            try:
                psub = get_subtree(params, meta.path)
            except (KeyError, TypeError):
                psub = None
        ov = _override_for(name, meta.kind, overrides)
        layers[name] = _plan_layer(
            name, meta, cap_shapes[name], tap_shapes[name],
            norm_method=ov or norm_method, embed_method=ov or embed_method,
            conv_norm=ov or conv_norm, mem_budget=mem_budget,
            vocab=_vocab_of(meta, params) if meta.kind == "embed" else None,
            params_sub=psub, mesh=ms, clip_mode=clip_mode,
            clip_fused=clip_fused, cc=cc)
        by_path.setdefault(meta.path, []).append(name)

    total_wgrad = sum(lp.wgrad_flops for lp in layers.values())
    # A weighted backward pays the forward + dx chain (the fixed factor)
    # AND computes every parameter's wgrad — including those of groups
    # that keep their stash/contraction, whose share is pure waste.  So
    # switching the candidate set to the backward only pays off when the
    # contractions it replaces exceed fixed + total_wgrad.  On a mesh it
    # also all-reduces the whole gradient a second time, sized by the
    # *unique* parameters (taps sharing a path sync one gradient).
    unique_pbytes = sum(max(layers[n].param_bytes for n in names)
                        for names in by_path.values())
    backward_cost = (BACKWARD_FIXED_FACTOR + 1.0) * total_wgrad \
        + sum(cc.coll_price(a) * _ring(s) * unique_pbytes
              for a, s in mesh_data_axes(ms))

    groups: list[GroupPlan] = []
    for path, names in sorted(by_path.items()):
        if len(names) == 1:
            mode = "single"
            sum_method = "stash" if layers[names[0]].stash else "contrib"
        else:
            ks = sorted((metas[n].kind, metas[n].w_transposed) for n in names)
            mode = ("tied" if ks == [("dense", True), ("embed", False)]
                    and len(names) == 2 else "group_pe")
            if mode == "tied":
                n_e = next(n for n in names if metas[n].kind == "embed")
                if layers[n_e].norm_method == "pe":
                    # Small tied table: materializing the summed grad once
                    # beats segsum + Gram + the cross term, and stashes.
                    mode = "group_pe"
            # group_pe stashes the summed per-example grad during the norm
            # phase; tied contracts per member.
            sum_method = "stash" if mode == "group_pe" else "contrib"
        groups.append(GroupPlan(path, tuple(names), mode, sum_method))

    # All stashes live together from the norm phase to the sum phase, so
    # the budget is charged cumulatively; groups past it fall back to a
    # transient norm + phase-2 contraction (one layer's scratch at a time).
    running = 0.0
    for i, g in enumerate(groups):
        if g.sum_method != "stash":
            continue
        # members of a group share one parameter, so a group stashes one
        # (B, *param) tree: the largest member estimate, not the sum.
        gb = max(layers[n].stash_bytes for n in g.members)
        if running + gb > mem_budget:
            groups[i] = dataclasses.replace(g, sum_method="contrib")
            for n in g.members:
                lp = layers[n]
                # Re-decide the norm under no-stash economics: without the
                # free sum, the stash-optimal method may no longer win.
                layers[n] = dataclasses.replace(
                    lp, stash=False,
                    norm_method=lp.fallback_norm or lp.norm_method)
        else:
            running += gb

    # Greedy backward set: groups whose contraction is dearer than their
    # wgrad share, kept only if the replaced contractions pay for the
    # whole extra backward.  Never under a non-flat clipping mode: one
    # weighted backward cannot realize per-layer coefficients, and stale
    # coefficients make every contraction direct.
    candidates: list[tuple[float, int]] = []
    if clip_mode == "flat":
        for i, g in enumerate(groups):
            if g.sum_method != "contrib":
                continue
            cost_c = sum(layers[n].contrib_flops for n in g.members)
            cost_b = sum(layers[n].wgrad_flops for n in g.members)
            if cost_c > cost_b:
                candidates.append((cost_c, i))
    needs_backward = sum(s for s, _ in candidates) > backward_cost
    if needs_backward:
        for _, gi in candidates:
            groups[gi] = dataclasses.replace(groups[gi],
                                             sum_method="backward")

    # Stale coefficients are step-invariant inside the pass: mark the
    # Gram-realized dense/conv layers for the fused single-pass
    # norm+contrib (gram_norm_fused).  Only single-tap groups fuse —
    # tied/shared-path groups keep their cross-term norm algebra — and
    # only unscanned convs.
    if clip_mode == "stale" and clip_fused:
        single = {g.members[0] for g in groups if len(g.members) == 1}
        for name, lp in layers.items():
            if name not in single or lp.stash:
                continue
            if (lp.kind == "dense" and lp.norm_method in ("gram", "pallas")) \
                    or (lp.kind == "conv" and metas[name].scanned == 0
                        and lp.norm_method in ("ghost", "pallas")):
                layers[name] = dataclasses.replace(lp, fused=True)

    # The collective bytes of the *chosen* realization, per mesh axis.
    # Data axes carry the norm phase (the stash, or the all-reduce of the
    # global (B,) norms) plus this layer's share of its group's gradient
    # sync: one sync a parameter, split over the taps sharing it, doubled
    # for weighted-backward groups.  Model axes carry the partial-norm
    # psum of tensor-sharded layers.
    if ms:
        for g in groups:
            group_pb = max(layers[n].param_bytes for n in g.members)
            sync_each = group_pb \
                * (2.0 if g.sum_method == "backward" else 1.0) \
                / len(g.members)
            for name in g.members:
                lp = layers[name]
                norm_bytes = (lp.stash_bytes if lp.stash
                              else lp.ex_per_dev * d * BYTES)
                by_axis = []
                for a, size in ms:
                    r = _ring(size)
                    if a in DATA_AXIS_NAMES:
                        b = (norm_bytes + sync_each) * r
                    else:
                        b = (lp.ex_per_dev * d * BYTES * r
                             if lp.model_shards > 1 else 0.0)
                    if b > 0.0:
                        by_axis.append((a, b))
                layers[name] = dataclasses.replace(
                    lp, coll_bytes=sum(b for _, b in by_axis),
                    coll_bytes_by_axis=tuple(by_axis))

    capture_bytes = 0.0
    for name in metas:
        for spec in cap_shapes[name].values():
            capture_bytes += (sum(map(_nbytes, spec)) if is_multi(spec)
                              else _nbytes(spec))
        capture_bytes += 2.0 * _nbytes(tap_shapes[name])  # output + cotangent
    capture_bytes /= d   # captures are batch-sharded: one device's share

    axis_totals: dict[str, float] = {}
    for lp in layers.values():
        for a, b in lp.coll_bytes_by_axis:
            axis_totals[a] = axis_totals.get(a, 0.0) + b

    return ExecPlan(
        groups=tuple(groups), layers=layers, metas=metas,
        needs_backward=needs_backward,
        total_norm_flops=sum(lp.norm_flops for lp in layers.values()),
        total_contrib_flops=sum(lp.contrib_flops for lp in layers.values()),
        tap_shapes=dict(tap_shapes), capture_bytes=capture_bytes,
        mesh=ms, clip_mode=clip_mode, calibration=cc.calibration,
        total_coll_bytes=sum(lp.coll_bytes for lp in layers.values()),
        total_coll_bytes_by_axis=tuple(
            (a, axis_totals[a]) for a, _ in ms if a in axis_totals))


# ---------------------------------------------------------------------------
# Plan cache: (model identity, batch/param shapes, knobs) -> ExecPlan
#
# probe() re-runs the model on meta tensors; caching the probe + plan makes
# the steady-state auto path exactly one forward + one backward per step.


_PLAN_CACHE: "OrderedDict[tuple, ExecPlan]" = OrderedDict()


def _fn_ident(apply_fn) -> tuple:
    self = getattr(apply_fn, "__self__", None)
    if self is not None:
        return (id(self), getattr(apply_fn, "__name__", ""))
    return (id(apply_fn), "")


def _shape_sig(tree) -> tuple:
    return tuple(("/".join(map(str, p)), tuple(leaf.shape),
                  _dtype_name(leaf.dtype))
                 for p, leaf in ((p, get_subtree(tree, p))
                                 for p in leaf_paths(tree)))


@functools.lru_cache(maxsize=1)
def code_fingerprint() -> str:
    """Hash of the port's model/pipeline *sources* (``repro_torch.models``
    and ``repro_torch.core``).  Folded into every plan fingerprint, so a
    plan produced by different code fails the fingerprint check instead
    of silently executing under a stale plan."""
    import repro_torch.core
    import repro_torch.models
    h = hashlib.sha1()
    for pkg in (repro_torch.core, repro_torch.models):
        root = pathlib.Path(next(iter(pkg.__path__)))
        for path in sorted(root.rglob("*.py")):
            h.update(str(path.relative_to(root.parent)).encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:12]


def model_fingerprint(apply_fn, params, batch, opts: tuple = ()) -> str:
    """Cross-process-stable plan identity: model qualname + batch/param
    shape signature + planner knobs + the source hash.  Unlike the
    in-process cache key it never uses ``id()``."""
    owner = getattr(apply_fn, "__self__", None)
    if owner is not None:
        ident = type(owner).__module__ + "." + type(owner).__qualname__
    else:
        ident = (getattr(apply_fn, "__module__", "") + "."
                 + getattr(apply_fn, "__qualname__", "<fn>"))
    payload = repr((ident, _shape_sig(batch), _shape_sig(params), opts,
                    code_fingerprint()))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def clear_plan_cache():
    _PLAN_CACHE.clear()


def _sig_summary(sig) -> str:
    return ", ".join(f"{k}{tuple(s)}:{dt}" for k, s, dt in sig) or "(empty)"


def check_plan_matches(plan: ExecPlan, *, fingerprint: str | None = None,
                       mesh=None, batch_sig=None, clip_mode: str | None = None,
                       calibration=None):
    """Validate a deserialized/injected plan against the live context,
    naming the offending field — calibration, clipping mode, mesh shape,
    batch shape or fingerprint — so a stale plan fails loudly instead of
    executing a stale layout.  ``calibration`` is a Calibration or its
    digest ("" asserts the analytic constants)."""
    if calibration is not None:
        want = (calibration if isinstance(calibration, str)
                else calibration.digest())
        if plan.calibration != want:
            def _label(d):
                return (f"measured constants {d}" if d
                        else "analytic constants")
            raise ValueError(
                f"stale ExecPlan: calibration mismatch — plan "
                f"{plan.fingerprint or '<unfingerprinted>'} was priced "
                f"under {_label(plan.calibration)}, this process plans "
                f"under {_label(want)}; re-calibrate or re-plan")
    if clip_mode is not None and plan.clip_mode != clip_mode:
        raise ValueError(
            f"stale ExecPlan: clipping mode mismatch — plan "
            f"{plan.fingerprint or '<unfingerprinted>'} was built for "
            f"clipping mode {plan.clip_mode!r}, this process clips "
            f"{clip_mode!r}; re-plan for this policy")
    if mesh is not None:
        ms = mesh_axes(mesh)
        if tuple(plan.mesh) != ms:
            raise ValueError(
                f"stale ExecPlan: mesh shape mismatch — plan "
                f"{plan.fingerprint or '<unfingerprinted>'} was built for "
                f"mesh {format_mesh(tuple(plan.mesh))}, this process runs "
                f"{format_mesh(ms)}; re-plan for this topology")
    if batch_sig is not None and plan.batch_sig \
            and tuple(plan.batch_sig) != tuple(batch_sig):
        raise ValueError(
            f"stale ExecPlan: batch shape mismatch — plan "
            f"{plan.fingerprint or '<unfingerprinted>'} was built for "
            f"[{_sig_summary(plan.batch_sig)}], this step feeds "
            f"[{_sig_summary(batch_sig)}]")
    if fingerprint and plan.fingerprint and plan.fingerprint != fingerprint:
        raise ValueError(
            f"stale ExecPlan: fingerprint mismatch — plan "
            f"{plan.fingerprint} != expected {fingerprint} (model code, "
            f"param shapes, or planner knobs changed)")


def _opts_tuple(norm_method, embed_method, conv_norm, mem_budget, overrides,
                mesh=(), clip_mode="flat", clip_fused=True,
                calib=None) -> tuple:
    """The planner knobs as a hashable tuple: the normalized mesh at
    index 5, ending with the digest of the (resolved) calibration the
    plan is priced under ("" analytic)."""
    return (norm_method, embed_method, conv_norm, mem_budget,
            normalize_overrides(overrides), mesh_axes(mesh),
            (str(clip_mode), bool(clip_fused)),
            "" if calib is None else calib.digest())


def plan_fingerprint(apply_fn, params, batch, *, norm_method: str = "auto",
                     embed_method: str = "auto", conv_norm: str = "auto",
                     mem_budget: int = STREAM_MEM_BUDGET, overrides=None,
                     clip_mode: str = "flat", clip_fused: bool = True,
                     mesh=None, calibration=None) -> str:
    """The fingerprint :func:`get_plan` would key this request on — same
    knob normalization, no probe."""
    ms = mesh_axes(mesh)
    return model_fingerprint(
        apply_fn, params, batch,
        _opts_tuple(norm_method, embed_method, conv_norm, mem_budget,
                    overrides, ms, clip_mode, clip_fused,
                    _resolve_calibration(calibration, ms)))


def get_plan(apply_fn, params, batch, *, norm_method: str = "auto",
             embed_method: str = "auto", conv_norm: str = "auto",
             mem_budget: int = STREAM_MEM_BUDGET,
             overrides=None, clip_mode: str = "flat",
             clip_fused: bool = True, mesh=None,
             calibration=None) -> ExecPlan:
    """Cached planner entry point.  ``params`` and ``batch`` may be
    tensors on any device, meta tensors included: only their shapes and
    dtypes are read.  A fingerprint hit in the plan store (filled by
    :func:`load_plan_store`) skips the probe.  The anchor pinned in the
    cached plan keeps ``id(apply_fn.__self__)`` alive for the entry's
    lifetime, so a recycled id can never alias a different model.
    ``calibration`` (explicit, or the registered one) keys the cache and
    the fingerprint by its digest, so a plan priced under other constants
    is never handed back.  ``mesh`` keys both too: a store that holds
    this request's plan for *another* topology raises (naming the mesh)
    instead of re-planning over a stale layout."""
    ms = mesh_axes(mesh)
    calib = _resolve_calibration(calibration, ms)
    opts = _opts_tuple(norm_method, embed_method, conv_norm, mem_budget,
                       overrides, ms, clip_mode, clip_fused, calib)
    key = (_fn_ident(apply_fn), _shape_sig(batch), _shape_sig(params), opts)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        return plan
    fp = model_fingerprint(apply_fn, params, batch, opts)
    plan = _PLAN_STORE.get(fp)
    if plan is None:
        sig = _shape_sig(batch)
        for cand in _PLAN_STORE.values():
            if tuple(cand.batch_sig) != sig or tuple(cand.mesh) == ms:
                continue
            # Only this request's own plan on another topology blocks
            # planning: re-key the request under the candidate's mesh, so
            # an unrelated model sharing the batch shape never trips it.
            cand_opts = _opts_tuple(
                norm_method, embed_method, conv_norm, mem_budget, overrides,
                tuple(cand.mesh), clip_mode, clip_fused,
                _resolve_calibration(calibration, tuple(cand.mesh)))
            if cand.fingerprint == model_fingerprint(apply_fn, params,
                                                     batch, cand_opts):
                check_plan_matches(cand, mesh=ms)
        metas, tap_shapes, cap_shapes = probe(apply_fn, params, batch,
                                              return_captures=True)
        plan = plan_execution(
            metas, cap_shapes, tap_shapes, params, norm_method=norm_method,
            embed_method=embed_method, conv_norm=conv_norm,
            mem_budget=mem_budget, overrides=opts[4], mesh=ms,
            clip_mode=clip_mode, clip_fused=clip_fused,
            calibration="analytic" if calib is None else calib)
        plan = dataclasses.replace(plan, fingerprint=fp, batch_sig=sig)
    object.__setattr__(plan, "_anchor", getattr(apply_fn, "__self__",
                                                apply_fn))
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > PLAN_CACHE_SIZE:
        _PLAN_CACHE.popitem(last=False)
    return plan


# ---------------------------------------------------------------------------
# Cross-process plan store: fingerprint -> deserialized ExecPlan.  Filled by
# load_plan_store(); consulted by get_plan() before any probe, so a process
# that pre-loads its plans never re-runs the model for planning.  The file
# holds the port's own plan JSON (ExecPlan.to_payload), not the JAX
# package's, and the calibrations its plans were priced under (the JAX
# package's calibration format).

_PLAN_STORE: dict[str, ExecPlan] = {}


def register_plan(plan: ExecPlan):
    if not plan.fingerprint:
        raise ValueError("plan has no fingerprint; build it via get_plan()")
    _PLAN_STORE[plan.fingerprint] = plan


def clear_plan_store():
    _PLAN_STORE.clear()


def save_plan_store(path: str, plans, calibrations=None):
    """Write plans as one JSON document, with the calibrations they were
    priced under: ``calibrations=None`` collects every registered
    calibration whose digest some plan carries, so a store written after
    calibrated planning round-trips the constants it depends on."""
    plans = list(plans)
    if calibrations is None:
        from repro_torch.calibrate import table
        used = {p.calibration for p in plans if p.calibration}
        calibrations = [c for c in table.registered()
                        if c.digest() in used]
    doc = {"format": PLAN_FORMAT_VERSION,
           "plans": [p.to_payload() for p in plans]}
    calibrations = list(calibrations)
    if calibrations:
        doc["calibrations"] = [c.to_payload() for c in calibrations]
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_plan_store(path: str) -> int:
    """Load a plan JSON document into the store; returns the plan count.
    Its calibrations are validated (a tampered one raises a named
    ``CalibrationError`` before any plan is stored; hardware is checked
    at use) and registered first, so calibrated fingerprints resolve.  A
    plan of another format version raises (``ExecPlan.from_payload``)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and doc.get("calibrations"):
        from repro_torch.calibrate import table
        for c in [table.Calibration.from_payload(cp)
                  for cp in doc["calibrations"]]:
            table.register(c)
    plans = doc["plans"] if isinstance(doc, dict) else doc
    for p in plans:
        register_plan(ExecPlan.from_payload(p))
    return len(plans)


# ---------------------------------------------------------------------------
# Plan-driven microbatch scheduling


MICROBATCH_MEM_BUDGET = STREAM_MEM_BUDGET


def auto_microbatches(plan: ExecPlan, batch_size: int,
                      mem_budget: int | None = None) -> int:
    """Microbatch count from the plan's peak-memory estimates: the smallest
    divisor of ``batch_size`` whose per-microbatch peak (captures, layer
    outputs and cotangents, coexisting stashes — all linear in the leading
    batch axis) fits the budget.  Falls back to fully sequential
    (``batch_size``) when even single-example microbatches estimate over
    budget."""
    budget = float(mem_budget or MICROBATCH_MEM_BUDGET)
    need = plan.capture_bytes + plan.peak_stash_bytes()
    B = max(int(batch_size), 1)
    m = 1
    while m < B and need / m > budget:
        m += 1
        while B % m and m < B:
            m += 1
    return m


# ---------------------------------------------------------------------------
# Predicted step cost: what the mispredict loop compares measurements
# against.  Priced in the FLOP-equivalents the planner selects by, then
# converted to seconds through the calibrated (or analytic) rate.


def predicted_step_flops(plan: ExecPlan,
                         cc: CostConstants | None = None) -> float:
    """Per-device FLOP-equivalents of one private step under this plan:
    forward + backward (≈ 2 wgrad shares) + wgrad + the plan's norm and
    contraction phases + the weighted second backward when taken + the
    wire price of the predicted collective bytes, each axis at its own
    price."""
    cc = cc or ANALYTIC_CONSTANTS
    total_wgrad = sum(lp.wgrad_flops for lp in plan.layers.values())
    flops = 3.0 * total_wgrad \
        + plan.total_norm_flops + plan.total_contrib_flops
    if plan.needs_backward:
        flops += (BACKWARD_FIXED_FACTOR + 1.0) * total_wgrad
    if plan.total_coll_bytes_by_axis:
        flops += sum(cc.coll_price(a) * b
                     for a, b in plan.total_coll_bytes_by_axis)
    else:
        flops += cc.collective_flops_per_byte * plan.total_coll_bytes
    return flops


def predicted_step_seconds(plan: ExecPlan, calibration=None) -> float:
    """Predicted wall-clock of one step: :func:`predicted_step_flops`
    under the plan's cost constants (its mesh's calibration), over the
    (calibrated or analytic) FLOP rate."""
    cc = resolve_cost_constants(calibration, plan.mesh)
    return predicted_step_flops(plan, cc) / cc.flops_per_second

