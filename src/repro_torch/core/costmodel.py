"""Per-layer execution planner for the DP-SGD pipeline (single device).

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
materializes its tiny per-example grads.  Scanned layers multiply the
per-application cost by the stack; shared scanned dense/scale layers fold
the stack into the sequence axis.  Taps that share one parameter form a
group with a ``norm_mode``: ``single``, ``tied`` (embedding + transposed
LM head: both norms plus the cross term) or ``group_pe`` (materialize the
summed per-example grad).

Under stale clipping the Gram-realized dense/conv layers of single-tap
groups are marked ``fused``: their norm and contribution come from one
``gram_norm_fused`` pass.

The decision rules and constants are the JAX package's
(``repro.core.costmodel``), so the two packages plan alike under the same
constants.  Only the single-device planner is ported: ``mesh=`` raises
(ROADMAP.md item 14).  ``calibration=`` prices with measured constants
(:mod:`repro_torch.calibrate`; ``None`` takes the calibration registered
for this process's device, ``"analytic"`` the analytic table), and the
calibration's digest is part of every plan's identity: the cache key,
the fingerprint and the plan store.  :func:`predicted_step_seconds` is
what the engine's mispredict loop compares measured step times against.
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

from repro_torch.core.tapper import LayerMeta, TensorSpec, probe
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
# the wire price needs a mesh and the FLOP rate only converts
# FLOP-equivalents into predicted seconds.
ANALYTIC_FALLBACK = {
    "collective_flops_per_byte": 512.0,
    "hbm_flops_per_byte": 128.0,
    "flops_per_second": 197.0e12,
}


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """The rates one planning pass prices against, plus provenance
    (``calibration`` is a measured calibration's digest, "" when
    analytic; it is part of every plan's identity)."""

    collective_flops_per_byte: float
    hbm_flops_per_byte: float
    flops_per_second: float
    source: str = "analytic"
    calibration: str = ""


ANALYTIC_CONSTANTS = CostConstants(
    collective_flops_per_byte=ANALYTIC_FALLBACK["collective_flops_per_byte"],
    hbm_flops_per_byte=ANALYTIC_FALLBACK["hbm_flops_per_byte"],
    flops_per_second=ANALYTIC_FALLBACK["flops_per_second"])

PLAN_CACHE_SIZE = 16


def _single_device(mesh=None):
    if mesh is not None:
        raise NotImplementedError(
            "mesh-aware planning comes with sharding (ROADMAP.md item 14)")


def mesh_axes(mesh) -> tuple:
    """Normalize a mesh spec (``"data:8,model:2"``, an axes mapping, or an
    ``(("data", 8), ...)`` tuple) to the tuple form, dropping size-1
    axes: the JAX package's rule, which calibration blobs are keyed by."""
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
    else:
        pairs = mesh
    return tuple((str(n), int(s)) for n, s in pairs if int(s) != 1)


def format_mesh(axes: tuple) -> str:
    return ("x".join(f"{n}={s}" for n, s in axes)) if axes else "(no mesh)"


def _resolve_calibration(calibration):
    """An explicit Calibration wins; ``None`` consults the registry for
    this process's device; ``"analytic"`` asks for the analytic table.
    Imported lazily — repro_torch.calibrate imports this module."""
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
    return table.lookup()


def resolve_cost_constants(calibration=None) -> CostConstants:
    """The :class:`CostConstants` a planning pass prices against: the
    given (or registered) calibration's measured rates, or
    :data:`ANALYTIC_CONSTANTS`.  One device measures no wire, so the wire
    price stays analytic."""
    calib = _resolve_calibration(calibration)
    if calib is None:
        return ANALYTIC_CONSTANTS
    return CostConstants(
        collective_flops_per_byte=ANALYTIC_FALLBACK[
            "collective_flops_per_byte"],
        hbm_flops_per_byte=calib.hbm_flops_per_byte(),
        flops_per_second=calib.flops_per_second,
        source=calib.source, calibration=calib.digest())


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
    """Per-tap decision + cost estimates (whole batch, one device)."""

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


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One parameter (tree path); >1 member means shared/tied taps."""

    path: tuple
    members: tuple                 # tap names
    norm_mode: str                 # single | tied | group_pe
    sum_method: str                # stash | contrib | backward


PLAN_FORMAT_VERSION = 2   # v2: GroupPlan.norm_mode (tied / group_pe)

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
    batch_sig: tuple = ()          # batch shapes the plan was built on
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
        """Per-layer table of the chosen realizations and predicted costs."""
        sums = self.sum_methods()
        header = (f"{'layer':<28} {'kind':<10} {'norm':<8} {'sum':<9} "
                  f"{'norm MF':>9} {'sum MF':>9} {'stash MB':>9}")
        lines = [header, "-" * len(header)]
        for n, lp in self.layers.items():
            stash_mb = lp.stash_bytes / 2**20 if lp.stash else 0.0
            sum_m = "fused" if lp.fused else sums.get(n, "?")
            lines.append(
                f"{n:<28} {lp.kind:<10} {lp.norm_method:<8} "
                f"{sum_m:<9} {lp.norm_flops / 1e6:>9.2f} "
                f"{lp.contrib_flops / 1e6:>9.2f} {stash_mb:>9.2f}")
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
            "batch_sig": _jsonable(self.batch_sig),
            "clip_mode": self.clip_mode,
            "needs_backward": self.needs_backward,
            "total_norm_flops": self.total_norm_flops,
            "total_contrib_flops": self.total_contrib_flops,
            "calibration": self.calibration,
            "capture_bytes": self.capture_bytes,
            "layers": {n: dataclasses.asdict(lp)
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
        layers = {n: LayerPlan(**d) for n, d in p["layers"].items()}
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
                   batch_sig=_retuple(p["batch_sig"]),
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


def _plan_layer(name: str, meta: LayerMeta, cap_sh: dict, dy_sh,
                *, norm_method: str, embed_method: str, conv_norm: str,
                mem_budget: int, vocab: int | None = None,
                clip_mode: str = "flat", clip_fused: bool = True,
                cc: CostConstants = ANALYTIC_CONSTANTS) -> LayerPlan:
    """Costs for one tap (whole batch, one device).  Stacked (scanned)
    applications multiply the per-application cost; shared stacked dense
    layers fold the stack into the sequence axis first (matching
    kinds.apply_kind).

    The auto choice minimizes the *joint* norm + sum cost: a norm that
    materializes per-example grads makes the sum phase a free (B,)-weighted
    reduction over the stash, so ``stream``/``pe`` is charged once while
    ``gram``/``ghost`` is charged norm + contraction."""
    if meta.segmented or meta.kind not in ("dense", "conv", "embed",
                                           "scale"):
        raise NotImplementedError(
            f"layer {name!r} (kind {meta.kind!r}"
            f"{', segmented' if meta.segmented else ''}): comes with the "
            f"rest of the LM slice (ROADMAP.md item 11)")
    k = meta.scanned
    dy_shape = tuple(dy_sh.shape)
    stack = _prod(dy_shape[:k])
    app_dy = dy_shape[k:]

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

    if meta.kind == "dense":
        x_shape = tuple(cap_sh["x"].shape)[k:]
        B, Di, Do = x_shape[0], x_shape[-1], app_dy[-1]
        T = _prod(x_shape[1:-1])
        mult = stack
        if meta.shared and k:
            T, mult = T * stack, 1        # folded into the sequence axis
        cf = 2.0 * B * T * Di * Do * mult
        # Stashing keeps (B, *stack, Di, Do) alive until the sum phase;
        # the un-stashed stream norm reduces one stacked layer at a time,
        # so it needs one layer's scratch but pays the contraction again.
        mem_stash = B * Di * Do * BYTES * mult
        mem_layer = B * Di * Do * BYTES
        stash = False
        fallback = norm_method
        if norm_method == "auto":
            if T == 1:
                m = fallback = "rank1"
            else:
                per_ex = B * mult
                gram_flops = (2.0 * T * T * (Di + Do)
                              + 2.0 * T * Di * Do) * per_ex
                gram_total = gram_flops - _fused_credit(
                    T * (Di + Do) * BYTES * per_ex, gram_flops)
                stream_stash = 4.0 * T * Di * Do * per_ex
                stream_again = (4.0 * T * Di * Do
                                + 2.0 * T * Di * Do) * per_ex
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
        nf = {"gram": 2.0 * T * T * (Di + Do),
              "pallas": 2.0 * T * T * (Di + Do),
              "stream": 4.0 * T * Di * Do,
              "rank1": 2.0 * T * (Di + Do)}[m] * B * mult
        return LayerPlan(name, "dense", m, stash, nf, cf, cf,
                         stash_bytes=mem_stash, fallback_norm=fallback)

    if meta.kind == "conv":
        st = meta.static
        x_shape = tuple(cap_sh["x"].shape)[k:]
        B, C = x_shape[0], x_shape[1]
        D = app_dy[1]
        T = _prod(app_dy[2:])
        K = _prod(st["kernel_shape"][2:])
        g = max(st.get("groups", 1), 1)
        F, Dg = (C // g) * K, D // g
        cf = 2.0 * B * T * F * Dg * g * stack
        mem_stash = B * D * (C // g) * K * BYTES * stack
        mem_layer = B * D * (C // g) * K * BYTES
        stash = False
        fallback = conv_norm
        if conv_norm == "auto":
            per_ex = B * stack
            ghost_flops = (2.0 * T * T * (F + Dg)
                           + 2.0 * T * F * Dg) * g * per_ex
            ghost_total = ghost_flops - _fused_credit(
                T * (F + Dg) * g * BYTES * per_ex, ghost_flops)
            pe_stash = 4.0 * T * F * Dg * g * per_ex
            pe_again = (4.0 * T * F * Dg + 2.0 * T * F * Dg) * g * per_ex
            fallback = ("pe" if pe_again < ghost_total
                        and mem_layer <= mem_budget else "ghost")
            if pe_stash < ghost_total and mem_stash <= mem_budget:
                m, stash = "pe", True
            else:
                m = fallback
        else:
            m = conv_norm
            stash = m == "pe" and mem_stash <= mem_budget
        nf = (2.0 * B * T * T * (F + Dg) * g if m == "ghost"
              else 4.0 * B * T * F * Dg * g) * stack
        return LayerPlan(name, "conv", m, stash, nf, cf, cf,
                         stash_bytes=mem_stash, fallback_norm=fallback)

    if meta.kind == "embed":
        ids_shape = tuple(cap_sh["ids"].shape)[k:]
        B = ids_shape[0]
        T = _prod(ids_shape[1:])
        D = app_dy[-1]
        V = vocab or T
        stash_bytes = B * V * D * BYTES * stack
        seg_f = (T * max(math.log2(max(T, 2)), 1.0) + 2.0 * T * D)
        # stack multiplies the stashed (B, V, D) scratch for the budget
        m = (embed_method if embed_method != "auto"
             else embed_norm_method(T, D, B * stack, vocab))
        nf = {"gram": 2.0 * B * T * T * D,
              "pe": B * (T * D + V * D),
              "segsum": B * seg_f}[m] * stack
        cf = 2.0 * B * T * D * stack
        fb = m if m != "pe" else ("gram" if T <= 32 else "segsum")
        return LayerPlan(name, "embed", m, m == "pe", nf, cf, cf,
                         stash_bytes=stash_bytes, fallback_norm=fb)

    # scale: per-example grads are (B, d): materialize and stash
    B = app_dy[0] if app_dy else 1
    n = 2.0 * B * (_prod(app_dy) // max(B, 1)) * stack
    return LayerPlan(name, "scale", "pe", True, n, n, n,
                     stash_bytes=(B * app_dy[-1] * BYTES * stack
                                  if app_dy else 0.0))


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
                   overrides=None, clip_mode: str = "flat",
                   clip_fused: bool = True, calibration=None) -> ExecPlan:
    """Build the per-layer plan from probed shapes (``params``: the tree
    or its specs, read for the embedding tables' vocabulary sizes),
    priced under ``calibration`` (see :func:`resolve_cost_constants`).

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
    cc = resolve_cost_constants(calibration)
    layers: dict[str, LayerPlan] = {}
    by_path: dict[tuple, list] = {}
    for name, meta in metas.items():
        ov = _override_for(name, meta.kind, overrides)
        layers[name] = _plan_layer(
            name, meta, cap_shapes[name], tap_shapes[name],
            norm_method=ov or norm_method, embed_method=ov or embed_method,
            conv_norm=ov or conv_norm, mem_budget=mem_budget,
            vocab=_vocab_of(meta, params) if meta.kind == "embed" else None,
            clip_mode=clip_mode, clip_fused=clip_fused, cc=cc)
        by_path.setdefault(meta.path, []).append(name)

    total_wgrad = sum(lp.wgrad_flops for lp in layers.values())
    # A weighted backward pays the forward + dx chain (the fixed factor)
    # AND computes every parameter's wgrad — including those of groups
    # that keep their stash/contraction, whose share is pure waste.  So
    # switching the candidate set to the backward only pays off when the
    # contractions it replaces exceed fixed + total_wgrad.
    backward_cost = (BACKWARD_FIXED_FACTOR + 1.0) * total_wgrad

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

    capture_bytes = 0.0
    for name in metas:
        capture_bytes += sum(_nbytes(s) for s in cap_shapes[name].values())
        capture_bytes += 2.0 * _nbytes(tap_shapes[name])  # output + cotangent

    return ExecPlan(
        groups=tuple(groups), layers=layers, metas=metas,
        needs_backward=needs_backward,
        total_norm_flops=sum(lp.norm_flops for lp in layers.values()),
        total_contrib_flops=sum(lp.contrib_flops for lp in layers.values()),
        tap_shapes=dict(tap_shapes), capture_bytes=capture_bytes,
        clip_mode=clip_mode, calibration=cc.calibration)


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
                       batch_sig=None, clip_mode: str | None = None,
                       calibration=None):
    """Validate a deserialized/injected plan against the live context,
    naming the offending field — calibration, clipping mode, batch shape
    or fingerprint — so a stale plan fails loudly instead of executing a
    stale layout.  ``calibration`` is a Calibration or its digest ("" asserts
    the analytic constants)."""
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
                clip_mode="flat", clip_fused=True, calib=None) -> tuple:
    """The planner knobs as a hashable tuple, ending with the digest of
    the (resolved) calibration the plan is priced under ("" analytic)."""
    return (norm_method, embed_method, conv_norm, mem_budget,
            normalize_overrides(overrides),
            (str(clip_mode), bool(clip_fused)),
            "" if calib is None else calib.digest())


def plan_fingerprint(apply_fn, params, batch, *, norm_method: str = "auto",
                     embed_method: str = "auto", conv_norm: str = "auto",
                     mem_budget: int = STREAM_MEM_BUDGET, overrides=None,
                     clip_mode: str = "flat", clip_fused: bool = True,
                     mesh=None, calibration=None) -> str:
    """The fingerprint :func:`get_plan` would key this request on — same
    knob normalization, no probe."""
    _single_device(mesh)
    return model_fingerprint(
        apply_fn, params, batch,
        _opts_tuple(norm_method, embed_method, conv_norm, mem_budget,
                    overrides, clip_mode, clip_fused,
                    _resolve_calibration(calibration)))


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
    is never handed back."""
    _single_device(mesh)
    calib = _resolve_calibration(calibration)
    opts = _opts_tuple(norm_method, embed_method, conv_norm, mem_budget,
                       overrides, clip_mode, clip_fused, calib)
    key = (_fn_ident(apply_fn), _shape_sig(batch), _shape_sig(params), opts)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        return plan
    fp = model_fingerprint(apply_fn, params, batch, opts)
    plan = _PLAN_STORE.get(fp)
    if plan is None:
        metas, tap_shapes, cap_shapes = probe(apply_fn, params, batch,
                                              return_captures=True)
        plan = plan_execution(
            metas, cap_shapes, tap_shapes, params, norm_method=norm_method,
            embed_method=embed_method, conv_norm=conv_norm,
            mem_budget=mem_budget, overrides=opts[4], clip_mode=clip_mode,
            clip_fused=clip_fused,
            calibration="analytic" if calib is None else calib)
        plan = dataclasses.replace(plan, fingerprint=fp,
                                   batch_sig=_shape_sig(batch))
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


def predicted_step_flops(plan: ExecPlan) -> float:
    """FLOP-equivalents of one private step under this plan: forward +
    backward (≈ 2 wgrad shares) + wgrad + the plan's norm and contraction
    phases + the weighted second backward when taken.  One device moves
    no collective bytes."""
    total_wgrad = sum(lp.wgrad_flops for lp in plan.layers.values())
    flops = 3.0 * total_wgrad \
        + plan.total_norm_flops + plan.total_contrib_flops
    if plan.needs_backward:
        flops += (BACKWARD_FIXED_FACTOR + 1.0) * total_wgrad
    return flops


def predicted_step_seconds(plan: ExecPlan, calibration=None) -> float:
    """Predicted wall-clock of one step: :func:`predicted_step_flops` over
    the (calibrated or analytic) FLOP rate."""
    cc = resolve_cost_constants(calibration)
    return predicted_step_flops(plan) / cc.flops_per_second
