"""Calibration tables: measured hardware constants the planner trusts
(the JAX package's ``repro.calibrate.table``).

A :class:`Calibration` is the persisted result of one
:func:`repro_torch.calibrate.harness.measure` run on a concrete
(hardware, mesh) pair: the FLOP rate, the HBM streaming bandwidth, the
ring all-reduce wire bandwidth of each axis of the mesh, and the
kernel sweep winners (``pe_conv_grad_2d``'s tile sweep).  The cost
model converts these into FLOP-equivalents-per-byte lookups that replace
the analytic constants whenever a calibration is active
(:mod:`repro_torch.core.costmodel` keeps the analytic values as the
documented fallback).

The JSON format is the JAX package's (format 1, the same fields), so a
blob written by either package reads in the other.  The registry is
keyed by (hardware, mesh), as the JAX package's; a ``data x model``
mesh is one key, and each of its axes has its own bandwidth.

Every deserialized blob is validated — wrong format or truncated
payload, non-finite or non-positive rates, a hardware signature or mesh
that does not match the live context — and each rejection raises a *named*
error (:class:`CalibrationFormatError`, :class:`CalibrationValueError`,
:class:`CalibrationHardwareMismatch`, :class:`CalibrationMeshMismatch`).
Soft consumers (engine init, the CLI) catch :class:`CalibrationError`,
emit a :class:`CalibrationFallbackWarning` and plan with the analytic
table; the strict loaders never downgrade an error to a warning.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import platform
import time
import warnings
from typing import Any, Mapping

import torch

from repro_torch.core import costmodel

CALIBRATION_FORMAT_VERSION = 1


class CalibrationError(ValueError):
    """Base class for every calibration rejection (named subclasses)."""


class CalibrationFormatError(CalibrationError):
    """The blob is not a readable calibration: wrong/missing format
    version, missing required fields, or a truncated/undecodable payload."""


class CalibrationValueError(CalibrationError):
    """A measured rate is unusable: NaN, infinite, zero, or negative.
    Planning against such a value would divide by it, so the blob is
    rejected whole."""


class CalibrationHardwareMismatch(CalibrationError):
    """The blob was measured on different hardware than this process
    runs on; its rates say nothing about the live device."""


class CalibrationMeshMismatch(CalibrationError):
    """The blob was measured for a different mesh topology (or an axis
    it lacks was asked for); its collective bandwidths do not describe
    the topology being planned."""


class CalibrationFallbackWarning(UserWarning):
    """Emitted (never raised) when a soft consumer falls back to the
    analytic constants because a calibration was absent or rejected."""


class CalibrationAxisFallbackWarning(UserWarning):
    """Multi-axis collective traffic priced through the axis-less
    (slowest-axis) lookup."""


def _mesh(mesh) -> tuple:
    """``mesh`` normalized (``costmodel.mesh_axes``): data and model
    axes alike, each with its own collective bandwidth."""
    return costmodel.mesh_axes(mesh)


def hardware_signature(device=None) -> str:
    """Identity of the hardware a device is — what a stored calibration
    is keyed to: ``"<type>:<name>:<count>"``, with
    ``torch.cuda.get_device_name`` and the card count on a card
    (``"cuda:NVIDIA H100 80GB HBM3:1"``) and the machine's architecture
    on the CPU, so a blob measured on the CPU is rejected on the card.
    ``device=None`` names the device this process would run on: the
    card when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return (f"cuda:{torch.cuda.get_device_name(dev)}:"
                f"{torch.cuda.device_count()}")
    if dev.type == "cpu":
        return f"cpu:{platform.machine() or 'unknown'}:1"
    return f"{dev.type}:unknown:1"


def _finite_pos(value, name: str) -> float:
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise CalibrationValueError(
            f"calibration field {name!r} is not a number: {value!r}")
    if not math.isfinite(v) or v <= 0.0:
        raise CalibrationValueError(
            f"calibration field {name!r} must be a finite positive rate, "
            f"got {value!r}")
    return v


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured hardware constants for one (hardware, mesh) pair.

    Rates are measured, not assumed:
      * ``flops_per_second``             — dense f32 matmul throughput;
      * ``hbm_bytes_per_second``         — streaming read+write bandwidth;
      * ``collective_bytes_per_second``  — per mesh axis, the ring
        all-reduce *wire* bandwidth (``ring(d)·shard_bytes`` a second, the
        convention the cost model charges); ``{}`` off-mesh;
      * ``kernels``                      — per-kernel sweep results, e.g.
        ``{"pe_conv_grad": {"tile_rows": 64, "sweep": {...}}}``.

    ``source`` records provenance: ``"measured"`` (harness),
    ``"injected"`` (tests feeding known timings), or ``"replan"``
    (derived by the engine's mispredict loop from an observed step
    time).
    """

    hardware: str
    mesh: tuple = ()
    flops_per_second: float = 0.0
    hbm_bytes_per_second: float = 0.0
    collective_bytes_per_second: dict = dataclasses.field(
        default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    measured_at: float = 0.0
    source: str = "measured"

    def __post_init__(self):
        object.__setattr__(self, "mesh", _mesh(self.mesh))
        _finite_pos(self.flops_per_second, "flops_per_second")
        _finite_pos(self.hbm_bytes_per_second, "hbm_bytes_per_second")
        for axis, bw in dict(self.collective_bytes_per_second).items():
            _finite_pos(bw, f"collective_bytes_per_second[{axis!r}]")

    def collective_flops_per_byte(self, axis: str | None = None) -> float:
        """FLOP-equivalents of one collective byte on the wire of mesh
        axis ``axis``.  The axis-less form prices all traffic at the
        slowest measured axis and warns when there are several."""
        table = self.collective_bytes_per_second
        if not table:
            raise CalibrationValueError(
                f"calibration {self.digest()} has no collective "
                f"measurements (mesh {costmodel.format_mesh(self.mesh)})")
        if axis is not None:
            if axis not in table:
                raise CalibrationMeshMismatch(
                    f"calibration {self.digest()} has no measurement for "
                    f"mesh axis {axis!r}; measured axes: {sorted(table)}")
            return self.flops_per_second / table[axis]
        if len(table) > 1:
            warnings.warn(
                f"calibration {self.digest()} measured {len(table)} mesh "
                f"axes {sorted(table)} but was asked for an axis-less wire "
                f"price; pricing all traffic at the slowest axis",
                CalibrationAxisFallbackWarning, stacklevel=2)
        return self.flops_per_second / min(table.values())

    def hbm_flops_per_byte(self) -> float:
        """FLOP-equivalents of one HBM byte: what the cost model credits
        the fused norm+contrib realizations with."""
        return self.flops_per_second / self.hbm_bytes_per_second

    # -- identity / validation ---------------------------------------------

    def digest(self) -> str:
        """Content hash of the measured values — what plan fingerprints
        fold in, so a plan built under different measured constants keys
        (and fails safe) exactly like a plan built from different code."""
        payload = dict(self.to_payload())
        payload.pop("measured_at", None)   # identity is the values
        return hashlib.sha1(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()[:12]

    def validate_for(self, hardware: str | None = None, mesh=None):
        """Reject this calibration for a live context (device, mesh) it
        does not describe, naming what differs."""
        if hardware is not None and self.hardware != hardware:
            raise CalibrationHardwareMismatch(
                f"calibration {self.digest()} was measured on "
                f"{self.hardware!r}, this process runs on {hardware!r}; "
                f"re-calibrate on this hardware")
        if mesh is not None:
            ms = costmodel.mesh_axes(mesh)
            if self.mesh != ms:
                raise CalibrationMeshMismatch(
                    f"calibration {self.digest()} was measured for mesh "
                    f"{costmodel.format_mesh(self.mesh)}, this process "
                    f"plans {costmodel.format_mesh(ms)}; re-calibrate "
                    f"for this topology")

    # -- serialization -----------------------------------------------------

    def to_payload(self) -> dict:
        return {
            "format": CALIBRATION_FORMAT_VERSION,
            "hardware": self.hardware,
            "mesh": [[n, s] for n, s in self.mesh],
            "flops_per_second": self.flops_per_second,
            "hbm_bytes_per_second": self.hbm_bytes_per_second,
            "collective_bytes_per_second":
                dict(self.collective_bytes_per_second),
            "kernels": self.kernels,
            "measured_at": self.measured_at,
            "source": self.source,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_payload(), **kw)

    @classmethod
    def from_payload(cls, p: Any) -> "Calibration":
        if not isinstance(p, Mapping):
            raise CalibrationFormatError(
                f"calibration payload is not a mapping: {type(p).__name__}")
        if p.get("format") != CALIBRATION_FORMAT_VERSION:
            raise CalibrationFormatError(
                f"unsupported calibration format {p.get('format')!r} "
                f"(this build reads {CALIBRATION_FORMAT_VERSION})")
        required = ("hardware", "flops_per_second", "hbm_bytes_per_second",
                    "collective_bytes_per_second")
        missing = [k for k in required if k not in p]
        if missing:
            raise CalibrationFormatError(
                f"calibration payload is missing fields {missing} "
                f"(truncated or foreign blob)")
        try:
            return cls(
                hardware=str(p["hardware"]),
                mesh=tuple((str(n), int(s)) for n, s in p.get("mesh", [])),
                flops_per_second=p["flops_per_second"],
                hbm_bytes_per_second=p["hbm_bytes_per_second"],
                collective_bytes_per_second={
                    str(k): v
                    for k, v in p["collective_bytes_per_second"].items()},
                kernels=dict(p.get("kernels", {})),
                measured_at=float(p.get("measured_at", 0.0)),
                source=str(p.get("source", "measured")))
        except CalibrationError:
            raise
        except (TypeError, ValueError, AttributeError) as e:
            raise CalibrationFormatError(
                f"malformed calibration payload: {e}") from e

    @classmethod
    def from_json(cls, s: str) -> "Calibration":
        try:
            payload = json.loads(s)
        except json.JSONDecodeError as e:
            raise CalibrationFormatError(
                f"calibration blob is not valid JSON (truncated?): "
                f"{e}") from e
        return cls.from_payload(payload)

    # -- derivation --------------------------------------------------------

    def retimed(self, *, predicted_s: float, measured_s: float,
                coll_bytes: float = 0.0,
                coll_bytes_by_axis=None) -> "Calibration":
        """A calibration updated so the cost model would have predicted
        ``measured_s`` for the step it predicted ``predicted_s`` for —
        the engine's mispredict feedback (the JAX package's rule).  When
        the step moved collective bytes on measured axes, the gap is put
        on the wire (holding the compute share fixed); otherwise the FLOP
        rate absorbs it.  Deterministic: a pure function of its inputs."""
        predicted_s = _finite_pos(predicted_s, "predicted_s")
        measured_s = _finite_pos(measured_s, "measured_s")
        table = self.collective_bytes_per_second
        by_axis = dict(coll_bytes_by_axis or ())
        if table and (by_axis or coll_bytes > 0.0):
            if by_axis:
                wire_s_old = sum(float(b) / table[a]
                                 for a, b in by_axis.items() if a in table)
            else:
                wire_s_old = (self.collective_flops_per_byte() * coll_bytes
                              / self.flops_per_second)
            if wire_s_old > 0.0:
                compute_s = max(predicted_s - wire_s_old, 1e-12)
                wire_s_new = max(measured_s - compute_s, 1e-12)
                scale = wire_s_old / wire_s_new
                return dataclasses.replace(
                    self, collective_bytes_per_second={
                        a: bw * scale for a, bw in table.items()},
                    source="replan", measured_at=self.measured_at)
        return dataclasses.replace(
            self, flops_per_second=self.flops_per_second
            * (predicted_s / measured_s),
            source="replan", measured_at=self.measured_at)


# ---------------------------------------------------------------------------
# Process-wide registry: (hardware signature, mesh) -> Calibration.  The
# engine and the cost model consult it when no
# calibration is passed explicitly; load_plan_store() installs the
# calibrations persisted with a plan store, and the kernel wrappers read
# the sweep winners from it (ops.pe_conv_tile_rows).


_REGISTRY: dict[tuple, Calibration] = {}


def register(calib: Calibration) -> Calibration:
    _REGISTRY[(calib.hardware, calib.mesh)] = calib
    return calib


def lookup(device=None, *, mesh=None) -> Calibration | None:
    """The calibration registered for ``device``'s hardware (the device
    this process would run on by default) and ``mesh``, or ``None``.
    Exact-mesh match only: a ``data:8`` calibration never prices a
    ``data:4`` plan."""
    return _REGISTRY.get((hardware_signature(device),
                          costmodel.mesh_axes(mesh)))


def registered() -> list:
    return list(_REGISTRY.values())


def clear_registry():
    _REGISTRY.clear()


def load_calibration(path: str, *, expect_hardware: bool = True,
                     device=None, expect_mesh=None) -> Calibration:
    """Strict file loader: parse, validate values, and check the blob
    against the live device (``device``, or the one this process would
    run on) and, when given, ``expect_mesh``.  Raises named
    :class:`CalibrationError` subclasses; never warns-and-continues (see
    :func:`repro_torch.calibrate.load_or_fallback`)."""
    with open(path) as f:
        raw = f.read()
    calib = Calibration.from_json(raw)
    calib.validate_for(
        hardware_signature(device) if expect_hardware else None,
        mesh=expect_mesh)
    return calib


def save_calibration(path: str, calib: Calibration):
    with open(path, "w") as f:
        f.write(calib.to_json(indent=1))


def injected(*, mesh=(), flops_per_second: float = 1e12,
             hbm_bytes_per_second: float = 1e11,
             collective_bytes_per_second=None,
             kernels: dict | None = None,
             hardware: str | None = None, device=None) -> Calibration:
    """A synthetic calibration for tests: known rates on the live
    hardware signature (so context validation passes), marked
    ``source="injected"``.  ``collective_bytes_per_second`` is one float
    (every mesh axis) or a per-axis mapping."""
    ms = costmodel.mesh_axes(mesh)
    coll = collective_bytes_per_second
    if coll is None:
        coll = {}
    if not isinstance(coll, Mapping):
        coll = {name: float(coll) for name, _ in ms}
    return Calibration(
        hardware=hardware or hardware_signature(device), mesh=ms,
        flops_per_second=flops_per_second,
        hbm_bytes_per_second=hbm_bytes_per_second,
        collective_bytes_per_second=dict(coll),
        kernels=dict(kernels or {}), measured_at=time.time(),
        source="injected")

