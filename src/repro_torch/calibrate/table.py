"""Calibration tables: measured hardware constants the planner trusts
(the JAX package's ``repro.calibrate.table``, for one device).

A :class:`Calibration` is the persisted result of one
:func:`repro_torch.calibrate.harness.measure` run on a concrete device:
the FLOP rate, the HBM streaming bandwidth and the kernel sweep winners
(``pe_conv_grad_2d``'s tile sweep).  The cost model converts these into
FLOP-equivalents-per-byte lookups that replace the analytic constants
whenever a calibration is active (:mod:`repro_torch.core.costmodel` keeps
the analytic values as the documented fallback).

The JSON format is the JAX package's (format 1, the same fields), so a
blob written by either package reads in the other.  The port measures no
collective bandwidth: ``collective_bytes_per_second`` stays ``{}`` and a
non-empty ``mesh`` raises ``NotImplementedError`` (sharding, ROADMAP.md
item 14).

Every deserialized blob is validated — wrong format or truncated
payload, non-finite or non-positive rates, a hardware signature that
does not match the live device — and each rejection raises a *named*
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
    """The JAX package's rejection of a blob measured for another mesh
    topology; kept so both packages name the same errors.  The port
    refuses any mesh with ``NotImplementedError`` instead."""


class CalibrationFallbackWarning(UserWarning):
    """Emitted (never raised) when a soft consumer falls back to the
    analytic constants because a calibration was absent or rejected."""


class CalibrationAxisFallbackWarning(UserWarning):
    """The JAX package's warning for an axis-less wire price on a
    multi-axis calibration; kept so both packages name the same
    warnings.  The port measures no mesh axes, so it never fires here."""


def _no_mesh(mesh) -> tuple:
    axes = costmodel.mesh_axes(mesh)
    if axes:
        raise NotImplementedError(
            f"calibration for mesh {costmodel.format_mesh(axes)}: meshes "
            f"and their collective bandwidths come with sharding "
            f"(ROADMAP.md item 14)")
    return axes


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
    """Measured hardware constants for one device.

    Rates are measured, not assumed:
      * ``flops_per_second``             — dense f32 matmul throughput;
      * ``hbm_bytes_per_second``         — streaming read+write bandwidth;
      * ``collective_bytes_per_second``  — ``{}`` (the port has no mesh);
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
        object.__setattr__(self, "mesh", _no_mesh(self.mesh))
        _finite_pos(self.flops_per_second, "flops_per_second")
        _finite_pos(self.hbm_bytes_per_second, "hbm_bytes_per_second")
        for axis, bw in dict(self.collective_bytes_per_second).items():
            _finite_pos(bw, f"collective_bytes_per_second[{axis!r}]")

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

    def validate_for(self, hardware: str):
        """Reject this calibration for a device it does not describe,
        naming what differs."""
        if self.hardware != hardware:
            raise CalibrationHardwareMismatch(
                f"calibration {self.digest()} was measured on "
                f"{self.hardware!r}, this process runs on {hardware!r}; "
                f"re-calibrate on this hardware")

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

    def retimed(self, *, predicted_s: float,
                measured_s: float) -> "Calibration":
        """A calibration updated so the cost model would have predicted
        ``measured_s`` for the step it predicted ``predicted_s`` for —
        the engine's mispredict feedback.  One device moves no collective
        bytes, so the FLOP rate absorbs the whole gap (the JAX package's
        rule when a step moved none; the wire's share comes with
        sharding, ROADMAP.md item 14).  Deterministic: a pure function of
        its inputs."""
        predicted_s = _finite_pos(predicted_s, "predicted_s")
        measured_s = _finite_pos(measured_s, "measured_s")
        return dataclasses.replace(
            self, flops_per_second=self.flops_per_second
            * (predicted_s / measured_s),
            source="replan", measured_at=self.measured_at)


# ---------------------------------------------------------------------------
# Process-wide registry: hardware signature -> Calibration (one device, so
# no mesh in the key).  The engine and the cost model consult it when no
# calibration is passed explicitly; load_plan_store() installs the
# calibrations persisted with a plan store, and the kernel wrappers read
# the sweep winners from it (ops.pe_conv_tile_rows).


_REGISTRY: dict[str, Calibration] = {}


def register(calib: Calibration) -> Calibration:
    _REGISTRY[calib.hardware] = calib
    return calib


def lookup(device=None) -> Calibration | None:
    """The calibration registered for ``device``'s hardware (the device
    this process would run on by default), or ``None``."""
    return _REGISTRY.get(hardware_signature(device))


def registered() -> list:
    return list(_REGISTRY.values())


def clear_registry():
    _REGISTRY.clear()


def load_calibration(path: str, *, expect_hardware: bool = True,
                     device=None) -> Calibration:
    """Strict file loader: parse, validate values, and check the blob
    against the live device (``device``, or the one this process would
    run on).  Raises named :class:`CalibrationError` subclasses; never
    warns-and-continues (see
    :func:`repro_torch.calibrate.load_or_fallback`)."""
    with open(path) as f:
        raw = f.read()
    calib = Calibration.from_json(raw)
    if expect_hardware:
        calib.validate_for(hardware_signature(device))
    return calib


def save_calibration(path: str, calib: Calibration):
    with open(path, "w") as f:
        f.write(calib.to_json(indent=1))


def injected(*, flops_per_second: float = 1e12,
             hbm_bytes_per_second: float = 1e11,
             kernels: dict | None = None,
             hardware: str | None = None, device=None) -> Calibration:
    """A synthetic calibration for tests: known rates on the live
    hardware signature (so context validation passes), marked
    ``source="injected"``."""
    return Calibration(
        hardware=hardware or hardware_signature(device),
        flops_per_second=flops_per_second,
        hbm_bytes_per_second=hbm_bytes_per_second,
        kernels=dict(kernels or {}), measured_at=time.time(),
        source="injected")

