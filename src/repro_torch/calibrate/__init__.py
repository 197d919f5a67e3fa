"""Measured-cost calibration: the planner trusts the card.

``repro_torch.calibrate`` is the JAX package's ``repro.calibrate``:

  * :mod:`~repro_torch.calibrate.harness` measures the FLOP rate, the HBM
    bandwidth, the ring all-reduce bandwidth of each axis of a live
    mesh (over that axis's process group) and, on the card, ``pe_conv_grad_2d``'s
    tile sweep and ``gram_norm_fused``'s time;
  * :mod:`~repro_torch.calibrate.table` holds the validated, serializable
    :class:`Calibration` result and the process-wide registry the cost
    model and the kernel wrappers consult;
  * :func:`load_or_fallback` / :func:`get_or_measure` are the soft entry
    points the engine and the CLI use — a bad blob degrades to the
    analytic constants with a named :class:`CalibrationFallbackWarning`,
    never a crash, while the strict loaders in ``table`` never
    downgrade.

Calibrations are keyed by (hardware, mesh), a ``data x model`` mesh
included.
"""
from __future__ import annotations

import warnings

from repro_torch.calibrate.table import (  # noqa: F401  (public re-exports)
    CALIBRATION_FORMAT_VERSION, Calibration,
    CalibrationAxisFallbackWarning, CalibrationError,
    CalibrationFallbackWarning, CalibrationFormatError,
    CalibrationHardwareMismatch, CalibrationMeshMismatch,
    CalibrationValueError, clear_registry, hardware_signature, injected,
    load_calibration, lookup, register, registered, save_calibration)
from repro_torch.calibrate.harness import measure  # noqa: F401


def load_or_fallback(path: str, *, device=None, mesh=None):
    """Load + validate a stored calibration for ``device`` and ``mesh``;
    on *any* failure (missing file, truncated blob, wrong hardware or
    mesh, bad rates)
    emit a named :class:`CalibrationFallbackWarning` and return ``None``
    so the caller plans with the analytic constants."""
    try:
        return load_calibration(path, device=device, expect_mesh=mesh)
    except (OSError, CalibrationError) as e:
        warnings.warn(
            f"calibration {path!r} unusable ({type(e).__name__}: {e}); "
            f"falling back to analytic cost constants",
            CalibrationFallbackWarning, stacklevel=2)
        return None


def get_or_measure(mesh=None, *, quick: bool = True, device="cuda",
                   groups=None) -> Calibration:
    """The calibration registered for ``device``'s hardware and ``mesh``,
    measuring and registering one if absent — what an engine built with
    ``calibration="measure"`` uses (``groups``: each axis's process
    group)."""
    calib = lookup(device, mesh=mesh)
    if calib is None:
        calib = register(measure(mesh, quick=quick, device=device,
                                 groups=groups))
    return calib
