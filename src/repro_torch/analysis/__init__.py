"""Static DP verification (``dpcheck``), the JAX package's
``repro.analysis`` over a captured torch graph.

Traces :class:`repro_torch.core.engine.PrivacyEngine`'s private step with
``make_fx`` on fake tensors, so the graph is the one that runs on the
engine's device with each hand-written kernel one node, and proves the
clip → aggregate → noise pipeline well formed by abstract interpretation
— no execution.  Entry points:

  * ``engine.verify()`` — the engine-side surface (returns a
    :class:`~repro_torch.analysis.report.VerifyReport`);
  * :func:`repro_torch.analysis.verifier.verify_engine` — the functional
    core;
  * ``python -m repro_torch.launch.dpcheck`` — the CLI sweep over the
    model registry × clip modes (the CI gate).

The pipeline tags its load-bearing values with the
:func:`repro_torch.analysis.markers.tag` custom op (clip coefficients,
group norms, realizations, noise terms), so the analyzer recognizes
structure instead of pattern-matching aten soup.
"""
from repro_torch.analysis.markers import MARKER_OP, is_marker, tag
from repro_torch.analysis.report import (DPVerificationError, Finding,
                                         VerifyReport)
from repro_torch.analysis.verifier import verify_engine

__all__ = [
    "DPVerificationError",
    "Finding",
    "MARKER_OP",
    "VerifyReport",
    "is_marker",
    "tag",
    "verify_engine",
]
