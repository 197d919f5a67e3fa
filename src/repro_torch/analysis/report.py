"""Structured findings for the static DP verifier (the JAX package's
``analysis/report.py``, with a ``census`` of the markers found)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier observation.

    ``severity``: "error" (a DP invariant is broken or unprovable),
    "warning" (legal but suspicious — e.g. pathological predicted
    collective traffic), or "info" (context only; never fails a gate).
    ``code`` is a stable machine-readable slug (what the mutation suite
    asserts on); ``where`` names the pass and, when known, the graph
    location.
    """

    severity: str
    code: str
    message: str
    where: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity.upper():7s} {self.code}: {self.message}{loc}"


@dataclasses.dataclass
class VerifyReport:
    """The result of :func:`repro_torch.analysis.verifier.verify_engine`.

    ``target`` describes the verified engine (model / clip mode / mesh);
    ``checked`` maps each pass name to a one-line summary of what it
    established (shown even when everything is clean, so a passing
    report documents *what* was proven, not just the absence of
    findings); ``census`` counts what the traced graph holds
    (:func:`repro_torch.analysis.graph.census`: markers by kind, group,
    method and path, kernel nodes by op, nodes).
    """

    target: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    checked: Dict[str, str] = dataclasses.field(default_factory=dict)
    census: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def has(self, code: str) -> bool:
        return any(f.code == code for f in self.findings)

    def raise_if_failed(self):
        if not self.ok:
            raise DPVerificationError(self)

    def summary(self) -> str:
        head = "PASS" if self.ok else "FAIL"
        lines = [f"[{head}] dpcheck: {self.target} — "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        for name, what in self.checked.items():
            lines.append(f"  ✓ {name}: {what}")
        for f in self.findings:
            if f.severity != "info":
                lines.append(f"  {f}")
        return "\n".join(lines)


class DPVerificationError(AssertionError):
    """Raised by ``VerifyReport.raise_if_failed`` when errors exist."""

    def __init__(self, report: VerifyReport):
        self.report = report
        super().__init__(report.summary())
