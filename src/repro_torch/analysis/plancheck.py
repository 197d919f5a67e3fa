"""Plan/graph consistency: the ExecPlan's declared realizations must
actually appear in the traced step.

The JAX package's pass (``repro/analysis/plancheck.py``) against the
port's :class:`~repro_torch.core.costmodel.ExecPlan`.  The planner
publishes per-layer decisions (``LayerPlan.norm_method``, ``stash``,
``fused``; ``GroupPlan.norm_mode`` / ``sum_method``); the executing
pipeline tags what it *really* ran (``dp_tag`` markers of kind
``group_norm``, ``realization``, ``fused_impl``).  Per parameter group:

  * a ``group_norm`` marker exists with the planned method
    (``stash`` / the layer's norm method / ``tied`` / ``pe``);
  * layers whose norm the plan realizes analytically (an ``attn`` block's
    included) carry a matching ``realization`` marker at the layer's
    parameter path;
  * stale-fused layers carry a ``fused_impl`` marker, and the
    ``tapper.STATS`` deltas recorded while tracing agree (exactly one
    forward and backward plus the planned extra weighted backward, zero
    probes once planned, ``fused`` live iff the plan fused);
  * the plan's fingerprint matches the engine's live fingerprint;
  * the plan's predicted collective bytes a step and device stay under
    ``coll_bytes_warn`` (``coll_bytes_high``, a warning).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.analysis.graph import FlatGraph
from repro_torch.analysis.report import Finding


def _expected_group_method(g, plan, stale_steady: bool) -> List[str]:
    """Acceptable ``group_norm`` marker methods for one plan group."""
    if g.norm_mode == "tied":
        return ["tied"]
    if g.norm_mode == "group_pe":
        return ["pe"]
    lp = plan.layers[g.members[0]]
    if stale_steady and lp.fused:
        return [lp.norm_method]
    if lp.stash:
        return ["stash"]
    return [lp.norm_method]


def check_plan(graph: FlatGraph, *, plan, clip_mode: str,
               stale_steady: bool, stats_delta: Optional[Dict[str, int]],
               expected_fingerprint: Optional[str] = None,
               microbatches: int = 1,
               coll_bytes_warn: Optional[float] = None) -> List[Finding]:
    """The plan against the traced graph and the ``STATS`` delta of the
    trace.  The port's microbatch loop is a Python loop, so the trace
    runs each microbatch's passes (the JAX package's scan traces one
    body): the census expects ``microbatches`` times one step's."""
    findings: List[Finding] = []
    where = "plan"
    if plan is None:
        return findings

    group_markers: Dict[str, list] = {}
    realization_paths = set()
    for _, p in graph.markers():
        kind = p.get("kind")
        if kind == "group_norm":
            group_markers.setdefault(p.get("group"), []).append(p)
        elif kind in ("realization", "fused_impl"):
            realization_paths.add((kind, p.get("path")))

    from repro_torch.core.strategies import group_key_of

    for g in plan.groups:
        key = group_key_of(g.path)
        expect = _expected_group_method(g, plan, stale_steady)
        seen = group_markers.get(key, [])
        if not seen:
            findings.append(Finding(
                "error", "plan_group_missing",
                f"plan group {key!r} ({g.norm_mode}/{g.sum_method}) has no "
                f"group_norm marker in the traced step — its planned "
                f"realization never executed", where))
            continue
        methods = {m.get("method") for m in seen}
        if not methods & set(expect):
            findings.append(Finding(
                "error", "plan_method_mismatch",
                f"plan group {key!r} declares norm method {expect} but the "
                f"step realized {sorted(methods)}", where))
        if g.norm_mode != "single":
            continue
        lp = plan.layers[g.members[0]]
        if stale_steady and lp.fused:
            if not any(m.get("fused") for m in seen):
                findings.append(Finding(
                    "error", "plan_fused_missing",
                    f"plan marks group {key!r} fused (single-pass "
                    f"norm+contrib) but the step ran the two-reduction "
                    f"path", where))
            if ("fused_impl", key) not in realization_paths:
                findings.append(Finding(
                    "error", "plan_fused_missing",
                    f"no fused_impl marker for fused group {key!r}", where))
        elif not lp.stash and ("realization", key) not in realization_paths:
            # Analytic single-layer realizations must also be visible at
            # the kind level (the census `apply_kind` dispatched).
            findings.append(Finding(
                "error", "plan_realization_missing",
                f"no realization marker at path {key!r} for planned "
                f"norm method {lp.norm_method!r}", where))

    # -- STATS census ------------------------------------------------------
    if stats_delta is not None:
        expect_bwd = microbatches * (
            1 + (1 if (plan.needs_backward and not stale_steady) else 0))
        for field in ("forwards", "backwards"):
            got = stats_delta.get(field, -1)
            if got != expect_bwd:
                findings.append(Finding(
                    "error", "stats_mismatch",
                    f"traced {got} {field} but the plan promises "
                    f"{expect_bwd} (needs_backward={plan.needs_backward})",
                    where))
        if stats_delta.get("probes", 0) != 0:
            findings.append(Finding(
                "warning", "stats_probe",
                f"{stats_delta['probes']} shape probe(s) ran during the "
                f"traced step — planned execution should never re-probe",
                where))
        any_fused = any(lp.fused for lp in plan.layers.values())
        fused_runs = stats_delta.get("fused", 0)
        if stale_steady and any_fused and fused_runs == 0:
            findings.append(Finding(
                "error", "plan_fused_missing",
                "plan has fused layers but no fused norm+contrib pass "
                "executed (STATS.fused did not move)", where))
        if fused_runs > 0 and not (stale_steady and any_fused):
            findings.append(Finding(
                "warning", "stats_fused_unplanned",
                f"{fused_runs} fused norm+contrib pass(es) executed but "
                f"the plan declares none", where))

    # -- identity ---------------------------------------------------------
    if expected_fingerprint is not None \
            and plan.fingerprint and plan.fingerprint != expected_fingerprint:
        findings.append(Finding(
            "error", "plan_fingerprint_stale",
            f"executing plan fingerprint {plan.fingerprint} != the "
            f"engine's live fingerprint {expected_fingerprint} — stale "
            f"plan-store entry (model code or shapes changed)", where))
    if plan.clip_mode != clip_mode:
        findings.append(Finding(
            "error", "plan_clip_mode_mismatch",
            f"plan was built for clipping mode {plan.clip_mode!r}, the "
            f"engine clips {clip_mode!r}", where))

    # -- predicted collective traffic -------------------------------------
    if coll_bytes_warn and plan.total_coll_bytes > coll_bytes_warn:
        by_axis = plan.total_coll_bytes_by_axis
        per_axis = ("" if not by_axis else " ["
                    + ", ".join(f"{a}: {b / 2**20:.1f} MB"
                                for a, b in by_axis) + "]")
        findings.append(Finding(
            "warning", "coll_bytes_high",
            f"plan predicts {plan.total_coll_bytes / 2**20:.1f} MB/device "
            f"of collective traffic per step{per_axis} (threshold "
            f"{coll_bytes_warn / 2**20:.0f} MB) — a stash/backward layout "
            f"is putting per-example state on the wire; compare "
            f"realizations with engine.explain()", where))
    return findings
