"""The scalar cost models that the ``"auto"`` norm methods of
:mod:`repro_torch.core.kinds` consult.

Only the crossover formulas live here in this slice; the per-layer
planner, ``ExecPlan`` and its store come with ROADMAP.md item 9.
"""
from __future__ import annotations

from typing import Mapping

GRAM_CHUNK = 1024
STREAM_MEM_BUDGET = 2 << 30  # bytes of per-example-grad scratch we tolerate
BYTES = 4


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


def normalize_overrides(overrides) -> tuple:
    """Per-layer overrides as an ordered, hashable tuple of (pattern,
    method) pairs.  Patterns are fnmatch globs over tap names; the first
    match wins.  Only the planner reads them."""
    if not overrides:
        return ()
    if isinstance(overrides, Mapping):
        overrides = overrides.items()
    return tuple((str(p), str(m)) for p, m in overrides)
