"""Noise-discipline pass: one fresh Gaussian per released aggregate.

The JAX package's checks (``repro/analysis/noise.py``) on the port's own
terms, over the captured private-step graph:

  * **count** — with ``noise_multiplier > 0`` there is exactly one
    ``dp_tag[kind=noise]`` marker, and at most one Gaussian draw
    (``randn`` / ``normal``), per released parameter leaf.  Zero draws =
    the noise was dropped; more = double noise (the variance, and hence
    the real ε, silently changes).
  * **scale** — each noise marker's recorded ``sigma`` equals
    ``noise_multiplier * l2_clip``.
  * **precision** — noise is drawn and scaled in float32 *before* any
    cast to the parameter dtype, and the clip-decision inputs (clip
    coefficients, group norms) are float32.
  * **stream hygiene** — a draw's randomness is its ``torch.Generator``
    (noted on its node while the graph was recorded).  Every draw must
    take an explicit generator seeded from the step's seed,
    ``noise_seed(run_seed, step)``: a draw from the default generator,
    or from a generator with any other seed, is ``key_constant``.  No
    two draws may consume one generator's stream at one position: a
    generator's draws consume it in graph order, so two generators of
    one seed and one starting state (a fresh generator a leaf, seeded
    with the step's seed) consume the same stream, and that is
    ``key_reuse``: the leaves' noise is correlated.

Deriving the step's seed from ``(run_seed, step)`` happens host-side
(``PrivacyEngine._check_key`` rejects a generator seeded for another
step), and the pass records that it was checked.  The finding codes are
the JAX package's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis.graph import FlatGraph, dtype, op_name
from repro_torch.analysis.report import Finding

# Ops that draw Gaussian noise.
_DRAWS = {"randn", "normal", "randn_like", "normal_"}


def check_noise(graph: FlatGraph, *, step_seed: Optional[int],
                n_param_leaves: int, noise_multiplier: float,
                l2_clip: float) -> List[Finding]:
    findings: List[Finding] = []
    where = "noise"

    markers = [(n, p) for n, p in graph.markers()
               if p.get("kind") == "noise"]
    draws = [n for n in graph.nodes if op_name(n) in _DRAWS]

    if noise_multiplier <= 0.0:
        if markers:
            findings.append(Finding(
                "error", "noise_without_sigma",
                f"{len(markers)} noise marker(s) present but "
                f"noise_multiplier == {noise_multiplier}", where))
        return findings

    # -- count: one fresh Gaussian per released leaf ----------------------
    if len(markers) == 0:
        findings.append(Finding(
            "error", "noise_missing",
            "noise_multiplier > 0 but no Gaussian noise marker appears "
            "in the step graph — the release is un-noised", where))
    elif len(markers) < n_param_leaves:
        findings.append(Finding(
            "error", "noise_missing",
            f"only {len(markers)} noise draw(s) for {n_param_leaves} "
            f"released parameter leaves", where))
    elif len(markers) > n_param_leaves:
        findings.append(Finding(
            "error", "noise_duplicated",
            f"{len(markers)} noise draws for {n_param_leaves} released "
            f"parameter leaves — noise is added more than once, the "
            f"effective sigma differs from the accountant's", where))
    if len(draws) > n_param_leaves:
        findings.append(Finding(
            "error", "noise_duplicated",
            f"{len(draws)} Gaussian draws traced for {n_param_leaves} "
            f"released leaves", where))
    elif 0 < len(draws) < n_param_leaves and markers:
        findings.append(Finding(
            "warning", "noise_sampler_census",
            f"{len(draws)} Gaussian draws vs {n_param_leaves} leaves — "
            f"sampler not recognized per leaf (custom sampler?)", where))

    # -- scale: sigma == noise_multiplier * l2_clip -----------------------
    expect = float(noise_multiplier) * float(l2_clip)
    for _, p in markers:
        sigma = float(p.get("sigma", float("nan")))
        if not np.isclose(sigma, expect, rtol=1e-6, atol=0.0):
            findings.append(Finding(
                "error", "noise_scale_mismatch",
                f"noise marker sigma={sigma} != noise_multiplier * "
                f"l2_clip = {expect}", where))
            break
        m = float(p.get("noise_multiplier", noise_multiplier))
        c = float(p.get("l2_clip", l2_clip))
        if not (np.isclose(m, noise_multiplier) and np.isclose(c, l2_clip)):
            findings.append(Finding(
                "error", "noise_scale_mismatch",
                f"noise marker recorded (noise_multiplier={m}, "
                f"l2_clip={c}) but the engine config says "
                f"({noise_multiplier}, {l2_clip})", where))
            break

    # -- precision: f32 draw, f32 clip decisions --------------------------
    for node in [n for n, _ in markers] + draws:
        dt = dtype(node)
        if dt is not None and dt != torch.float32:
            findings.append(Finding(
                "error", "noise_low_precision",
                f"noise drawn/scaled in {dt}, not float32 — the cast to "
                f"the param dtype must come *after* signal+noise", where))
            break
    for kind, code in (("clip_coef", "clip_coef_low_precision"),
                       ("group_norm", "norm_low_precision")):
        for node, p in graph.markers():
            if p.get("kind") != kind:
                continue
            dt = dtype(node)
            if dt is not None and dt.is_floating_point \
                    and dt not in (torch.float32, torch.float64):
                findings.append(Finding(
                    "error", code,
                    f"{kind} computed in {dt}; clip decisions must be "
                    f"float32 (bf16 norms break the sensitivity bound)",
                    where))
                break

    # -- stream hygiene ---------------------------------------------------
    position = {}     # generator -> draws consumed so far, in graph order
    streams = set()   # (seed, starting state, position) of each draw
    for node in draws:
        g = graph.generator(node)
        if g is None:
            findings.append(Finding(
                "error", "key_constant",
                "a Gaussian draw takes the default generator, not the "
                "step's — noise would not follow the (run_seed, step) "
                "stream", where))
            continue
        seed = g.initial_seed()
        if step_seed is not None and seed != step_seed:
            findings.append(Finding(
                "error", "key_constant",
                f"a Gaussian draw takes a generator seeded {seed}, not the "
                f"step's seed {step_seed} — noise would repeat across "
                f"runs/steps", where))
        pos = position.get(id(g), 0)
        position[id(g)] = pos + 1
        stream = (seed, bytes(g.get_state().tolist()), pos)
        if stream in streams:
            findings.append(Finding(
                "error", "key_reuse",
                "two Gaussian draws consume one generator stream at one "
                "position — noise is correlated across leaves", where))
        streams.add(stream)

    return findings
