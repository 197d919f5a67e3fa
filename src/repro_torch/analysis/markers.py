"""``tag``: the marker the core pipeline puts on its load-bearing values:

  * ``kind="clip_coef"``   — per-example clip coefficients (``mode`` says
    which policy produced them: flat, per_layer or stale);
  * ``kind="group_norm"``  — a parameter group's per-example squared
    norms, with the group key, the realized method and whether a fused
    single pass produced them;
  * ``kind="realization"`` — a kind-level norm realization;
  * ``kind="fused_impl"``  — a fused norm+contrib single pass
    (``gram_norm_fused``);
  * ``kind="noise"``       — each Gaussian noise term.

In the JAX package it is an identity primitive that the static verifier
finds in the traced graph.  Here it is the identity for now, with the
same argument checks; the verifier slice (ROADMAP.md item 15) makes it a
custom op that a captured torch graph keeps.
"""
from __future__ import annotations

from typing import Any

_ALLOWED = (str, int, float, bool)


def tag(x, **params: Any):
    """Identity on ``x``.  ``params`` must include ``kind=`` and hold only
    static scalars (str/int/float/bool)."""
    if "kind" not in params:
        raise ValueError("dp_tag requires a kind= param")
    for k, v in params.items():
        if not isinstance(v, _ALLOWED):
            raise TypeError(
                f"dp_tag param {k}={v!r} is not a static scalar "
                f"(str/int/float/bool)")
    return x
