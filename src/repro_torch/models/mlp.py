"""Feed-forward blocks: SwiGLU and GeLU MLPs (tapped).

On a model axis that slices ``d_ff`` (``"mlp"``), ``w_up`` / ``w_gate``
are column-sharded (the full input, copied in) and ``w_down``
row-sharded (its partial output summed over ``model``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tapper import Tapper
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm


def mlp_init(gen: torch.Generator, d_model, d_ff, kind="swiglu", *,
             bias=False, dtype=torch.float32, device="cpu"):
    kw = dict(dtype=dtype, device=device)
    p = {}
    if kind == "swiglu":
        p["w_gate"] = {"w": cm.mk(gen, (d_model, d_ff), ("embed", "mlp"),
                                  **kw)}
    p["w_up"] = {"w": cm.mk(gen, (d_model, d_ff), ("embed", "mlp"), **kw)}
    p["w_down"] = {"w": cm.mk(gen, (d_ff, d_model), ("mlp", "embed"), **kw)}
    if bias:
        p["w_up"]["b"] = cm.mk(gen, (d_ff,), ("mlp",), dist="zeros", **kw)
        p["w_down"]["b"] = cm.mk(gen, (d_model,), ("embed",), dist="zeros",
                                 **kw)
    return p


def mlp_apply(tp: Tapper, name: str, p, x, kind="swiglu", *,
              d_ff: int | None = None, partial: bool = False):
    """``d_ff``: the whole hidden width, when ``p`` may arrive as this
    rank's slices of it.  ``partial``: on such slices, ``x`` is already
    copied to ``model`` and the partial output is returned unsummed, for
    a caller that sums it with partial terms of its own (a MoE layer's
    shared expert)."""
    cut = d_ff is not None and sh.split(p["w_up"]["w"].shape[-1], d_ff)
    if partial and not cut:
        raise NotImplementedError(
            f"{name}: a replicated MLP beside sliced partial outputs is "
            f"{sh.DEFERRED}")
    if cut:
        if p["w_down"].get("b") is not None:
            raise NotImplementedError(
                f"{name}: a row-sharded w_down with a replicated bias is "
                f"{sh.DEFERRED}")
        if not partial:
            x = sh.copy_to_model(x)
    up = tp.dense(f"{name}/w_up", x, p["w_up"]["w"], p["w_up"].get("b"))
    if kind == "swiglu":
        gate = tp.dense(f"{name}/w_gate", x, p["w_gate"]["w"])
        h = F.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    y = tp.dense(f"{name}/w_down", h, p["w_down"]["w"],
                 p["w_down"].get("b"))
    return sh.reduce_from_model(y) if cut and not partial else y
