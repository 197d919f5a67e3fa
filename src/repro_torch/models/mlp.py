"""Feed-forward blocks: SwiGLU and GeLU MLPs (tapped)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tapper import Tapper
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


def mlp_apply(tp: Tapper, name: str, p, x, kind="swiglu"):
    up = tp.dense(f"{name}/w_up", x, p["w_up"]["w"], p["w_up"].get("b"))
    if kind == "swiglu":
        gate = tp.dense(f"{name}/w_gate", x, p["w_gate"]["w"])
        h = F.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return tp.dense(f"{name}/w_down", h, p["w_down"]["w"],
                    p["w_down"].get("b"))
