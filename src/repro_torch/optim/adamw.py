"""Optimizers (pure functions over nested dicts of tensors).

The JAX package's update math, not ``torch.optim``'s: moments are float32
regardless of parameter dtype, ``eps`` sits outside the square root, the
bias correction comes from the step count held in the state, and the
update is computed in float32 and cast back.  Functions return new
tensors and leave their inputs alone, unless the caller gives the state
up (``inplace=True``): then the moments are updated in place, with the
same roundings in the same order (bitwise the same values), so that a
step holds one copy of them and not two.  Every update is elementwise,
so on a mesh the moments and the in-place update run on each rank's
slices of the params (a model axis, FSDP's data slices) unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map

F32 = torch.float32


def _zeros_like_f32(p):
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _step0(params):
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _pick(tree, i):
    """Element ``i`` of every tuple leaf."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def adamw_init(params):
    return {"m": tree_map(_zeros_like_f32, params),
            "v": tree_map(_zeros_like_f32, params),
            "step": _step0(params)}


def adamw_update(grads, state, params, *, lr=1e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.0, inplace=False):
    step = state["step"] + 1
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=t.device), t)

    def upd(g, m, v, p):
        g = g.to(F32)
        if inplace:
            m = m.mul_(b1).add_((1 - b1) * g)
            v = v.mul_(b2).add_((1 - b2) * g * g)
        else:
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(F32)
        newp = (p.to(F32) - lr * u).to(p.dtype)
        return newp, m, v

    out = tree_map(upd, grads, state["m"], state["v"], params)
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                           "step": step}


def sgdm_init(params):
    return {"mom": tree_map(_zeros_like_f32, params), "step": _step0(params)}


def sgdm_update(grads, state, params, *, lr=0.1, momentum=0.9,
                weight_decay=0.0, inplace=False):
    def upd(g, mo, p):
        g = g.to(F32)
        if weight_decay:
            g = g + weight_decay * p.to(F32)
        mo = mo.mul_(momentum).add_(g) if inplace else momentum * mo + g
        return (p.to(F32) - lr * mo).to(p.dtype), mo

    out = tree_map(upd, grads, state["mom"], params)
    return _pick(out, 0), {"mom": _pick(out, 1), "step": state["step"] + 1}
