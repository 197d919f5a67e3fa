"""Shared model-building blocks: the parameter builder with logical
sharding axes, norms (tapped affines), RoPE, and per-example losses.

The JAX package's activation-sharding hints (``shard_act``) are the
layout moves of :mod:`repro_torch.launch.sharding` here, made where a
model axis slices a layer (the identity everywhere else); the losses
take vocabulary-sharded logits (``n_vocab``: the whole width).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.tapper import Tapper
from repro_torch.launch import sharding as sh

F32 = torch.float32

# ---------------------------------------------------------------------------
# Parameter builder: every param leaf is a Pm(value, logical_axes) pair until
# `split_tree` separates them.


@dataclasses.dataclass
class Pm:
    value: object
    axes: tuple


def mk(gen: torch.Generator, shape, axes, *, scale=None, dist="normal",
       dtype=torch.float32, device="cpu"):
    """One parameter leaf.  Normal draws come from ``gen`` on its own
    device (a CPU generator gives the same weights on every device; a
    card's draws on the card, and other numbers), in float32, scaled,
    then cast to ``dtype`` on ``device``."""
    assert len(shape) == len(axes), (shape, axes)
    if dist == "zeros":
        return Pm(torch.zeros(shape, dtype=dtype, device=device), axes)
    if dist == "ones":
        return Pm(torch.ones(shape, dtype=dtype, device=device), axes)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0] if len(shape) else 1.0)
    v = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return Pm(v.to(device=device, dtype=dtype), axes)


def split_tree(tree):
    """-> (params, axes) from a Pm tree."""
    def split(t, i):
        if isinstance(t, Pm):
            return (t.value, t.axes)[i]
        return {k: split(v, i) for k, v in t.items()}
    return split(tree, 0), split(tree, 1)


def stack_layers(gen: torch.Generator, n: int, layer_init):
    """Initialize ``n`` layers (in order, from one generator) and stack
    each leaf with a leading 'layer' axis."""
    trees = [layer_init(gen) for _ in range(n)]

    def stack(*ps):
        if isinstance(ps[0], Pm):
            return Pm(torch.stack([p.value for p in ps]),
                      ("layer",) + ps[0].axes)
        return {k: stack(*(p[k] for p in ps)) for k in ps[0]}
    return stack(*trees)


# ---------------------------------------------------------------------------
# Norms (affine parts are tapped so their per-example grads are covered)


def rmsnorm(tp: Tapper, name: str, p, x, eps: float = 1e-6, *,
            width: int | None = None):
    """``width``: the whole normalized width, when ``x`` may arrive as
    this rank's slice of it (sliced with its scale ``g``): the f32 sum
    of squares is summed over ``model`` before the ``rsqrt``, so each
    rank normalizes its slice by the one-device statistic."""
    xf = x.to(F32)
    if width is not None and sh.split(x.shape[-1], width):
        ss = sh.sum_over_model((xf * xf).sum(-1, keepdim=True))
        nx = xf * torch.rsqrt(ss / width + eps)
    else:
        nx = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    nx = nx.to(x.dtype)
    if p is None:
        return nx
    return tp.scale(name, nx, p["g"])


def layernorm(tp: Tapper, name: str, p, x, eps: float = 1e-5):
    xf = x.to(F32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    nx = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if p is None:  # non-parametric (OLMo)
        return nx
    return tp.scale(name, nx, p["g"], p.get("b"))


def norm_init(gen: torch.Generator, d: int, kind: str, dtype=F32,
              device="cpu"):
    if kind == "layernorm_np":
        return None
    if kind == "layernorm":
        return {"g": mk(gen, (d,), ("embed",), dist="ones", dtype=dtype,
                        device=device),
                "b": mk(gen, (d,), ("embed",), dist="zeros", dtype=dtype,
                        device=device)}
    return {"g": mk(gen, (d,), ("embed",), dist="ones", dtype=dtype,
                    device=device)}


def apply_norm(tp, name, p, x, kind: str):
    if kind in ("layernorm", "layernorm_np"):
        return layernorm(tp, name, p, x)
    return rmsnorm(tp, name, p, x)


# ---------------------------------------------------------------------------
# Rotary embeddings


def rope_angles(positions, dim: int, theta: float):
    """positions (..., T) -> cos/sin (..., T, dim/2), in float32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=F32,
                                          device=positions.device) / dim))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, T, H, hd); cos/sin (B, T, hd/2) or (T, hd/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# Losses


def per_example_xent(logits, labels, mask=None,
                     vocab_valid: int | None = None,
                     n_vocab: int | None = None):
    """Per-example mean cross entropy, in float32.  logits (B, T, V);
    labels (B, T).  ``vocab_valid`` masks padded vocabulary rows out of
    the softmax (their logits become -1e30).  ``n_vocab``: the whole
    width, when the logits may arrive as this rank's vocabulary slice
    (``launch.sharding.parallel_xent``)."""
    lg = logits.to(F32)
    V = lg.shape[-1]
    if n_vocab is not None and sh.split(V, n_vocab):
        nll = sh.parallel_xent(lg, labels, vocab_valid=vocab_valid)
    else:
        if vocab_valid is not None and vocab_valid < V:
            pad = torch.arange(V, device=lg.device) >= vocab_valid
            lg = lg.masked_fill(pad, -1e30)
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is None:
        return nll.mean(dim=-1)
    m = mask.to(F32)
    return (nll * m).sum(dim=-1) / torch.clamp(m.sum(dim=-1), min=1.0)


def per_example_xent_cls(logits, labels, n_classes: int | None = None):
    """Per-example cross entropy of a classifier, in float32:
    ``-log_softmax(logits)[label]`` (``n_classes``: the whole width, when
    the logits may arrive as this rank's slice of the classes)."""
    if n_classes is not None and sh.split(logits.shape[-1], n_classes):
        return sh.parallel_xent(logits.to(torch.float32), labels)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]

