"""Shared model-building blocks: the parameter builder with logical
sharding axes, and the per-example cross entropy the CNNs use.

The JAX package's norms, RoPE and LM losses come with the LM slice
(ROADMAP.md item 11).
"""
from __future__ import annotations

import dataclasses
import math

import torch

# ---------------------------------------------------------------------------
# Parameter builder: every param leaf is a Pm(value, logical_axes) pair until
# `split_tree` separates them.


@dataclasses.dataclass
class Pm:
    value: object
    axes: tuple


def mk(gen: torch.Generator, shape, axes, *, scale=None, dist="normal",
       dtype=torch.float32, device="cpu"):
    """One parameter leaf.  Normal draws come from ``gen`` (a CPU
    generator, so a seed gives the same weights on every device), in
    float32, scaled, then cast to ``dtype`` on ``device``."""
    assert len(shape) == len(axes), (shape, axes)
    if dist == "zeros":
        return Pm(torch.zeros(shape, dtype=dtype, device=device), axes)
    if dist == "ones":
        return Pm(torch.ones(shape, dtype=dtype, device=device), axes)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0] if len(shape) else 1.0)
    v = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return Pm(v.to(device=device, dtype=dtype), axes)


def split_tree(tree):
    """-> (params, axes) from a Pm tree."""
    def split(t, i):
        if isinstance(t, Pm):
            return (t.value, t.axes)[i]
        return {k: split(v, i) for k, v in t.items()}
    return split(tree, 0), split(tree, 1)


def per_example_xent_cls(logits, labels):
    """Per-example cross entropy of a classifier, in float32:
    ``-log_softmax(logits)[label]``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]

