"""DP-SGD gradient computation: clip, accumulate, noise (flat clipping).

The preferred entry point is :class:`repro_torch.core.engine.PrivacyEngine`;
:func:`dp_gradient` is the functional core it drives.  The per-layer and
stale clipping modes, ``microbatches="auto"`` under the planner and
injected plans come with the planner slice (ROADMAP.md item 9).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Mapping

import torch

from repro_torch.analysis.markers import tag
from repro_torch.core import costmodel, strategies
from repro_torch.tree import (get_subtree, leaf_paths, set_subtree,
                              tree_map)

CLIP_MODES = ("flat", "per_layer", "stale")
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ClipPolicy:
    """How per-example clip coefficients are derived and applied.

    Modes (the JAX package's; only ``flat`` runs in this slice):
      * ``flat``      — one coefficient per example from the *total* grad
        norm: ``w_b = min(1, C / ‖g_b‖)``.  Exact.
      * ``per_layer`` — per-layer budgets ``C_l`` with ``Σ_l C_l² = C²``.
      * ``stale``     — flat coefficients from the previous step's norms.

    ``budgets`` / ``fused`` / ``quantile`` / ``ema`` configure the non-flat
    modes and are validated as in the JAX package; set away from their
    defaults they raise at use (:func:`check_served`) until the planner
    slice reads them.
    """

    mode: str = "flat"
    budgets: Any = "uniform"
    fused: bool = True
    quantile: float = 0.5
    ema: float = 0.9

    def __post_init__(self):
        if self.mode not in CLIP_MODES:
            raise ValueError(f"unknown clipping mode {self.mode!r}; "
                             f"choose from {CLIP_MODES}")
        if isinstance(self.budgets, str):
            if self.budgets not in ("uniform", "auto"):
                raise ValueError(
                    f"budgets must be 'uniform', 'auto', or a "
                    f"{{glob: weight}} mapping, got {self.budgets!r}")
        else:
            object.__setattr__(self, "budgets", tuple(
                (str(p), float(w)) for p, w in
                (self.budgets.items() if isinstance(self.budgets, Mapping)
                 else self.budgets)))


def as_clip_policy(clipping) -> ClipPolicy:
    if clipping is None:
        return ClipPolicy()
    if isinstance(clipping, ClipPolicy):
        return clipping
    if isinstance(clipping, str):
        return ClipPolicy(mode=clipping)
    raise TypeError(f"clipping must be a ClipPolicy or mode string, "
                    f"got {clipping!r}")


@dataclasses.dataclass(frozen=True)
class NormCfg:
    """Per-kind norm-realization knobs (the JAX package's names).

    dense:     auto | gram | stream | rank1 | pallas
    embed:     auto | segsum | gram | pe        (LM slice)
    conv:      auto | ghost | pe | pallas       (norm realization)
    conv_impl: fgc | bgc | pallas               (materializing conv grad)
    mem_budget: bytes of per-example-grad scratch the planner tolerates.

    ``"pallas"`` keeps the JAX package's spelling so configs, overrides
    and plans stay one-to-one; in the port it means this repo's own CUDA
    kernel (``gram_norm`` for dense/conv norms, ``pe_conv_grad_2d`` for
    conv_impl), and on CPU tensors its plain PyTorch version.

    ``embed`` and ``mem_budget`` are read only by the LM kinds and the
    planner; set away from their defaults they raise at use
    (:func:`check_served`).
    """

    dense: str = "auto"
    embed: str = "auto"
    conv: str = "auto"
    conv_impl: str = "fgc"
    mem_budget: int = costmodel.STREAM_MEM_BUDGET


# Legacy-kwarg sentinel: distinguishes "caller did not pass conv_norm" from
# the historical conv_norm=None, which is itself deprecated (now = "auto").
_UNSET = object()


@dataclasses.dataclass(frozen=True, init=False)
class DPConfig:
    """Structured DP-SGD configuration (the JAX package's, validation and
    legacy-kwarg shim included).

    Norm realizations live in a nested :class:`NormCfg`; ``overrides``
    ({tap-name glob: method}) are validated here and raise at use until
    the planner reads them (:func:`check_served`).  ``microbatches``
    is a positive int (``"auto"`` resolves to 1 under the fixed
    strategies, as in the JAX package).
    """

    l2_clip: float = 1.0
    noise_multiplier: float = 0.0
    strategy: str = "auto"           # naive | multi | crb | ghost | bk | auto
    norm: NormCfg = NormCfg()
    overrides: tuple = ()            # ((tap-name glob, method), ...)
    microbatches: Any = 1            # int or "auto"
    delta: float = 1e-5
    clipping: ClipPolicy = ClipPolicy()

    def __init__(self, l2_clip: float = 1.0, noise_multiplier: float = 0.0,
                 strategy: str = "auto", norm: NormCfg | None = None,
                 overrides=(), microbatches: Any = 1, delta: float = 1e-5,
                 clipping: ClipPolicy | str | None = None,
                 *, norm_method: str | None = None,
                 embed_norm: str | None = None, conv_impl: str | None = None,
                 conv_norm: Any = _UNSET):
        norm = norm or NormCfg()
        clipping = as_clip_policy(clipping)
        if clipping.mode != "flat" and strategy not in ("auto", "bk"):
            raise ValueError(
                f"clipping mode {clipping.mode!r} requires strategy 'auto' "
                f"or 'bk' (got {strategy!r}): the ghost weighted backward "
                f"and the materializing strategies only realize one flat "
                f"coefficient per example")
        legacy = {"norm_method": norm_method, "embed_norm": embed_norm,
                  "conv_impl": conv_impl}
        if any(v is not None for v in legacy.values()) \
                or conv_norm is not _UNSET:
            warnings.warn(
                "DPConfig(norm_method=/embed_norm=/conv_impl=/conv_norm=) "
                "is deprecated; use DPConfig(norm=NormCfg(...)) and "
                "overrides={...} (conv_norm=None now means 'auto')",
                DeprecationWarning, stacklevel=2)
            norm = dataclasses.replace(
                norm,
                dense=norm_method or norm.dense,
                embed=embed_norm or norm.embed,
                conv_impl=conv_impl or norm.conv_impl,
                conv=(norm.conv if conv_norm is _UNSET
                      else (conv_norm or "auto")))
        if not (microbatches == "auto"
                or (isinstance(microbatches, int) and microbatches >= 1)):
            raise ValueError(
                f"microbatches must be a positive int or 'auto', "
                f"got {microbatches!r}")
        object.__setattr__(self, "l2_clip", float(l2_clip))
        object.__setattr__(self, "noise_multiplier", float(noise_multiplier))
        object.__setattr__(self, "strategy", strategy)
        object.__setattr__(self, "norm", norm)
        object.__setattr__(self, "overrides",
                           costmodel.normalize_overrides(overrides))
        object.__setattr__(self, "microbatches", microbatches)
        object.__setattr__(self, "delta", float(delta))
        object.__setattr__(self, "clipping", clipping)

    # Read-only views under the old knob names.
    @property
    def norm_method(self) -> str:
        return self.norm.dense

    @property
    def embed_norm(self) -> str:
        return self.norm.embed

    @property
    def conv_impl(self) -> str:
        return self.norm.conv_impl

    @property
    def conv_norm(self) -> str:
        return self.norm.conv


def check_served(cfg: DPConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run:
    ``strategy="auto"``, non-flat clipping, and the knobs that only the
    planner slice reads (ROADMAP.md item 9) when set away from their
    defaults, so that no setting is silently ignored."""
    if cfg.strategy == "auto" or cfg.clipping.mode != "flat":
        raise strategies._auto_unsupported()
    norm0, clip0 = NormCfg(), ClipPolicy()
    unserved = [name for name, changed in [
        ("overrides", bool(cfg.overrides)),
        ("NormCfg.embed", cfg.norm.embed != norm0.embed),
        ("NormCfg.mem_budget", cfg.norm.mem_budget != norm0.mem_budget),
        *((f"ClipPolicy.{f}", getattr(cfg.clipping, f) != getattr(clip0, f))
          for f in ("budgets", "fused", "quantile", "ema"))] if changed]
    if unserved:
        raise NotImplementedError(
            f"{', '.join(unserved)} set away from the default: only the "
            f"planner slice (ROADMAP.md item 9) reads these; leave them at "
            f"their defaults under the fixed strategies")


def add_noise(grad_sum, generator: torch.Generator, noise_multiplier: float,
              l2_clip: float):
    """Add N(0, (σC)²) noise per coordinate.  The noise is drawn in float32
    from ``generator`` (on the grads' device), leaf by leaf in sorted
    leaf-path order, and summed in float32; only the result is cast back
    to the grad dtype."""
    if noise_multiplier == 0.0:
        return grad_sum
    sigma = noise_multiplier * l2_clip
    out = grad_sum
    for path in leaf_paths(grad_sum):
        g = get_subtree(grad_sum, path)
        noise = torch.randn(g.shape, generator=generator, dtype=F32,
                            device=g.device)
        noise = tag(sigma * noise, kind="noise", sigma=float(sigma),
                    noise_multiplier=float(noise_multiplier),
                    l2_clip=float(l2_clip))
        out = set_subtree(out, path, (g.to(F32) + noise).to(g.dtype))
    return out


def resolve_microbatches(cfg: DPConfig) -> int:
    """``cfg.microbatches`` as a count: ``"auto"`` is 1 under the fixed
    strategies (they have no plan to consult), as in the JAX package."""
    m = cfg.microbatches
    if m != "auto":
        return int(m)
    if cfg.strategy == "auto":
        raise strategies._auto_unsupported()
    return 1


def dp_gradient(apply_fn: Callable, params, batch, *, cfg: DPConfig,
                key: torch.Generator | None = None, denom: int | None = None,
                plan=None, clip_state: dict | None = None):
    """Full DP-SGD gradient:  (Σ_b clip(g_b) + σC·ξ) / denom.

    ``batch`` leaves have leading batch B; with ``cfg.microbatches`` > 1
    the batch is split and the clipped sums accumulated in a Python loop
    (valid because clipping is per-example and accumulation a plain sum).
    ``key`` is the ``torch.Generator`` the noise is drawn from.

    Returns (mean loss, gradient tree in float32, aux dict with
    ``per_example_norms`` and ``clip_fraction``)."""
    if plan is not None or clip_state:
        raise strategies._auto_unsupported()
    check_served(cfg)
    B = next(iter(batch.values())).shape[0]
    denom = denom or B
    m = resolve_microbatches(cfg)
    if B % m:
        raise ValueError(f"batch {B} not divisible by microbatches {m}")
    mb = B // m
    gsum, losses, norms = None, [], []
    for i in range(m):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l_i, g_i, n_i = strategies.clipped_grad_sum(
            apply_fn, params, part, l2_clip=cfg.l2_clip,
            strategy=cfg.strategy, norm_method=cfg.norm.dense,
            conv_impl=cfg.norm.conv_impl, conv_norm=cfg.norm.conv)
        g_i = tree_map(lambda g: g.to(F32), g_i)
        gsum = g_i if gsum is None else tree_map(torch.add, gsum, g_i)
        losses.append(l_i)
        norms.append(n_i)
    losses, norms_sq = torch.cat(losses), torch.cat(norms)
    if key is not None and cfg.noise_multiplier > 0:
        gsum = add_noise(gsum, key, cfg.noise_multiplier, cfg.l2_clip)
    grad = tree_map(lambda g: g / denom, gsum)
    C = cfg.l2_clip
    aux = {
        "per_example_norms": torch.sqrt(norms_sq + 1e-12),
        "clip_fraction": (torch.sqrt(norms_sq) > C).to(F32).mean(),
    }
    return losses.mean(), grad, aux

