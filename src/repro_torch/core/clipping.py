"""DP-SGD gradient computation: clip, accumulate, noise.

The preferred entry point is :class:`repro_torch.core.engine.PrivacyEngine`;
:func:`dp_gradient` is the functional core it drives.  Clipping is flat,
per-layer or stale (:class:`ClipPolicy`); ``microbatches="auto"`` splits
the batch from the plan's memory estimates.

Data parallelism (``shard=`` a :class:`DataShard`): each rank clips its
contiguous slice of the global batch, the clipped sums are all-reduced
once a leaf (:func:`sync_grads`), the noise is added *after* that sum
from the one generator every rank holds (:func:`release_sum`), and the
divisor, the mean loss and the statistics are the global batch's.
Clipping is per example, so a rank's coefficients need only its own
examples' norms: the step equals the single-device step up to the order
of the sum.  The strategies run under :func:`repro_torch.launch.sharding.
data_parallel`, so a layer whose forward couples the global batch's
examples (the MoE dispatch's global capacity) keeps one device's
semantics on a data rank.

A model axis too (``shard=`` a :class:`MeshShard`, whose ``model`` names
the model group and the param specs): the strategies run under
:func:`repro_torch.launch.sharding.model_parallel`, so the models make
their layout moves and the strategies sum each sliced group's partial
norm² over ``model`` once, before any coefficient.  The clipped
contributions of sliced leaves stay local (summed over the data group
only), and the noise is the single-device noise: every rank draws each
leaf's full shape from the one generator and keeps its slice
(:func:`add_noise`).

FSDP (a shard whose ``specs`` name the data axes: ``PrivacyEngine(
fsdp=True)``): the engine gathers each data-sliced param over the data
group before the step and hands this function the rank's model slices,
so the strategies see the tensors of the step without FSDP.  A
data-sliced leaf's clipped sum is then summed over the data group and
the rank keeps its slice (``sharding.reduce_scatter_to_data``: still
one all-reduce a leaf, in sorted leaf-path order), its noise is the
rank's slice of the one full draw in every sliced dimension, data and
model alike, and the divisor applies to the slice.
"""
from __future__ import annotations

import dataclasses
import warnings
from fnmatch import fnmatchcase
from typing import Any, Callable, Mapping

import numpy as np
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

    Modes (the JAX package's):
      * ``flat``      — one coefficient per example from the *total* grad
        norm: ``w_b = min(1, C / ‖g_b‖)``.  Exact.
      * ``per_layer`` — each parameter group ``l`` is clipped against its
        own budget ``C_l`` with ``Σ_l C_l² = C²``, so the clipped sum's
        sensitivity stays ``C``.  ``budgets``: ``"uniform"``
        (``C/√G``), a ``{glob: weight}`` mapping over the "/"-joined
        group keys, or ``"auto"`` (``C_l ∝`` an EMA, factor ``ema``, of
        each group's ``quantile`` norm, tracked by the engine).
      * ``stale``     — flat coefficients from the *previous* step's norms
        (the first step bootstraps with flat clipping), so norm and
        contribution come from one pass over the captures; ``fused``
        lets the plan route Gram-realized layers through
        ``gram_norm_fused``.
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


def resolve_budgets(policy: ClipPolicy, l2_clip: float, group_keys,
                    observed=None, *, device="cpu"):
    """Per-group clip budgets ``C_l`` with ``Σ_l C_l² = C²`` (exactly, up
    to float rounding), as an f32 tensor on ``device``.

    ``observed`` (per-group positive norm statistics, e.g. the engine's
    tracked quantiles) drives the ``"auto"`` split ``C_l ∝ q_l``; without
    it ``"auto"`` falls back to uniform.  Mapping budgets are glob-matched
    against the ``"/"``-joined group keys, first match wins.
    """
    G = len(group_keys)
    if G == 0:
        raise ValueError("no parameter groups to budget")
    if isinstance(policy.budgets, tuple):
        w = []
        for key in group_keys:
            for pat, wt in policy.budgets:
                if fnmatchcase(key, pat):
                    w.append(wt)
                    break
            else:
                w.append(1.0)
        w = np.asarray(w, np.float64)
    elif policy.budgets == "auto" and observed is not None:
        w = np.asarray(observed, np.float64)
    else:
        w = np.ones((G,), np.float64)
    w = np.maximum(w, 1e-12)
    b = l2_clip * w / np.sqrt(np.sum(w * w))
    return torch.tensor(b, dtype=F32, device=device)


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
    embed:     auto | segsum | gram | pe
    conv:      auto | ghost | pe | pallas       (norm realization)
    conv_impl: fgc | bgc | pallas               (materializing conv grad)
    mem_budget: bytes of per-example-grad scratch the planner tolerates.

    ``"pallas"`` keeps the JAX package's spelling so configs, overrides
    and plans stay one-to-one; in the port it means this repo's own CUDA
    kernel (``gram_norm`` for dense/conv norms, ``pe_conv_grad_2d`` for
    conv_impl), and on CPU tensors its plain PyTorch version.

    ``mem_budget`` bounds the planner's materializing paths and drives
    ``microbatches="auto"``.  ``embed`` is read by the embedding kinds.
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

    Norm realizations live in a nested :class:`NormCfg`, and individual
    layers are pinned with ``overrides`` ({tap-name glob: method}, first
    match wins; read by the planner).  ``microbatches`` may be ``"auto"``:
    the count is derived from the ExecPlan's per-layer peak-memory
    estimates against ``norm.mem_budget`` (1 under the fixed strategies,
    which have no plan).
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

    def planner_opts(self) -> dict:
        """Keyword arguments for :func:`.costmodel.get_plan`."""
        return dict(norm_method=self.norm.dense, embed_method=self.norm.embed,
                    conv_norm=self.norm.conv,
                    mem_budget=self.norm.mem_budget,
                    overrides=self.overrides,
                    clip_mode=self.clipping.mode,
                    clip_fused=self.clipping.fused)


@dataclasses.dataclass(frozen=True)
class DataShard:
    """One rank's place in a data-parallel group: the process group the
    clipped sums and the statistics are reduced over, this rank's index
    in it, and its size.  ``specs``: under FSDP the param spec tree,
    whose data-axis dimensions (``sharding.data_dims``) this rank holds
    a slice of; ``None`` without FSDP."""

    group: Any
    rank: int
    size: int
    specs: Any = None

    def local(self, B: int) -> slice:
        """This rank's contiguous slice of a global batch of ``B``."""
        if B % self.size:
            raise ValueError(
                f"batch {B} is not divisible by the data-parallel degree "
                f"{self.size}")
        n = B // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


@dataclasses.dataclass(frozen=True)
class MeshShard(DataShard):
    """One rank's place in a ``data x model`` mesh: the data group (its
    fields are :class:`DataShard`'s; size 1 and no group on a mesh with
    no data degree) and ``model``, the rank's
    :class:`~repro_torch.launch.sharding.ModelShard` (its group, rank,
    size and the param specs)."""

    model: Any = None


def model_of(shard) -> Any:
    """The :class:`~repro_torch.launch.sharding.ModelShard` of a shard
    (``None``: no model axis)."""
    return getattr(shard, "model", None)


def _psum(t, shard: DataShard):
    """Sum all-reduce over the shard's data group (a functional
    collective, so a traced step records it as one node; a data degree
    of 1 has nothing to sum)."""
    if shard.size == 1:
        return t
    from repro_torch.launch.sharding import all_reduce
    return all_reduce(t, shard.group, axis="data")


def fsdp_of(shard) -> DataShard | None:
    """The shard when its ``specs`` slice the params over its data group
    (FSDP, a group of more than one rank), else ``None``."""
    if shard is None or shard.specs is None or shard.size == 1:
        return None
    return shard


def _data_dims(shard, path) -> tuple:
    """The dimensions of leaf ``path`` sliced over the data group (FSDP;
    ``()`` without it)."""
    if fsdp_of(shard) is None:
        return ()
    from repro_torch.launch.sharding import data_dims
    return data_dims(get_subtree(shard.specs, path))


def sync_grads(gsum, shard: DataShard):
    """The clipped sum summed over the data group: one all-reduce a leaf,
    in sorted leaf-path order (the same on every rank and every run).
    Under FSDP a data-sliced leaf keeps this rank's slice of its sum."""
    from repro_torch.launch.sharding import reduce_scatter_to_data
    out = gsum
    for path in leaf_paths(gsum):
        g = get_subtree(gsum, path)
        dims = _data_dims(shard, path)
        out = set_subtree(out, path, reduce_scatter_to_data(g, dims[0], shard)
                          if dims else _psum(g, shard))
    return out


def gather_examples(t, shard: DataShard):
    """``(..., B/d)`` per-example values of this rank -> ``(..., B)`` of
    the whole group, in rank order: a sum all-reduce of the zero-padded
    slices (exact: every other entry is a zero)."""
    n = t.shape[-1]
    lead = tuple(t.shape[:-1])
    return _psum(torch.cat(
        [t.new_zeros(lead + (n * shard.rank,)), t,
         t.new_zeros(lead + (n * (shard.size - shard.rank - 1),))],
        dim=-1), shard)


def release_sum(gsum, key, cfg, shard: DataShard | None = None):
    """The clipped sum as released before the divisor: summed over the
    data group first, then noised once (:func:`add_noise`).  Every rank
    draws from a generator of the same seed, so every rank adds the same
    noise to the same sum."""
    if shard is not None:
        gsum = sync_grads(gsum, shard)
    if key is not None and cfg.noise_multiplier > 0:
        ms = model_of(shard)
        kw = {} if ms is None else {"model": ms}
        if fsdp_of(shard) is not None:
            kw["data"] = shard
        gsum = add_noise(gsum, key, cfg.noise_multiplier, cfg.l2_clip, **kw)
    return gsum


def add_noise(grad_sum, generator: torch.Generator, noise_multiplier: float,
              l2_clip: float, *, model=None, data=None):
    """Add N(0, (σC)²) noise per coordinate.  The noise is drawn in float32
    from ``generator`` (on the grads' device), leaf by leaf in sorted
    leaf-path order, and summed in float32; only the result is cast back
    to the grad dtype.  A float32 leaf takes its noise in place: the sum
    is the caller's to give up, and a step then holds one copy of it,
    not two.  On a model axis (``model``: the rank's ``ModelShard``) a
    sliced leaf's noise is drawn at the leaf's full shape and this rank
    keeps its slice, so the model ranks add the slices of the one draw a
    single device adds.  Under FSDP (``data``: the rank's
    :class:`DataShard`, its ``specs`` naming the data axes) the same
    holds for the data-sliced dimensions: drawn whole, this rank's data
    slice kept."""
    if noise_multiplier == 0.0:
        return grad_sum
    from repro_torch.launch import sharding
    sigma = noise_multiplier * l2_clip
    out = grad_sum
    for path in leaf_paths(grad_sum):
        g = get_subtree(grad_sum, path)
        cuts = [] if model is None else [
            (d, model)
            for d in sharding.model_dims(get_subtree(model.specs, path))]
        cuts += [(d, data) for d in _data_dims(data, path)]
        full = list(g.shape)
        for d, sh in cuts:
            full[d] *= sh.size
        noise = torch.randn(full, generator=generator, dtype=F32,
                            device=g.device)
        noise = tag(noise.mul_(sigma), kind="noise", sigma=float(sigma),
                    noise_multiplier=float(noise_multiplier),
                    l2_clip=float(l2_clip))
        for d, sh in cuts:
            noise = sharding._own(noise, d, sh)
        out = set_subtree(out, path, g.add_(noise) if g.dtype == F32
                          else (g.to(F32) + noise).to(g.dtype))
    return out


def resolve_microbatches(apply_fn, params, batch, cfg: DPConfig,
                         plan=None) -> int:
    """Resolve ``cfg.microbatches`` to a concrete count.  ``"auto"``
    derives it from the full-batch ExecPlan's memory estimates (planned
    strategy only; the fixed strategies have no plan and run unsplit)."""
    m = cfg.microbatches
    if m != "auto":
        return int(m)
    if cfg.strategy != "auto":
        return 1
    if plan is None:
        plan = costmodel.get_plan(apply_fn, params, batch,
                                  **cfg.planner_opts())
    B = next(iter(batch.values())).shape[0]
    return costmodel.auto_microbatches(plan, B, cfg.norm.mem_budget)


def dp_gradient(apply_fn: Callable, params, batch, *, cfg: DPConfig,
                key: torch.Generator | None = None, denom: int | None = None,
                plan=None, clip_state: dict | None = None,
                shard: DataShard | None = None, flat_plan=None):
    """Full DP-SGD gradient:  (Σ_b clip(g_b) + σC·ξ) / denom.

    ``batch`` leaves have leading B; with ``cfg.microbatches`` > 1 the
    batch is split and the clipped sums accumulated in a Python loop
    (valid because clipping is per-example and accumulation a plain sum);
    ``"auto"`` derives the split from the ExecPlan's memory estimates.
    ``plan`` injects a pre-built (possibly deserialized) ExecPlan; it must
    match the per-microbatch shapes *and* the clipping mode.  ``key`` is
    the ``torch.Generator`` the noise is drawn from.

    ``clip_state`` threads the cross-step state of the non-flat modes
    (the engine owns this loop):
      * ``{"prev_norms_sq": (B,)}`` — ``stale``: the norms the lagged
        coefficients come from.  Absent → bootstrap: this call clips with
        exact flat coefficients (and a flat plan) and returns the norms
        that seed the next step.
      * ``{"budgets": (G,)}`` — ``per_layer`` with ``budgets="auto"``:
        the engine-tracked split.  Absent → the policy's static split
        (uniform / mapping) is resolved against the plan's groups.

    ``shard`` runs this rank's slice of the global ``batch`` and reduces
    over its group (module docstring); ``prev_norms_sq`` is then the
    rank's slice, and ``plan`` the mesh-keyed one.  A :class:`MeshShard`
    with a model group runs the strategies under it: ``params`` are
    then the rank's slices, and ``flat_plan`` (the mesh-keyed flat plan)
    is what the stale bootstrap executes, where a plan of the slices'
    shapes would price another layer.

    Returns (mean loss, gradient tree in float32, aux dict with
    ``per_example_norms`` and ``clip_fraction``).  ``per_layer`` adds
    ``per_layer_norms`` (G, B), ``per_layer_clip_fraction`` (G,) and
    ``clip_budgets``; ``stale`` adds ``clip_fraction_lagged`` (what the
    applied coefficients clipped; ``clip_fraction`` describes the current
    norms, i.e. the next step's coefficients) and ``clip_state``."""
    B = next(iter(batch.values())).shape[0]
    denom = denom or B
    if shard is not None:
        sl = shard.local(B)
        batch = {k: v[sl] for k, v in batch.items()}
        B = B // shard.size
    policy = cfg.clipping
    clip_state = dict(clip_state or {})
    prev_ns = clip_state.get("prev_norms_sq")
    budgets = clip_state.get("budgets")
    bootstrap = policy.mode == "stale" and prev_ns is None
    if bootstrap:
        # No lagged norms yet: clip exactly (flat), under a flat plan —
        # the stale plan's fused realizations need coefficients entering
        # the pass.  The returned clip_state seeds the steady state.
        policy = ClipPolicy()
        cfg = dataclasses.replace(cfg, clipping=policy)
        plan = flat_plan
    m = cfg.microbatches
    if m == "auto":
        m = resolve_microbatches(apply_fn, params, batch, cfg, plan=plan)
        if m > 1:
            plan = None   # a caller-supplied plan was for the full batch
    if B % m:
        raise ValueError(f"batch {B} not divisible by microbatches {m}")
    mb = B // m
    gsum, losses, norms, group_ns, budgets_used = None, [], [], [], None
    from repro_torch.launch.sharding import data_parallel, model_parallel
    with model_parallel(model_of(shard)), data_parallel(shard):
        for i in range(m):
            sl = slice(i * mb, (i + 1) * mb)
            part = {k: v[sl] for k, v in batch.items()}
            l_i, g_i, n_i, detail = strategies.clipped_grad_sum_detailed(
                apply_fn, params, part, l2_clip=cfg.l2_clip,
                strategy=cfg.strategy, norm_method=cfg.norm.dense,
                conv_impl=cfg.norm.conv_impl, embed_method=cfg.norm.embed,
                conv_norm=cfg.norm.conv,
                overrides=cfg.overrides, mem_budget=cfg.norm.mem_budget,
                plan=plan, clip_policy=policy, budgets=budgets,
                prev_norms_sq=None if prev_ns is None else prev_ns[sl])
            g_i = tree_map(lambda g: g.to(F32), g_i)
            gsum = g_i if gsum is None else tree_map(torch.add, gsum, g_i)
            losses.append(l_i)
            norms.append(n_i)
            if detail["group_norms_sq"] is not None:
                group_ns.append(detail["group_norms_sq"])
                budgets_used = detail["budgets"]
    losses, norms_sq = torch.cat(losses), torch.cat(norms)
    gsum = release_sum(gsum, key, cfg, shard)
    # the sum is this step's own: divided in place, as it is noised
    grad = tree_map(lambda g: g.div_(denom), gsum)

    def whole(t):
        return t if shard is None else gather_examples(t, shard)

    all_ns = whole(norms_sq)
    loss = (losses.mean() if shard is None
            else _psum(losses.sum(), shard) / all_ns.shape[-1])
    C = cfg.l2_clip
    aux = {
        "per_example_norms": torch.sqrt(all_ns + 1e-12),
        "clip_fraction": (torch.sqrt(all_ns) > C).to(F32).mean(),
    }
    if policy.mode == "per_layer":
        # The flat-style scalar above would be wrong (it compares the
        # *total* norm against C while clipping happened per layer):
        # report per-layer fractions against the per-layer budgets, and
        # make the scalar their mean over (layer, example) pairs.
        group_ns = whole(torch.cat(group_ns, dim=1))             # (G, B)
        pl_norms = torch.sqrt(group_ns + 1e-12)
        clipped = (pl_norms > budgets_used[:, None]).to(F32)
        aux["per_layer_norms"] = pl_norms
        aux["per_layer_clip_fraction"] = clipped.mean(dim=1)
        aux["clip_fraction"] = clipped.mean()
        aux["clip_budgets"] = budgets_used
    elif policy.mode == "stale" or bootstrap:
        # ``clip_fraction`` describes the *current* norms — the
        # coefficients the next step applies.  What this step applied is
        # lagged; label it instead of reporting it wrongly.
        applied_ns = all_ns if bootstrap else whole(prev_ns)
        aux["clip_fraction_lagged"] = \
            (torch.sqrt(applied_ns) > C).to(F32).mean()
        aux["clip_state"] = {"prev_norms_sq": norms_sq}   # this rank's
    return loss, grad, aux
