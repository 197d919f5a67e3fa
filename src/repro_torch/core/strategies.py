"""Per-example gradient strategies.

The paper's three strategies plus the ghost / book-keeping extensions:

  * ``naive`` — a Python loop of batch-size-1 gradients; the semantics
    oracle.
  * ``multi`` — ``torch.func.vmap(torch.func.grad(...))`` over the
    functional ``apply``: "B model copies sharing parameters" (§2 of the
    paper).
  * ``crb``   — the paper's chain-rule-based method: one standard backward
    (via the tapped layer outputs), then per-layer reconstruction of
    per-example grads from (captured input, output cotangent) — outer
    products for dense layers, the grouped-convolution trick
    (Algorithms 1–2) or this repo's kernel for convs.
  * ``ghost`` — per-example grad *norms* without materialization (Gram
    trick) + a second, weighted backward pass.
  * ``bk``    — "book-keeping": like ghost, but the clipped sum is formed
    by weighted per-layer contractions from the captures already in hand —
    no second backward.

  * ``auto``  — the planned pipeline: a per-layer
    :class:`~repro_torch.core.costmodel.ExecPlan` mixes the above (one
    capture backward, per-layer norms that may stash per-example grads,
    then stashes / contractions / at most one shared weighted backward),
    and under stale clipping fuses norm and contribution in one pass.

Clipping modes (``ClipPolicy``): ``flat`` everywhere; ``per_layer`` and
``stale`` under ``auto`` and ``bk``.

On a model axis (the strategies run under ``launch.sharding.
model_parallel``) every sliced parameter group's per-example norm² is
partial, and is summed over ``model`` exactly once, before any clip
coefficient (:func:`model_summed`, :func:`pe_norms_sq`); a replicated
group's norm is whole on every rank and never summed.  A sliced group's
replicated leaves (a bias added after the sum, sLSTM's gate bias) are
whole on every rank and enter the partial norm² on model rank 0 only
(``kinds.group_sumsq``).  The clipped contributions stay this rank's
slices.

``apply_fn(params, batch, tapper) -> (B,) per-example losses`` is the only
contract a model must satisfy.  Execution counts (forwards / backwards)
are tracked in :data:`repro_torch.core.tapper.STATS`.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from repro_torch.analysis.markers import tag
from repro_torch.core import costmodel, kinds
from repro_torch.core.tapper import STATS, Tapper, capture_backward
from repro_torch.tree import (from_paths, get_subtree, leaf_paths,
                              set_subtree, tree_map)

STRATEGIES = ("naive", "multi", "crb", "ghost", "bk", "auto")
F32 = torch.float32


# ---------------------------------------------------------------------------
# The model axis: partial norms summed once


def model_summed(norms: list, paths) -> list:
    """Per-group (B,) norms² with every sliced group's partial norm²
    summed over the active model group, in one all-reduce of those rows
    stacked; a replicated group's norm passes through untouched (its
    gradient is whole on every rank).  No model group: ``norms``."""
    from repro_torch.launch import sharding
    ms = sharding.active()
    if ms is None:
        return norms
    rows = [i for i, p in enumerate(paths) if ms.sharded_path(tuple(p))]
    if not rows:
        return norms
    summed = sharding.all_reduce(torch.stack([norms[i] for i in rows]),
                                 ms.group).unbind(0)
    out = list(norms)
    for i, t in zip(rows, summed):
        out[i] = t
    return out


def pe_norms_sq(pe):
    """(B,) norms² of materialized per-example grads: on a model axis the
    sliced leaves' share summed over ``model`` once, the replicated
    leaves' counted once."""
    from repro_torch.launch import sharding
    ms = sharding.active()
    if ms is None:
        return kinds._sumsq(pe)
    part, whole = [], []
    for p in leaf_paths(pe):
        g = get_subtree(pe, p)
        sq = g.to(F32).square().sum(dim=tuple(range(1, g.ndim)))
        (part if ms.sharded_path(p) else whole).append(sq)
    out = sum(whole) if whole else 0.0
    if part:
        out = out + sharding.all_reduce(sum(part), ms.group)
    return out


# ---------------------------------------------------------------------------
# naive & multi


def naive_per_example_grads(apply_fn, params, batch):
    """Batch-size-1 loop — sequential, the paper's `naive`."""
    paths = leaf_paths(params)
    B = next(iter(batch.values())).shape[0]
    losses, per_ex = [], []
    for b in range(B):
        ex = {k: v[b:b + 1] for k, v in batch.items()}
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = apply_fn(p, ex, Tapper())[0]
            gs = torch.autograd.grad(loss, [get_subtree(p, q) for q in paths])
        losses.append(loss.detach())
        per_ex.append(gs)
    grads = from_paths(paths, [torch.stack([g[i] for g in per_ex])
                               for i in range(len(paths))])
    return torch.stack(losses), grads


def multi_per_example_grads(apply_fn, params, batch):
    """vmap(grad) — the paper's `multi` (model copies sharing params)."""
    from repro_torch.launch import sharding
    if sharding.active() is not None:
        raise NotImplementedError(
            f"strategy 'multi' on a model axis: the collectives take no "
            f"torch.func.vmap; {sharding.DEFERRED}")
    def loss(p, ex):
        ex1 = {k: v.unsqueeze(0) for k, v in ex.items()}
        out = apply_fn(p, ex1, Tapper())[0]
        return out, out

    p = tree_map(lambda a: a.detach(), params)
    with torch.enable_grad():
        grads, losses = torch.func.vmap(
            torch.func.grad(loss, has_aux=True), in_dims=(None, 0))(p, batch)
    return losses.detach(), grads


# ---------------------------------------------------------------------------
# crb: capture + reconstruct


def _capture(apply_fn, params, batch):
    return capture_backward(apply_fn, params, batch, with_metas=True)


def _accumulate_param_grads(acc: dict, path: tuple, sub: dict):
    """acc[path][key] += sub[key] (creating entries)."""
    slot = acc.setdefault(path, {})
    for k, v in sub.items():
        slot[k] = slot[k] + v if k in slot else v


def _grads_to_tree(acc: dict) -> dict:
    tree: dict = {}
    for path, sub in acc.items():
        for k, v in sub.items():
            tree = set_subtree(tree, path + (k,), v)
    return tree


def check_coverage(params, grads_tree) -> list[str]:
    """Param leaves with no per-example gradient contribution."""
    p_paths = {"/".join(map(str, q)) for q in leaf_paths(params)}
    g_paths = {"/".join(map(str, q)) for q in leaf_paths(grads_tree)}
    return sorted(p_paths - g_paths)


def crb_per_example_grads(apply_fn, params, batch, *, conv_impl: str = "fgc",
                          check: bool = True):
    """The paper's method: 1 backward + per-layer reconstruction."""
    losses, caps, dtaps, metas = _capture(apply_fn, params, batch)
    acc: dict = {}
    for name, meta in metas.items():
        pe = kinds.apply_kind(
            "pe_grad", meta, caps[name], dtaps[name],
            params_sub=get_subtree(params, meta.path), conv_impl=conv_impl)
        _accumulate_param_grads(acc, meta.path, pe)
    grads = _grads_to_tree(acc)
    if check:
        missing = check_coverage(params, grads)
        if missing:
            raise ValueError(f"params without per-example grads: {missing}")
    return losses, grads


# ---------------------------------------------------------------------------
# ghost norms (shared by ghost & bk)


def group_key_of(path: tuple) -> str:
    """The clip-budget key of a parameter group: its "/"-joined path."""
    return "/".join(str(p) for p in path)


def group_norms_from_captures(params, caps, dtaps, metas, *,
                              norm_method: str = "auto",
                              conv_impl: str = "fgc",
                              embed_method: str = "segsum",
                              conv_norm: str = "auto",
                              attn_norm: str = "auto"):
    """Per-parameter-group per-example squared grad norms, grouping taps
    that touch the same parameter (tied embeddings).

    Returns ``(group_keys, norms)`` with ``norms`` of shape (G, B), in
    sorted-path order.  A group with one tap takes that kind's norm; a
    tied embedding + LM head takes both norms plus their cross term; any
    other group takes the generic exact fallback (materialize the summed
    per-example grad, then square)."""
    by_param = defaultdict(list)
    for name, meta in metas.items():
        by_param[meta.path].append(name)
    keys, norms = [], []

    def _tagged(n_sq, path, method="unplanned"):
        return tag(n_sq, kind="group_norm", group=group_key_of(path),
                   method=method, fused=False)

    for path, names in sorted(by_param.items()):
        keys.append(group_key_of(path))
        psub = get_subtree(params, path)
        if len(names) == 1:
            n = names[0]
            norms.append(_tagged(kinds.apply_kind(
                "norm_sq", metas[n], caps[n], dtaps[n], params_sub=psub,
                norm_method=norm_method, conv_impl=conv_impl,
                embed_method=embed_method, conv_norm=conv_norm,
                attn_norm=attn_norm), path))
            continue
        if _is_tied(names, metas):
            kw = {"embed": {"embed_method": embed_method},
                  "dense": {"norm_method": norm_method}}
            norms.append(_tagged(_tied_norm(
                names, metas, caps, dtaps, psub,
                lambda n: kw[metas[n].kind]), path, "tied"))
            continue
        norms.append(_tagged(kinds.group_sumsq(_summed_pe(
            names, metas, caps, dtaps, psub, conv_impl), path), path, "pe"))
    if not norms:
        raise ValueError("no tapped layers")
    return tuple(keys), torch.stack(model_summed(
        norms, [p for p, _ in sorted(by_param.items())]))


def _is_tied(names, metas) -> bool:
    """A tied embedding + LM head: one gather tap and one transposed
    dense tap on the same table."""
    ks = sorted((metas[n].kind, metas[n].w_transposed) for n in names)
    return ks == [("dense", True), ("embed", False)]


def _tied_norm(names, metas, caps, dtaps, psub, kw_of):
    """‖g_embed + g_head‖² = ‖g_embed‖² + ‖g_head‖² + 2⟨g_embed, g_head⟩,
    each term without forming a (V, D) per-example gradient; ``kw_of(n)``
    gives member ``n``'s norm-method keywords."""
    n_e = next(n for n in names if metas[n].kind == "embed")
    n_d = next(n for n in names if metas[n].kind == "dense")
    n_g = sum(kinds.apply_kind("norm_sq", metas[n], caps[n], dtaps[n],
                               params_sub=psub, **kw_of(n))
              for n in (n_e, n_d))
    return n_g + kinds.tied_embed_head_cross(caps[n_e], dtaps[n_e],
                                             caps[n_d], dtaps[n_d])


def _summed_pe(g_members, metas, caps, dtaps, psub, conv_impl):
    """The summed per-example grad of a group's taps (exact cross terms)."""
    pe_sum: dict = {}
    for n in g_members:
        pe = kinds.apply_kind("pe_grad", metas[n], caps[n], dtaps[n],
                              params_sub=psub, conv_impl=conv_impl)
        for k, v in pe.items():
            pe_sum[k] = pe_sum[k] + v if k in pe_sum else v
    return pe_sum


# ---------------------------------------------------------------------------
# clipped gradient sums (the DP-SGD core)


def clip_coefficients(norms_sq, l2_clip, eps: float = 1e-12, *,
                      mode: str = "flat"):
    """(B,) coefficients ``min(1, C / ‖g_b‖)``; ``mode`` records which
    policy produced them ("stale" when fed lagged norms)."""
    norms = torch.sqrt(norms_sq + eps)
    coef = torch.clamp(l2_clip / norms, max=1.0)
    return tag(coef, kind="clip_coef", mode=mode, l2_clip=float(l2_clip))


def per_layer_clip_coefficients(group_norms_sq, budgets, eps: float = 1e-12):
    """(G, B) coefficients: each group clipped against its own budget."""
    norms = torch.sqrt(group_norms_sq + eps)
    b = budgets.to(device=norms.device, dtype=norms.dtype)
    return tag(torch.clamp(b[:, None] / norms, max=1.0), kind="clip_coef",
               mode="per_layer")


def _flat_detail(coef):
    return {"group_keys": (), "group_norms_sq": None, "coef": coef,
            "budgets": None}


def _weighted_sum(pe, coef):
    return tree_map(
        lambda g: torch.einsum("b...,b->...", g.to(F32), coef), pe)


def clipped_grad_sum(apply_fn, params, batch, **kw):
    """Returns (per-example losses, Σ_b clip(g_b), per-example norms²) —
    see :func:`clipped_grad_sum_detailed` for the keyword surface."""
    losses, gsum, norms_sq, _ = clipped_grad_sum_detailed(
        apply_fn, params, batch, **kw)
    return losses, gsum, norms_sq


def clipped_grad_sum_detailed(apply_fn, params, batch, *, l2_clip: float,
                              strategy: str = "ghost",
                              norm_method: str = "auto",
                              conv_impl: str = "fgc", check: bool = False,
                              embed_method: str = "segsum",
                              conv_norm: str | None = None, overrides=None,
                              mem_budget: int | None = None, plan=None,
                              clip_policy=None, budgets=None,
                              prev_norms_sq=None, attn_norm: str = "auto"):
    """Returns (per-example losses, Σ_b clip(g_b), per-example norms²,
    detail).

    ``conv_norm`` (auto | ghost | pe | pallas) picks the conv norm
    realization (``None`` is an alias for ``"auto"``), ``norm_method``
    the dense one, ``embed_method`` (auto | segsum | gram | pe) the
    embedding one, ``attn_norm`` (auto | ghost | pe) an ``"attn"``
    block's under ghost and bk (the planned path takes it from the
    plan), ``conv_impl`` (fgc | pallas) the materializing conv
    gradient.  ``overrides`` pins
    individual layers by tap-name glob and ``mem_budget`` bounds the
    materializing paths (planned strategy only); ``plan`` injects a
    pre-built, possibly deserialized ExecPlan, skipping the cached
    planner lookup.

    ``clip_policy`` (a :class:`~repro_torch.core.clipping.ClipPolicy`;
    None = flat) selects the clipping mode; non-flat modes require the
    planned (``auto``) or book-keeping (``bk``) strategy.  ``budgets``
    injects a resolved (G,) per-layer budget tensor (else the policy's
    static split is resolved against the sorted group keys);
    ``prev_norms_sq`` feeds stale mode's lagged (B,) norms.

    ``detail``: ``group_keys`` (static tuple), ``group_norms_sq`` ((G, B)
    under per_layer, else None), ``coef`` (the applied coefficients —
    (B,) flat/stale, (G, B) per_layer), ``budgets`` ((G,) under
    per_layer, else None).
    """
    mode = clip_policy.mode if clip_policy is not None else "flat"
    if mode != "flat" and strategy not in ("auto", "bk"):
        raise ValueError(
            f"clipping mode {mode!r} requires strategy 'auto' or 'bk', "
            f"got {strategy!r}")
    if mode == "stale" and prev_norms_sq is None:
        raise ValueError(
            "stale clipping needs prev_norms_sq (the engine bootstraps "
            "the first step with flat clipping and threads the state)")
    if strategy == "auto":
        if plan is None:
            plan = costmodel.get_plan(
                apply_fn, params, batch, norm_method=norm_method,
                embed_method=embed_method, conv_norm=conv_norm or "auto",
                mem_budget=mem_budget or costmodel.STREAM_MEM_BUDGET,
                overrides=overrides, clip_mode=mode,
                clip_fused=(clip_policy.fused if clip_policy is not None
                            else True))
        return planned_clipped_sum(apply_fn, params, batch, plan,
                                   l2_clip=l2_clip, conv_impl=conv_impl,
                                   check=check, clip_policy=clip_policy,
                                   budgets=budgets,
                                   prev_norms_sq=prev_norms_sq)
    if strategy in ("naive", "multi", "crb"):
        if strategy == "naive":
            losses, pe = naive_per_example_grads(apply_fn, params, batch)
        elif strategy == "multi":
            losses, pe = multi_per_example_grads(apply_fn, params, batch)
        else:
            losses, pe = crb_per_example_grads(
                apply_fn, params, batch, conv_impl=conv_impl, check=check)
        norms_sq = pe_norms_sq(pe)
        coef = clip_coefficients(norms_sq, l2_clip)
        return losses, _weighted_sum(pe, coef), norms_sq, _flat_detail(coef)
    if strategy not in ("ghost", "bk"):
        raise ValueError(f"unknown strategy {strategy!r}")

    losses, caps, dtaps, metas = _capture(apply_fn, params, batch)
    group_keys, group_ns = group_norms_from_captures(
        params, caps, dtaps, metas, norm_method=norm_method,
        conv_impl=conv_impl, embed_method=embed_method,
        conv_norm=conv_norm or "auto", attn_norm=attn_norm)
    norms_sq = group_ns.sum(dim=0)

    if mode == "per_layer":
        if budgets is None:
            from repro_torch.core.clipping import resolve_budgets
            budgets = resolve_budgets(clip_policy, l2_clip, group_keys,
                                      device=group_ns.device)
        coef = per_layer_clip_coefficients(group_ns, budgets).detach()
        detail = {"group_keys": group_keys, "group_norms_sq": group_ns,
                  "coef": coef, "budgets": budgets}
        gi_of = {k: i for i, k in enumerate(group_keys)}

        def weight_of(meta):
            return coef[gi_of[group_key_of(meta.path)]]
    else:
        coef = (clip_coefficients(prev_norms_sq, l2_clip, mode="stale")
                if mode == "stale"
                else clip_coefficients(norms_sq, l2_clip)).detach()
        detail = _flat_detail(coef)

        def weight_of(meta):
            return coef

    if strategy == "ghost":
        # the weighted backward needs no capture: free them before it
        del caps, dtaps
        paths = leaf_paths(params)
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        STATS.forwards += 1
        STATS.backwards += 1
        with torch.enable_grad():
            losses2 = apply_fn(p, batch, Tapper())
            gs = torch.autograd.grad((losses2 * coef).sum(),
                                     [get_subtree(p, q) for q in paths])
        return losses, from_paths(paths, gs), norms_sq, detail

    acc: dict = {}
    for name, meta in metas.items():
        contrib = kinds.apply_kind(
            "contrib", meta, caps[name], dtaps[name],
            params_sub=get_subtree(params, meta.path),
            weights=weight_of(meta), conv_impl=conv_impl)
        _accumulate_param_grads(acc, meta.path, contrib)
    gsum = _grads_to_tree(acc)
    if check:
        missing = check_coverage(params, gsum)
        if missing:
            raise ValueError(f"bk missing param contribs: {missing}")
    return losses, gsum, norms_sq, detail


# ---------------------------------------------------------------------------
# The planned (mixed per-layer) pipeline: strategy="auto"


def _norm_kwargs(lp):
    if lp.kind in ("dense", "seg_dense"):
        return {"norm_method": lp.norm_method}
    if lp.kind == "embed":
        return {"embed_method": lp.norm_method}
    if lp.kind == "conv":
        return {"conv_norm": lp.norm_method}
    if lp.kind == "attn":
        return {"attn_norm": lp.norm_method}
    return {}


def _group_norm_tag(n_sq, g, method: str, fused: bool = False):
    """Mark one plan group's realized (B,) squared norms: which group,
    which realized method, and whether a fused single pass produced
    them."""
    return tag(n_sq, kind="group_norm", group=group_key_of(g.path),
               method=method, fused=fused)


def _planned_group_norm(g, plan, metas, caps, dtaps, params, conv_impl,
                        stash):
    """Phase-1 norm of one plan group: (B,) squared norms, stashing any
    per-example grads the chosen realization materialized (keyed by the
    tap name for a single-tap group, by the path for ``group_pe``)."""
    psub = get_subtree(params, g.path)
    if g.norm_mode == "single":
        n = g.members[0]
        lp, meta = plan.layers[n], metas[n]
        if lp.stash:
            pe = kinds.apply_kind("pe_grad", meta, caps[n], dtaps[n],
                                  params_sub=psub, conv_impl=conv_impl)
            stash[n] = pe
            return _group_norm_tag(kinds.group_sumsq(pe, g.path), g,
                                   "stash")
        return _group_norm_tag(kinds.apply_kind(
            "norm_sq", meta, caps[n], dtaps[n], params_sub=psub,
            conv_impl=conv_impl, **_norm_kwargs(lp)), g, lp.norm_method)
    if g.norm_mode == "tied":
        return _group_norm_tag(_tied_norm(
            g.members, metas, caps, dtaps, psub,
            lambda n: _norm_kwargs(plan.layers[n])), g, "tied")
    # group_pe: exact generic fallback, materialized once
    pe_sum = _summed_pe(g.members, metas, caps, dtaps, psub, conv_impl)
    if g.sum_method == "stash":
        stash[g.path] = pe_sum
    return _group_norm_tag(kinds.group_sumsq(pe_sum, g.path), g, "pe")


def _weighted_stash_sum(pe, w):
    return tree_map(
        lambda leaf: torch.einsum("b...,b->...", leaf.to(F32), w), pe)


def _stale_group_norm_contrib(g, plan, metas, caps, dtaps, params, coef,
                              conv_impl, fused_ok, acc):
    """Stale-coefficient single pass over one plan group: the norm (for
    the *next* step's coefficients) and the weighted contribution come
    from the same captures, with the fused ``gram_norm_fused``
    realization where the plan selected it."""
    psub = get_subtree(params, g.path)
    if g.norm_mode == "tied":
        n_g = _planned_group_norm(g, plan, metas, caps, dtaps, params,
                                  conv_impl, {})
        for n in g.members:
            _accumulate_param_grads(acc, g.path, kinds.apply_kind(
                "contrib", metas[n], caps[n], dtaps[n], params_sub=psub,
                weights=coef, conv_impl=conv_impl))
        return n_g
    if g.norm_mode == "group_pe":
        # the materialized summed per-example grad serves both
        pe_sum = _summed_pe(g.members, metas, caps, dtaps, psub, conv_impl)
        _accumulate_param_grads(acc, g.path,
                                _weighted_stash_sum(pe_sum, coef))
        return _group_norm_tag(kinds.group_sumsq(pe_sum, g.path), g, "pe")
    n = g.members[0]
    lp, meta = plan.layers[n], metas[n]
    if lp.fused and fused_ok:
        n_g, contrib = kinds.apply_norm_contrib(
            meta, caps[n], dtaps[n], weights=coef, params_sub=psub,
            fused=True, conv_impl=conv_impl, **_norm_kwargs(lp))
        _accumulate_param_grads(acc, g.path, contrib)
        return _group_norm_tag(n_g, g, lp.norm_method, fused=True)
    if lp.stash:
        pe = kinds.apply_kind("pe_grad", meta, caps[n], dtaps[n],
                              params_sub=psub, conv_impl=conv_impl)
        _accumulate_param_grads(acc, g.path, _weighted_stash_sum(pe, coef))
        return _group_norm_tag(kinds.group_sumsq(pe, g.path), g, "stash")
    n_g = kinds.apply_kind(
        "norm_sq", meta, caps[n], dtaps[n], params_sub=psub,
        conv_impl=conv_impl, **_norm_kwargs(lp))
    _accumulate_param_grads(acc, g.path, kinds.apply_kind(
        "contrib", meta, caps[n], dtaps[n], params_sub=psub,
        weights=coef, conv_impl=conv_impl))
    return _group_norm_tag(n_g, g, lp.norm_method)


def planned_clipped_sum(apply_fn, params, batch, plan, *, l2_clip: float,
                        conv_impl: str = "fgc", check: bool = False,
                        clip_policy=None, budgets=None, prev_norms_sq=None):
    """Execute a :class:`~repro_torch.core.costmodel.ExecPlan`: one capture
    backward, per-layer planned norms (stashing any per-example grads the
    norm phase materialized), then the clipped sum from stashes /
    book-keeping contractions / at most one shared weighted backward.

    Returns (losses, gsum, total norms², detail) — see
    :func:`clipped_grad_sum_detailed` for the detail contract.

    ``flat`` applies one (B,) coefficient vector everywhere; ``per_layer``
    gives each parameter group its own coefficients from its own norms and
    budget; ``stale`` knows every coefficient *entering* the pass and
    collapses norm + sum into one sweep over the captures, fused
    (``gram_norm_fused``) where the plan marked it.  The plan must have
    been built for the executing mode, and its layers must be the model's
    (the live metas from the capture pass): a mismatch fails loudly."""
    mode = clip_policy.mode if clip_policy is not None else "flat"
    fused_ok = clip_policy.fused if clip_policy is not None else True
    costmodel.check_plan_matches(plan, clip_mode=mode)
    losses, caps, dtaps, metas = _capture(apply_fn, params, batch)
    if set(metas) != set(plan.layers):
        missing = sorted(set(plan.layers) - set(metas))
        extra = sorted(set(metas) - set(plan.layers))
        raise ValueError(
            f"ExecPlan {plan.fingerprint or '<unfingerprinted>'} does not "
            f"match this model: plan-only layers {missing}, model-only "
            f"layers {extra} — re-plan (stale or mismatched serialized "
            f"plan?)")
    group_keys = tuple(group_key_of(g.path) for g in plan.groups)
    if mode != "flat":
        bad = [group_keys[i] for i, g in enumerate(plan.groups)
               if g.sum_method == "backward"]
        if bad:
            raise ValueError(
                f"plan uses the shared weighted backward for {bad} — "
                f"incompatible with clipping mode {mode!r} (re-plan)")

    if mode == "stale":
        if prev_norms_sq is None:
            raise ValueError("stale clipping needs prev_norms_sq")
        coef = clip_coefficients(prev_norms_sq, l2_clip,
                                 mode="stale").detach()
        acc: dict = {}
        norms = [_stale_group_norm_contrib(
            g, plan, metas, caps, dtaps, params, coef, conv_impl, fused_ok,
            acc) for g in plan.groups]
        total = 0.0
        for n_g in model_summed(norms, [g.path for g in plan.groups]):
            total = total + n_g
        gsum = _grads_to_tree(acc)
        if check:
            missing = check_coverage(params, gsum)
            if missing:
                raise ValueError(f"auto missing param contribs: {missing}")
        return losses, gsum, total, _flat_detail(coef)

    stash: dict = {}
    group_ns = torch.stack(model_summed([
        _planned_group_norm(g, plan, metas, caps, dtaps, params, conv_impl,
                            stash)
        for g in plan.groups], [g.path for g in plan.groups]))   # (G, B)
    total = group_ns.sum(dim=0)

    if mode == "per_layer":
        if budgets is None:
            from repro_torch.core.clipping import resolve_budgets
            budgets = resolve_budgets(clip_policy, l2_clip, group_keys,
                                      device=group_ns.device)
        coef = per_layer_clip_coefficients(group_ns, budgets).detach()
        detail = {"group_keys": group_keys, "group_norms_sq": group_ns,
                  "coef": coef, "budgets": budgets}
        weights = list(coef)
    else:
        flat_coef = clip_coefficients(total, l2_clip).detach()
        detail = _flat_detail(flat_coef)
        weights = [flat_coef] * len(plan.groups)

    wgrads = None
    if plan.needs_backward:
        paths = leaf_paths(params)
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        STATS.forwards += 1
        STATS.backwards += 1
        with torch.enable_grad():
            losses2 = apply_fn(p, batch, Tapper())
            gs = torch.autograd.grad((losses2 * detail["coef"]).sum(),
                                     [get_subtree(p, q) for q in paths])
        wgrads = from_paths(paths, gs)

    acc = {}
    for gi, g in enumerate(plan.groups):
        w = weights[gi]
        if g.sum_method == "backward":
            _accumulate_param_grads(acc, g.path, get_subtree(wgrads, g.path))
            continue
        if g.sum_method == "stash":
            pe = stash[g.members[0] if g.norm_mode == "single" else g.path]
            _accumulate_param_grads(acc, g.path, _weighted_stash_sum(pe, w))
            continue
        psub = get_subtree(params, g.path)
        for n in g.members:
            _accumulate_param_grads(acc, g.path, kinds.apply_kind(
                "contrib", metas[n], caps[n], dtaps[n], params_sub=psub,
                weights=w, conv_impl=conv_impl))

    gsum = _grads_to_tree(acc)
    if check:
        missing = check_coverage(params, gsum)
        if missing:
            raise ValueError(f"auto missing param contribs: {missing}")
    return losses, gsum, total, detail
