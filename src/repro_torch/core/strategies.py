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

The planned ``auto`` pipeline and the non-flat clipping modes come with
the planner slice (ROADMAP.md item 9).

``apply_fn(params, batch, tapper) -> (B,) per-example losses`` is the only
contract a model must satisfy.  Execution counts (forwards / backwards)
are tracked in :data:`repro_torch.core.tapper.STATS`.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from repro_torch.analysis.markers import tag
from repro_torch.core import kinds
from repro_torch.core.tapper import STATS, Tapper, capture_backward
from repro_torch.tree import (from_paths, get_subtree, leaf_paths,
                              set_subtree, tree_map)

STRATEGIES = ("naive", "multi", "crb", "ghost", "bk", "auto")
F32 = torch.float32


def _auto_unsupported():
    return NotImplementedError(
        "strategy='auto' (the planner), plans and non-flat clipping modes "
        "come with the planner slice (ROADMAP.md item 9); use one of "
        "naive / multi / crb / ghost / bk")


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
                              conv_norm: str = "auto"):
    """Per-parameter-group per-example squared grad norms, grouping taps
    that touch the same parameter.

    Returns ``(group_keys, norms)`` with ``norms`` of shape (G, B), in
    sorted-path order.  A group with one tap takes that kind's norm; a
    group with several takes the generic exact fallback (materialize the
    summed per-example grad, then square)."""
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
                conv_norm=conv_norm), path))
            continue
        pe_sum: dict = {}
        for n in names:
            pe = kinds.apply_kind("pe_grad", metas[n], caps[n], dtaps[n],
                                  params_sub=psub, conv_impl=conv_impl)
            for k, v in pe.items():
                pe_sum[k] = pe_sum[k] + v if k in pe_sum else v
        norms.append(_tagged(kinds._sumsq(pe_sum), path, "pe"))
    if not norms:
        raise ValueError("no tapped layers")
    return tuple(keys), torch.stack(norms)


# ---------------------------------------------------------------------------
# clipped gradient sums (the DP-SGD core)


def clip_coefficients(norms_sq, l2_clip, eps: float = 1e-12, *,
                      mode: str = "flat"):
    norms = torch.sqrt(norms_sq + eps)
    coef = torch.clamp(l2_clip / norms, max=1.0)
    return tag(coef, kind="clip_coef", mode=mode, l2_clip=float(l2_clip))


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
                              conv_norm: str | None = None, plan=None,
                              clip_policy=None):
    """Returns (per-example losses, Σ_b clip(g_b), per-example norms²,
    detail) under flat clipping.

    ``conv_norm`` (auto | ghost | pe | pallas) picks the conv norm
    realization (``None`` is an alias for ``"auto"``), ``norm_method``
    the dense one, ``conv_impl`` (fgc | pallas) the materializing conv
    gradient.  ``detail`` holds the applied coefficients (``coef``)."""
    mode = clip_policy.mode if clip_policy is not None else "flat"
    if strategy == "auto" or plan is not None or mode != "flat":
        raise _auto_unsupported()
    if strategy in ("naive", "multi", "crb"):
        if strategy == "naive":
            losses, pe = naive_per_example_grads(apply_fn, params, batch)
        elif strategy == "multi":
            losses, pe = multi_per_example_grads(apply_fn, params, batch)
        else:
            losses, pe = crb_per_example_grads(
                apply_fn, params, batch, conv_impl=conv_impl, check=check)
        norms_sq = kinds._sumsq(pe)
        coef = clip_coefficients(norms_sq, l2_clip)
        return losses, _weighted_sum(pe, coef), norms_sq, _flat_detail(coef)
    if strategy not in ("ghost", "bk"):
        raise ValueError(f"unknown strategy {strategy!r}")

    losses, caps, dtaps, metas = _capture(apply_fn, params, batch)
    _, group_ns = group_norms_from_captures(
        params, caps, dtaps, metas, norm_method=norm_method,
        conv_impl=conv_impl, conv_norm=conv_norm or "auto")
    norms_sq = group_ns.sum(dim=0)
    coef = clip_coefficients(norms_sq, l2_clip).detach()
    detail = _flat_detail(coef)

    if strategy == "ghost":
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
            params_sub=get_subtree(params, meta.path), weights=coef,
            conv_impl=conv_impl)
        _accumulate_param_grads(acc, meta.path, contrib)
    gsum = _grads_to_tree(acc)
    if check:
        missing = check_coverage(params, gsum)
        if missing:
            raise ValueError(f"bk missing param contribs: {missing}")
    return losses, gsum, norms_sq, detail

