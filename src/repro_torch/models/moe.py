"""Mixture-of-experts with tapped expert matmuls (the JAX package's
``repro.models.moe``).

Three dispatch implementations:

  * ``einsum`` — dense dispatch/combine one-hot einsums with
    *per-example* capacity (examples never compete for slots); its
    one-hot (B, T, k, E, C) operand makes it the small-shape baseline.
  * ``gather`` — dispatch with global capacity: each (token, pick) entry
    takes the next free slot of its expert, in token order (a cumsum
    over the entries' one-hot expert ids); entries past the capacity
    are dropped.
  * ``sort`` — the same slots from one stable argsort and a
    searchsorted, with no (N·k, E) one-hot.

``gather`` and ``sort`` move rows with gathers only: every kept entry
owns one slot, so dispatch (slot <- entry) and combine (entry <- slot)
are gathers through the two inverse index maps, and each one's backward
is the gather through the other map (:class:`_SlotRows`).  No float
scatter-add runs forward or backward, so the result does not depend on
the order of atomics; each token sums its k picks in pick order.

Expert FFN matmuls go through ``Tapper.dense_segmented``, so per-example
gradient norms for expert weights are exact (slot -> example ids, int32
as in the JAX package, travel with the captures).  The router is a plain tapped dense; its top-k order
is defined (a stable descending sort: ties go to the lower expert index,
as ``jax.lax.top_k``'s do), and the load-balance auxiliary loss is
computed *per example* (over that example's own tokens).

On a data rank (``launch.sharding.data_parallel``) the ``gather`` and
``sort`` dispatches keep the single-device semantics of the global
batch: the capacity comes from the global token count, and each entry's
position is offset by the earlier data ranks' entries for its expert
(their per-expert counts, all-reduced over the data group), so an entry
is kept where one device would keep it.

On a model axis that slices the experts (the ``"expert"`` rule, where
the JAX package's ``shard_act`` marks the dispatched slots) each rank
holds ``E/M`` experts, the router's matching columns and, under the
``"mlp"`` rule, its slice of the shared expert.  The layer's input is
copied to ``model`` once; the router's logits are gathered, so every
rank of a model slot routes alike (probabilities, top-k, positions, the
load-balance loss); each rank dispatches only the entries routed to its
own experts; the combine weights pass a :func:`~repro_torch.launch.
sharding.copy_to_model` (their cotangent on a rank covers its experts
only); and the routed and shared partial outputs leave through one
:func:`~repro_torch.launch.sharding.reduce_from_model`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tapper import Tapper
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm
from repro_torch.models.mlp import mlp_apply, mlp_init

F32 = torch.float32


def moe_init(gen: torch.Generator, d_model, d_ff, n_experts, *, n_shared=0,
             dtype=F32, device="cpu"):
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": {"w": cm.mk(gen, (d_model, n_experts), ("embed", "expert"),
                              **kw)},
        "w_gate": {"w": cm.mk(gen, (n_experts, d_model, d_ff),
                              ("expert", "embed", "mlp"), **kw)},
        "w_up": {"w": cm.mk(gen, (n_experts, d_model, d_ff),
                            ("expert", "embed", "mlp"), **kw)},
        "w_down": {"w": cm.mk(gen, (n_experts, d_ff, d_model),
                              ("expert", "mlp", "embed"), **kw)},
    }
    if n_shared:
        p["shared"] = mlp_init(gen, d_model, d_ff * n_shared, "swiglu", **kw)
    return p


def _one_hot(ids, n, dtype):
    """One-hot over the last axis; ids outside [0, n) give zero rows (as
    ``jax.nn.one_hot``)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _router(tp: Tapper, name, p, x, n_experts, topk, cut=False):
    """Probabilities, normalized top-k weights and ids, and the
    per-example load-balance loss.  ``cut``: the router's columns are
    this rank's experts; its logits are gathered over ``model`` and the
    weights copied to it (their cotangent, partial on a rank, is summed
    before the softmax sees it)."""
    logits = tp.dense(f"{name}/router", x, p["router"]["w"])
    if cut:
        logits = sh.gather_from_model(logits, -1)
    probs = torch.softmax(logits.to(F32), dim=-1)
    # jax.lax.top_k's order: descending, ties to the lower index
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :topk], top_e[..., :topk]          # (B,T,k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    if cut:
        top_w = sh.copy_to_model(top_w)
    # per-example load-balance loss (Switch-style), over each example's
    # own tokens
    imp = probs.mean(dim=1)                                      # (B,E)
    frac = _one_hot(top_e, n_experts, F32).mean(dim=(1, 2))
    lb = n_experts * (imp * frac).sum(dim=-1)                    # (B,)
    return probs, top_w, top_e, lb


def _experts(tp: Tapper, name, p, xe, seg, B):
    """The tapped SwiGLU experts over dispatched slots xe (E, S, D)."""
    h_g = tp.dense_segmented(f"{name}/w_gate", xe, p["w_gate"]["w"], seg,
                             n_examples=B)
    h_u = tp.dense_segmented(f"{name}/w_up", xe, p["w_up"]["w"], seg,
                             n_examples=B)
    h = F.silu(h_g) * h_u
    return tp.dense_segmented(f"{name}/w_down", h, p["w_down"]["w"], seg,
                              n_examples=B)


def _out(tp, name, p, x, x_in, y, *, cut, shared_ff):
    """The routed output ``y`` plus the shared expert's (``shared_ff`` its
    whole hidden width).  On a model axis (``cut``) ``y`` is this rank's
    partial output and ``x_in`` the input copied to ``model``: the
    sliced shared expert adds its partial output, and both leave
    through one sum over ``model``."""
    if "shared" in p:
        y = y + mlp_apply(tp, f"{name}/shared", p["shared"],
                          x_in if cut else x, "swiglu", d_ff=shared_ff,
                          partial=cut)
    return sh.reduce_from_model(y) if cut else y


def moe_apply_einsum(tp: Tapper, name: str, p, x, *, n_experts, topk,
                     capacity_factor=2.0, d_ff=None, n_shared=0):
    """Per-example-capacity dense dispatch.  Slot positions are counted
    in integers (the reference counts them in x's dtype: the same in
    f32, and exact here past 256 in bf16).  ``d_ff`` / ``n_shared``: the
    experts' hidden width and the shared experts' count, which tell a
    sliced shared expert on a model axis."""
    B, T, D = x.shape
    E = n_experts
    cap = max(1, int(capacity_factor * T * topk / E))
    cut = sh.split(p["w_gate"]["w"].shape[0], E)
    x_in = sh.copy_to_model(x) if cut else x
    _, top_w, top_e, lb = _router(tp, name, p, x_in, E, topk, cut)
    e0, e1 = sh.active().run(E) if cut else (0, E)

    onehot_i = _one_hot(top_e, E, torch.int64)                    # (B,T,k,E)
    # position of token t among tokens of *its own example* routed to e
    pos = torch.cumsum(onehot_i.reshape(B, T * topk, E), dim=1) - 1
    pos = pos.reshape(B, T, topk, E)[..., e0:e1]
    onehot = onehot_i[..., e0:e1].to(x.dtype)
    keep = (pos < cap).to(x.dtype) * onehot
    posc = _one_hot(pos, cap, x.dtype)                            # (B,T,k,E,C)
    disp = torch.einsum("btke,btkec->btec", keep, posc)
    comb = torch.einsum("btk,btke,btkec->btec", top_w.to(x.dtype), keep,
                        posc)

    El = e1 - e0
    xe = torch.einsum("btd,btec->ebcd", x_in, disp).reshape(El, B * cap, D)
    seg = torch.arange(B, dtype=torch.int32, device=x.device)[
        None, :, None].expand(El, B, cap).reshape(El, B * cap)
    ye = _experts(tp, name, p, xe, seg, B).reshape(El, B, cap, D)
    y = torch.einsum("ebcd,btec->btd", ye, comb)
    return _out(tp, name, p, x, x_in, y, cut=cut,
                shared_ff=d_ff * n_shared if d_ff else None), lb


class _SlotRows(torch.autograd.Function):
    """``out[i] = src[idx[i]]``, with ``idx[i] == len(src)`` reading a
    zero row.  ``inv`` is the inverse map (``inv[j]`` the one i with
    ``idx[i] == j``, else the zero row of the other side), so the
    backward is the gather ``grad_src[j] = grad_out[inv[j]]``: exact, as
    every source row is read at most once."""

    generate_vmap_rule = True

    @staticmethod
    def forward(src, idx, inv):
        pad = torch.zeros((1,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        return torch.cat([src, pad])[idx]

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, inv = inputs
        ctx.save_for_backward(idx, inv)

    @staticmethod
    def backward(ctx, grad):
        idx, inv = ctx.saved_tensors
        return _SlotRows.apply(grad, inv, idx), None, None


def _slots_gather(e_flat, E):
    """Each entry's position among the entries routed to its expert, in
    entry order: a cumsum over the one-hot expert ids, held (E, N·k) so
    that the scan runs along the contiguous axis (a scan down the N·k
    rows of an (N·k, E) one-hot has only E columns to spread over the
    card)."""
    onehot = (torch.arange(E, device=e_flat.device)[:, None]
              == e_flat[None, :]).to(torch.int32)
    cum = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    return cum.gather(0, e_flat[None, :])[0].long() - 1


def _slots_sort(e_flat, E):
    """The same positions from one stable argsort and a searchsorted."""
    n = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    start = torch.searchsorted(e_sorted, torch.arange(E, device=e_flat.device))
    pos_sorted = torch.arange(n, device=e_flat.device) - start[e_sorted]
    # undo the order: entry order[i] is at position pos_sorted[i]
    return torch.empty_like(pos_sorted).index_put((order,), pos_sorted)


def _expert_counts(e_flat, E):
    """(E,) int64: the entries routed to each expert."""
    return (torch.arange(E, device=e_flat.device)[:, None]
            == e_flat[None, :]).sum(dim=1)


def _global_positions(e_flat, E, slots_fn, N, topk, capacity_factor):
    """(local positions, global positions, capacity) of the entries
    ``e_flat`` of this rank's ``N`` tokens.  On a data rank the capacity
    is the global batch's and each position is offset by the entries of
    the earlier data ranks for its expert: a ``(D, E)`` count, each rank
    its row, summed over the data group."""
    pos = slots_fn(e_flat, E)
    ds = sh.active_data()
    if ds is None:
        return pos, pos, max(1, int(capacity_factor * N * topk / E))
    cap = max(1, int(capacity_factor * (N * ds.size) * topk / E))
    mine = _expert_counts(e_flat, E)[None]
    rows = sh.all_reduce(torch.cat([
        mine.new_zeros((ds.rank, E)), mine,
        mine.new_zeros((ds.size - ds.rank - 1, E))]), ds.group,
        axis="data")
    offset = rows[:ds.rank].sum(dim=0)
    return pos, pos + offset[e_flat], cap


def _moe_global(tp: Tapper, name: str, p, x, slots_fn, *, n_experts, topk,
                capacity_factor, d_ff=None, n_shared=0):
    """Global-capacity dispatch with the positions ``slots_fn`` gives."""
    B, T, D = x.shape
    E = n_experts
    N = B * T
    nk = N * topk
    cut = sh.split(p["w_gate"]["w"].shape[0], E)
    x_in = sh.copy_to_model(x) if cut else x
    _, top_w, top_e, lb = _router(tp, name, p, x_in, E, topk, cut)
    e0, e1 = sh.active().run(E) if cut else (0, E)
    El = e1 - e0

    e_flat = top_e.reshape(nk)
    pos, gpos, cap = _global_positions(e_flat, E, slots_fn, N, topk,
                                       capacity_factor)
    keep = gpos < cap
    if cut:
        keep = keep & (e_flat >= e0) & (e_flat < e1)
    # each kept entry's slot, the dropped ones' (and, on a model axis,
    # the other ranks' experts') the zero row past the end
    slot = torch.where(keep, (e_flat - e0) * cap + pos, El * cap)
    # each slot's entry, an empty slot's the zero row past the entries
    entry = torch.full((El * cap + 1,), nk, dtype=slot.dtype,
                       device=x.device).index_put(
        (slot,), torch.arange(nk, device=x.device))[:El * cap]
    ex_of = (torch.arange(nk, device=x.device) // topk // T).to(torch.int32)
    seg = torch.cat([ex_of, ex_of.new_zeros(1)])[entry].reshape(El, cap)

    xrep = x_in.reshape(N, 1, D).expand(N, topk, D).reshape(nk, D)
    xe = _SlotRows.apply(xrep, entry, slot).reshape(El, cap, D)
    ye = _experts(tp, name, p, xe, seg, B)
    w_flat = torch.where(keep, top_w.reshape(nk), 0.0).to(x.dtype)
    yt = _SlotRows.apply(ye.reshape(El * cap, D), slot, entry) \
        * w_flat[:, None]
    y = yt.reshape(N, topk, D).sum(dim=1).reshape(B, T, D)
    return _out(tp, name, p, x, x_in, y, cut=cut,
                shared_ff=d_ff * n_shared if d_ff else None), lb


def moe_apply_gather(tp: Tapper, name: str, p, x, *, n_experts, topk,
                     capacity_factor=2.0, d_ff=None, n_shared=0):
    """Dispatch with global capacity, positions by one-hot cumsum."""
    return _moe_global(tp, name, p, x, _slots_gather, n_experts=n_experts,
                       topk=topk, capacity_factor=capacity_factor,
                       d_ff=d_ff, n_shared=n_shared)


def moe_apply_sort(tp: Tapper, name: str, p, x, *, n_experts, topk,
                   capacity_factor=2.0, d_ff=None, n_shared=0):
    """Dispatch with global capacity, positions by a stable argsort."""
    return _moe_global(tp, name, p, x, _slots_sort, n_experts=n_experts,
                       topk=topk, capacity_factor=capacity_factor,
                       d_ff=d_ff, n_shared=n_shared)


def moe_apply(tp, name, p, x, *, impl="einsum", **kw):
    if impl == "gather":
        return moe_apply_gather(tp, name, p, x, **kw)
    if impl == "sort":
        return moe_apply_sort(tp, name, p, x, **kw)
    return moe_apply_einsum(tp, name, p, x, **kw)
