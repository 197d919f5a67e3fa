"""Per-layer-kind gradient algebra (dense, segmented dense, conv, embed,
scale, attention-block and local-VJP kinds).

Given a layer's captured input ``x_b`` and output cotangent ``δy_b`` (from
:mod:`repro_torch.core.tapper`), each *kind* knows three operations:

  * ``pe_grad``  — materialize per-example gradients (B, *param)  [crb]
  * ``norm_sq``  — per-example squared grad norms (B,) without
                   materialization where structure allows        [ghost]
  * ``contrib``  — weighted sum Σ_b w_b g_b at parameter shape    [bk]

and, when the weights are known entering the pass (stale-coefficient
clipping), ``apply_norm_contrib`` forms the norm and the contribution in
one pass (``gram_norm_fused`` for dense and conv layers).

For a dense layer with a sequence axis the ghost norm uses the Gram
identity  ``‖g_b‖² = Σ_{t,t'} (x_t·x_{t'}) (δy_t·δy_{t'})``  which costs
``T²(Din+Dout)`` instead of materializing ``T·Din·Dout``.  Conv layers
reach the same identity over im2col patches.  An embedding gather's norm
sums its cotangent rows per token id (``segsum``); a tied embedding and
LM head add their cross term (:func:`tied_embed_head_cross`).

Scanned layers (captures with leading stacked-layer axes) are taken one
layer at a time, as the JAX package's ``lax.map`` does, so the scratch
of a kind's realization is one layer's worth; shared scanned dense and
scale layers fold their applications into the sequence axis instead.

All reductions accumulate in float32 regardless of capture dtype; on the
card, products of two bf16 captures are bf16 GEMMs with f32 output
(:func:`_ee2`), as the JAX package's ``preferred_element_type`` is.

The method string ``"pallas"`` keeps the JAX package's spelling so that
``NormCfg`` and configs stay one-to-one; here it means this repo's own
CUDA kernel (:mod:`repro_torch.kernels.ops`).  An attention block
tapped as one ``"attn"`` layer (``dp_attn``) is realized by a layer-local
recompute of the block (:func:`_attn_parts`).  A segmented dense layer
(MoE expert slots, ``Tapper.dense_segmented``) carries each slot's
example id in its captures; its kinds loop over the expert groups, so
their scratch is one group's worth.  A ``local_vjp`` layer (the
parameters inside an SSM recurrence) re-runs its layer's VJP one example
at a time under ``torch.func.vmap`` (:func:`local_vjp_pe_grad`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.markers import tag
from repro_torch.core import costmodel
from repro_torch.core.tapper import STATS, LayerMeta, Tapper, cap_map
from repro_torch.tree import get_subtree, leaf_paths, set_subtree, tree_map

F32 = torch.float32


def _realized(n, meta: LayerMeta, method: str):
    """Mark a realized per-example norm (see ``analysis.markers``)."""
    return tag(n, kind="realization", layer_kind=meta.kind, method=method,
               path="/".join(str(p) for p in meta.path))


def _fused_marker(n, meta: LayerMeta, method: str):
    """Mark a fused norm+contrib realization (see ``analysis.markers``)."""
    return tag(n, kind="fused_impl", method=method,
               path="/".join(str(p) for p in meta.path))


def _ee(eq, *args):
    """einsum in float32."""
    return torch.einsum(eq, *(a.to(F32) for a in args))


# The two-operand contractions of the kinds, each as one batched matrix
# product: (a, b) -> (B, M, N).
_BMM = {"bti,bto->bio": lambda a, b: (a.transpose(1, 2), b),
        "bto,bti->boi": lambda a, b: (a.transpose(1, 2), b),
        "btd,bsd->bts": lambda a, b: (a, b.transpose(1, 2)),
        "bis,bso->bio": lambda a, b: (a, b)}


def _ee2(eq, a, b):
    """Two-operand einsum with a float32 result.  On the card, two bf16
    operands multiply as one bf16 GEMM with f32 output
    (``aten::bmm.dtype``), as the reference's
    ``preferred_element_type=F32`` does: a product of two bf16 numbers is
    exact in f32, so only the summation order differs from widening them
    first.  Every other call, the CPU's included, widens to f32 first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(*_BMM[eq](a, b), out_dtype=F32)
    return _ee(eq, a, b)


def _sumsq(tree):
    """Σ leaf² per example: every leaf has leading B."""
    tot = 0.0
    for leaf in tree.values():
        if isinstance(leaf, dict):
            tot = tot + _sumsq(leaf)
        else:
            tot = tot + leaf.to(F32).square().sum(
                dim=tuple(range(1, leaf.ndim)))
    return tot


def group_sumsq(pe, path: tuple):
    """Σ leaf² per example of the per-example gradient tree of the param
    group at ``path``, each leaf as this rank counts it on the active
    model axis (``ModelShard.counts``: a replicated leaf of a sliced
    group on model rank 0 only, its share of the group's one norm sum);
    off a model axis :func:`_sumsq`."""
    from repro_torch.launch import sharding
    ms = sharding.active()
    if ms is None:
        return _sumsq(pe)
    tot = 0.0
    for p in leaf_paths(pe):
        if ms.counts(path, p):
            leaf = get_subtree(pe, p)
            tot = tot + leaf.to(F32).square().sum(
                dim=tuple(range(1, leaf.ndim)))
    return tot


def _counts_bias(meta: LayerMeta) -> bool:
    """Whether this rank counts the layer's bias in its norm²: a
    row-sharded layer's replicated bias (``Tapper.dense(
    bias_after_sum=True)``) on model rank 0 only."""
    from repro_torch.launch import sharding
    ms = sharding.active()
    return bool(meta.bias_key) and (
        ms is None or ms.counts(meta.path, (meta.bias_key,)))


def _flatten_seq(x):
    """(B, *S, D) -> (B, T, D) with T = prod(S) (possibly 1)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


# ---------------------------------------------------------------------------
# Dense (batched)


def dense_pe_grad(meta: LayerMeta, cap, dy):
    x, g = _flatten_seq(cap["x"]), _flatten_seq(dy)
    if meta.w_transposed:
        w_grad = _ee2("bto,bti->boi", g, x)
    else:
        w_grad = _ee2("bti,bto->bio", x, g)
    out = {meta.param_key: w_grad}
    if meta.bias_key:
        out[meta.bias_key] = g.to(F32).sum(dim=1)
    return out


def dense_norm_sq(meta: LayerMeta, cap, dy, method: str = "auto"):
    x, g = _flatten_seq(cap["x"]), _flatten_seq(dy)
    B, T, Di = x.shape
    Do = g.shape[-1]
    if method == "auto":
        method = costmodel.dense_norm_method(T, Di, Do, B)
    if method == "rank1" and T != 1:
        method = "gram"
    need_bias = _counts_bias(meta)
    if method == "pallas":
        from repro_torch.kernels import ops as kops
        return _realized(kops.gram_norm(x, g, has_bias=need_bias),
                         meta, "pallas")
    if method == "rank1":
        n = _ee("bti,bti->b", x, x) * _ee("bto,bto->b", g, g)
        if need_bias:
            n = n + _ee("bto,bto->b", g, g)
        return _realized(n, meta, "rank1")
    if method == "stream":
        pe = dense_pe_grad(meta, cap, dy)
        return _realized(group_sumsq(pe, meta.path), meta, "stream")
    if method != "gram":
        raise ValueError(f"unknown dense norm method {method!r}")
    # gram, chunked over rows to bound the (B, chunk, T) intermediate;
    # the f32 copies of x and δy are made once, not per chunk (none for
    # bf16 on the card: the Grams are bf16 GEMMs with f32 output, _ee2)
    chunk = costmodel.GRAM_CHUNK
    if x.is_cuda and x.dtype == g.dtype == torch.bfloat16:
        xf, gf = x, g
    else:
        xf, gf = x.to(F32), g.to(F32)

    def chunk_norm(xc, gc):
        sx = _ee2("btd,bsd->bts", xc, xf)
        sy = _ee2("btd,bsd->bts", gc, gf)
        n = torch.einsum("bct,bct->b", sx, sy)
        if need_bias:
            n = n + sy.sum(dim=(1, 2))
        return n

    if T <= chunk:
        return _realized(chunk_norm(xf, gf), meta, "gram")
    n = torch.zeros((B,), dtype=F32, device=x.device)
    for s in range(0, T, chunk):
        n = n + chunk_norm(xf[:, s:s + chunk], gf[:, s:s + chunk])
    return _realized(n, meta, "gram")


def dense_norm_and_contrib(meta: LayerMeta, cap, dy, w):
    """Fused phase: per-example squared norms *and* the weighted sum
    Σ_b w_b·g_b in one pass over (x, δy), through ``gram_norm_fused``
    (this repo's CUDA kernel on the card, its plain version on the CPU):
    x and δy are read once for both outputs.  The weights must be known
    entering the pass (stale-coefficient clipping)."""
    from repro_torch.kernels import ops as kops
    STATS.fused += 1
    x, g = _flatten_seq(cap["x"]), _flatten_seq(dy)
    counted = _counts_bias(meta)
    n, cw, cb = kops.gram_norm_fused(x, g, w, has_bias=counted)
    out = {meta.param_key: cw.T if meta.w_transposed else cw}
    if meta.bias_key:
        # a bias this rank leaves out of its norm² still takes its
        # (whole) contribution
        out[meta.bias_key] = cb if counted else _ee("b,bto->o", w, g)
    return _fused_marker(n, meta, "pallas"), out


def dense_contrib(meta: LayerMeta, cap, dy, w):
    x, g = _flatten_seq(cap["x"]), _flatten_seq(dy)
    if meta.w_transposed:
        w_grad = _ee("b,bto,bti->oi", w, g, x)
    else:
        w_grad = _ee("b,bti,bto->io", w, x, g)
    out = {meta.param_key: w_grad}
    if meta.bias_key:
        out[meta.bias_key] = _ee("b,bto->o", w, g)
    return out


# ---------------------------------------------------------------------------
# Dense (segmented: MoE expert slots with explicit example ids)
#
# Every slot belongs to one example (``seg``), so the per-example
# gradient of group g is  Σ_{s: seg_s = b} x_s δy_sᵀ.  Each group's
# (B, S) example mask multiplies x, and one batched product gives the
# (B, Di, Do) per-example gradients of a chunk of groups: the
# reference's one-hot contraction "sb,si,so->bio" without its one-hot
# operand, in the same 2·B·S·Di·Do multiply-adds a group.  Empty slots
# hold zero x and δy and add nothing whatever their id.


def _seg_flatten(meta: LayerMeta, cap, dy):
    """x (G, S, Di), δy (G, S, Do), seg (G, S) and the example count B."""
    x, g, seg = cap["x"], dy, cap["seg"]
    S = x.shape[-2]
    return (x.reshape(-1, S, x.shape[-1]), g.reshape(-1, S, g.shape[-1]),
            seg.reshape(-1, S), meta.static["n_examples"])


# Elements of scratch one chunk of groups may take (2^28: 512 MB in
# bf16); the groups are taken in chunks of as many as fit.
SEG_CHUNK_ELEMS = 1 << 28


def _seg_chunks(G: int, per_group: int):
    c = max(1, min(G, SEG_CHUNK_ELEMS // max(per_group, 1)))
    return [(i, min(i + c, G)) for i in range(0, G, c)]


def _seg_mask(sg, B, dtype):
    """(c, B, S) mask of each example's slots in a chunk of groups."""
    return (sg[:, None, :] == torch.arange(B, device=sg.device)[
        None, :, None]).to(dtype)


def _seg_pe(xc, gc, sc, B):
    """A chunk of groups' (c, B, Di, Do) f32 per-example gradients (a
    view): the narrower of x and δy masked per example into (c, S, B, ·)
    (a contiguous write), then one batched product with the other side,
    which takes its transpose as a view."""
    c, S, Di = xc.shape
    Do = gc.shape[-1]
    m = _seg_mask(sc, B, xc.dtype).transpose(1, 2)[..., None]  # (c,S,B,1)
    if Di <= Do:
        xm = (xc[:, :, None, :] * m).reshape(c, S, B * Di)
        return _ee2("bis,bso->bio", xm.transpose(1, 2), gc) \
            .reshape(c, B, Di, Do)
    gm = (gc[:, :, None, :] * m).reshape(c, S, B * Do)
    return _ee2("bis,bso->bio", xc.transpose(1, 2), gm) \
        .reshape(c, Di, B, Do).transpose(1, 2)


def _seg_bias(gc, sc, B):
    """(c, B, Do) per-example bias gradients of a chunk of groups."""
    return torch.bmm(_seg_mask(sc, B, F32), gc.to(F32))


def seg_dense_pe_grad(meta: LayerMeta, cap, dy):
    x, g, seg, B = _seg_flatten(meta, cap, dy)
    G, S, Di = x.shape
    Do = g.shape[-1]
    lead = tuple(cap["x"].shape[:-2])
    chunks = _seg_chunks(G, B * (S * Di + Di * Do))
    w_grad = torch.cat([_seg_pe(x[a:b], g[a:b], seg[a:b], B)
                        for a, b in chunks]).transpose(0, 1)
    out = {meta.param_key: w_grad.reshape((B,) + lead + (Di, Do))}
    if meta.bias_key:
        bg = torch.cat([_seg_bias(g[a:b], seg[a:b], B)
                        for a, b in chunks]).transpose(0, 1)
        out[meta.bias_key] = bg.reshape((B,) + lead + (Do,))
    return out


def seg_dense_norm_sq(meta: LayerMeta, cap, dy, method: str = "auto"):
    """``stream``: each group's per-example gradients, squared; ``gram``:
    the slot Gram (x xᵀ)∘(δy δyᵀ) with same-example masking.  Both take
    the groups (experts) a chunk at a time (``SEG_CHUNK_ELEMS``), so the
    extra memory is a chunk's worth: (B, S, Di) + (B, Di, Do) a group for
    stream, (S, S) for gram."""
    x, g, seg, B = _seg_flatten(meta, cap, dy)
    G, S, Di = x.shape
    Do = g.shape[-1]
    if method in ("auto", "pallas"):
        # no kernel takes a segmented layer: "pallas" picks as the
        # planner prices it (the reference's kinds take the Gram)
        method = costmodel.seg_norm_method(S, Di, Do, B, G)
    # as in the reference, every other method takes the Gram
    method = "stream" if method == "stream" else "gram"
    n = torch.zeros((B,), dtype=F32, device=x.device)
    if method == "stream":
        for a, b in _seg_chunks(G, B * (S * Di + Di * Do)):
            n = n + _seg_pe(x[a:b], g[a:b], seg[a:b], B).square() \
                .sum(dim=(2, 3)).sum(dim=0)
            if meta.bias_key:
                n = n + _seg_bias(g[a:b], seg[a:b], B).square() \
                    .sum(dim=2).sum(dim=0)
        return _realized(n, meta, method)
    for a, b in _seg_chunks(G, 3 * S * S + S * (Di + Do)):
        xf, gf = x[a:b].to(F32), g[a:b].to(F32)
        gram_g = torch.bmm(gf, gf.transpose(1, 2))
        p = torch.bmm(xf, xf.transpose(1, 2)) * gram_g
        if meta.bias_key:
            p = p + gram_g
        oh = _seg_mask(seg[a:b], B, F32)                        # (c, B, S)
        n = n + (torch.bmm(oh, p) * oh).sum(dim=2).sum(dim=0)
    return _realized(n, meta, method)


def seg_dense_contrib(meta: LayerMeta, cap, dy, w):
    x, g, seg, _ = _seg_flatten(meta, cap, dy)
    G, S, Di = x.shape
    Do = g.shape[-1]
    lead = tuple(cap["x"].shape[:-2])
    w = w.to(F32)
    ws, bs = [], []
    for a, b in _seg_chunks(G, S * (Di + Do) + Di * Do):
        wc = w[seg[a:b]]                                        # (c, S)
        xw = x[a:b].to(F32) * wc[..., None]
        ws.append(torch.bmm(xw.transpose(1, 2), g[a:b].to(F32)))
        if meta.bias_key:
            bs.append(torch.bmm(wc[:, None], g[a:b].to(F32))[:, 0])
    out = {meta.param_key: torch.cat(ws).reshape(lead + (Di, Do))}
    if meta.bias_key:
        out[meta.bias_key] = torch.cat(bs).reshape(lead + (Do,))
    return out


# ---------------------------------------------------------------------------
# Embedding (gather)


def _embed_flat(cap, dy):
    """ids (B, T) int64 and cotangent rows (B, T, D)."""
    ids = cap["ids"]
    B = ids.shape[0]
    ids2 = ids.reshape(B, -1).long()
    return ids2, dy.reshape(B, ids2.shape[1], -1)


def embed_pe_grad(meta: LayerMeta, cap, dy, vocab: int):
    ids2, g2 = _embed_flat(cap, dy)
    B, T, D = g2.shape
    out = torch.zeros((B, vocab, D), dtype=F32, device=g2.device)
    out.scatter_add_(1, ids2[..., None].expand(B, T, D), g2.to(F32))
    return {meta.param_key: out}


def embed_norm_sq(meta: LayerMeta, cap, dy, method: str = "segsum",
                  vocab: int | None = None):
    """Embedding-gather ghost norm: ‖g_b‖² = Σ_v ‖Σ_{t: id_t=v} δy_t‖².

    ``segsum``: sort each example's tokens, sum the cotangent rows of each
    run of equal ids, square — O(T·logT + T·D).  ``gram``: the
    same-token-masked T×T Gram — O(T²·D).  ``pe``: materialize the
    (B, V, D) per-example grad and reduce (small tables only; see
    costmodel.embed_norm_method)."""
    ids2, g2 = _embed_flat(cap, dy)
    B, T, D = g2.shape
    if method == "auto":
        method = costmodel.embed_norm_method(T, D, B, vocab)
    if method == "pe":
        return _realized(_sumsq(embed_pe_grad(meta, cap, dy, vocab)),
                         meta, "pe")
    if method == "gram":
        sy = _ee2("btd,bsd->bts", g2, g2)
        m = (ids2[:, :, None] == ids2[:, None, :]).to(F32)
        return _realized(torch.einsum("bts,bts->b", m, sy), meta, "gram")
    if method != "segsum":
        raise ValueError(f"unknown embed norm method {method!r}")
    ids_s, order = torch.sort(ids2, dim=1, stable=True)
    g_s = torch.gather(g2.to(F32), 1, order[..., None].expand(B, T, D))
    newseg = torch.cumsum(torch.cat(
        [torch.zeros((B, 1), dtype=torch.long, device=ids2.device),
         (ids_s[:, 1:] != ids_s[:, :-1]).long()], dim=1), dim=1)
    summed = torch.zeros((B, T, D), dtype=F32, device=g2.device)
    summed.scatter_add_(1, newseg[..., None].expand(B, T, D), g_s)
    return _realized(summed.square().sum(dim=(1, 2)), meta, "segsum")


def embed_contrib(meta: LayerMeta, cap, dy, w, vocab: int):
    ids2, g2 = _embed_flat(cap, dy)
    D = g2.shape[-1]
    gw = g2.to(F32) * w.to(F32)[:, None, None]
    out = torch.zeros((vocab, D), dtype=F32, device=g2.device)
    out.index_add_(0, ids2.reshape(-1), gw.reshape(-1, D))
    return {meta.param_key: out}


# ---------------------------------------------------------------------------
# Scale / bias (elementwise affine)


def _scale_reduce_axes(x, gshape):
    """Axes of x (beyond batch) over which the g-broadcast reduces."""
    nd, ng = x.ndim, len(gshape)
    axes = []
    for ax in range(1, nd):
        gax = ax - (nd - ng)
        if gax < 0 or gshape[gax] == 1:
            axes.append(ax)
    return tuple(axes)


def scale_pe_grad(meta: LayerMeta, cap, dy, gshape):
    x, g = cap["x"], dy
    axes = _scale_reduce_axes(x, gshape)
    # the product in the capture dtype, as the JAX package forms it
    pg = (x * g).to(F32).sum(dim=axes)
    out = {meta.param_key: pg.reshape((x.shape[0],) + tuple(gshape))}
    if meta.bias_key:
        pb = g.to(F32).sum(dim=axes)
        out[meta.bias_key] = pb.reshape((x.shape[0],) + tuple(gshape))
    return (model_partial_sum(out, meta)
            if meta.static.get("model_partial") else out)


def model_partial_sum(pe: dict, meta: LayerMeta) -> dict:
    """The per-example gradient of a ``model_partial`` layer's replicated
    leaves (``LayerMeta.static``: a scale layer's, a ``local_vjp``
    layer's named leaves), partial on each rank (the rank's heads only),
    summed over the active model group: whole on every rank, so such a
    leaf counts as replicated (its norm never summed again unless its
    group is sliced, and then counted on model rank 0 only; its
    contribution kept local).  The sum is made each time a norm or a
    contribution reads the gradient (twice a step under crb and bk, one
    all-reduce of the layer's leaves side by side each, counted in
    ``COLL_STATS``).  Each leaf is marked ``partial_pe`` first, which the
    verifier's model half reads."""
    from repro_torch.launch import sharding
    group = sharding.active().group
    key = "/".join(map(str, meta.path))
    ks = list(pe)
    flat = [tag(pe[k], kind="partial_pe", group=key).reshape(
        pe[k].shape[0], -1) for k in ks]
    # one all-reduce for every leaf of the layer (Mamba2's three ssd
    # vectors), each leaf a run of columns
    summed = sharding.all_reduce(torch.cat(flat, dim=1), group).split(
        [f.shape[1] for f in flat], dim=1)
    return {k: t.reshape(pe[k].shape) for k, t in zip(ks, summed)}


def scale_norm_sq(meta: LayerMeta, cap, dy, gshape):
    return _realized(_sumsq(scale_pe_grad(meta, cap, dy, gshape)),
                     meta, "pe")


def scale_contrib(meta: LayerMeta, cap, dy, w, gshape):
    pe = scale_pe_grad(meta, cap, dy, gshape)
    wb = w.to(F32).reshape((-1,) + (1,) * len(gshape))
    return {k: (v * wb).sum(dim=0) for k, v in pe.items()}


# ---------------------------------------------------------------------------
# Convolution (the paper's contribution — Algorithms 1 & 2)


def conv_pe_grad(meta: LayerMeta, cap, dy, impl: str = "fgc"):
    from repro_torch.models import convops
    st = meta.static
    w_grad = convops.pe_conv_grad(
        cap["x"], dy, kernel_spatial=st["kernel_shape"][2:],
        stride=st["stride"], dilation=st["dilation"], padding=st["padding"],
        groups=st["groups"], impl=impl)
    out = {meta.param_key: w_grad}
    if meta.bias_key:
        out[meta.bias_key] = dy.to(F32).sum(dim=tuple(range(2, dy.ndim)))
    return out


def conv_norm_sq_ghost(meta: LayerMeta, cap, dy, *, use_pallas: bool = False):
    """Conv ghost norm without materializing per-example weight grads:
    im2col the input to x̃ (B, T, C·K/g per group) and apply the dense Gram
    identity  ‖g_b‖² = Σ_{t,t'} (x̃_t·x̃_{t'}) (δy_t·δy_{t'})  per group —
    the per-layer "ghost clipping" of Bu et al. (2022) generalized to
    stride/dilation/padding/groups."""
    from repro_torch.models.convops import unfold_patches
    st = meta.static
    x = cap["x"]
    g = max(st.get("groups", 1), 1)
    patches = unfold_patches(x, st["kernel_shape"][2:], stride=st["stride"],
                             dilation=st["dilation"], padding=st["padding"])
    B, CK, T = patches.shape
    D = dy.shape[1]
    gy = dy.reshape(B, D, T)
    method = "pallas" if use_pallas else "gram"
    if g == 1:
        meta_d = LayerMeta("dense", meta.path, bias_key=meta.bias_key)
        return dense_norm_sq(meta_d, {"x": patches.transpose(1, 2)},
                             gy.transpose(1, 2), method=method)
    Fg, Dg = CK // g, D // g
    xt = patches.reshape(B, g, Fg, T).transpose(2, 3).reshape(B * g, T, Fg)
    gt = gy.reshape(B, g, Dg, T).transpose(2, 3).reshape(B * g, T, Dg)
    meta_d = LayerMeta("dense", meta.path)
    n = dense_norm_sq(meta_d, {"x": xt}, gt, method=method)
    n = n.reshape(B, g).sum(dim=1)
    if meta.bias_key:
        sb = gy.to(F32).sum(dim=2)
        n = n + sb.square().sum(dim=1)
    return n


def conv_norm_sq(meta: LayerMeta, cap, dy, impl: str = "fgc",
                 method: str = "pe"):
    if method == "auto":
        st = meta.static
        T = int(np.prod(dy.shape[2:]))
        K = int(np.prod(st["kernel_shape"][2:]))
        method = costmodel.conv_norm_method(
            T, cap["x"].shape[1], dy.shape[1], K, dy.shape[0],
            max(st.get("groups", 1), 1))
    if method in ("ghost", "pallas"):
        return _realized(conv_norm_sq_ghost(
            meta, cap, dy, use_pallas=(method == "pallas")), meta, method)
    if method != "pe":
        raise ValueError(f"unknown conv norm method {method!r}")
    return _realized(_sumsq(conv_pe_grad(meta, cap, dy, impl=impl)),
                     meta, "pe")


def conv_norm_and_contrib(meta: LayerMeta, cap, dy, w):
    """Fused conv ghost norm + weighted weight gradient: im2col the input
    and run the dense fused pass per group.  The contribution
    Σ_b w_b x̃_bᵀ δy_b *is* the weighted conv weight gradient in patch
    space (channel-major, filter-position-minor, the (D, C/g, *K) weight
    layout), so the reshape back is free.  The transposed patch and
    cotangent views go to the kernel as they are: it reads through their
    strides, so no (B, T, C·K) copy is made."""
    from repro_torch.models.convops import unfold_patches
    st = meta.static
    g = max(st.get("groups", 1), 1)
    kshape = tuple(st["kernel_shape"])
    patches = unfold_patches(cap["x"], kshape[2:], stride=st["stride"],
                             dilation=st["dilation"], padding=st["padding"])
    B, CK, T = patches.shape
    D = dy.shape[1]
    gy = dy.reshape(B, D, T)
    if g == 1:
        meta_d = LayerMeta("dense", meta.path, param_key=meta.param_key,
                           bias_key=meta.bias_key)
        n, out = dense_norm_and_contrib(
            meta_d, {"x": patches.transpose(1, 2)}, gy.transpose(1, 2), w)
        out[meta.param_key] = out[meta.param_key].T.reshape(kshape)
        return n, out
    Fg, Dg = CK // g, D // g
    xg = patches.reshape(B, g, Fg, T)
    gg = gy.reshape(B, g, Dg, T)
    meta_d = LayerMeta("dense", meta.path, param_key=meta.param_key)
    n = torch.zeros((B,), dtype=F32, device=dy.device)
    w_parts = []
    for gi in range(g):
        n_i, out = dense_norm_and_contrib(
            meta_d, {"x": xg[:, gi].transpose(1, 2)},
            gg[:, gi].transpose(1, 2), w)
        n = n + n_i
        w_parts.append(out[meta.param_key].T.reshape((Dg,) + kshape[1:]))
    res = {meta.param_key: torch.cat(w_parts, dim=0)}
    if meta.bias_key:
        sb = gy.to(F32).sum(dim=2)                               # (B, D)
        n = n + sb.square().sum(dim=1)
        res[meta.bias_key] = _ee("b,bo->o", w, sb)
    return n, res


_CONV_WEIGHT_GRAD = {1: torch.nn.grad.conv1d_weight,
                     2: torch.nn.grad.conv2d_weight,
                     3: torch.nn.grad.conv3d_weight}


def conv_contrib(meta: LayerMeta, cap, dy, w):
    """Σ_b w_b g_b as one weight gradient of the conv over the batch with
    x scaled by w_b."""
    from repro_torch.models.convops import _tup
    st = meta.static
    xin = cap["x"]
    rank = xin.ndim - 2
    x = xin * w.reshape((-1,) + (1,) * (xin.ndim - 1)).to(xin.dtype)
    w_grad = _CONV_WEIGHT_GRAD[rank](
        x, st["kernel_shape"], dy.to(xin.dtype),
        stride=_tup(st["stride"], rank), padding=_tup(st["padding"], rank),
        dilation=_tup(st["dilation"], rank), groups=st["groups"])
    out = {meta.param_key: w_grad.to(F32)}
    if meta.bias_key:
        gw = dy.to(F32) * w.reshape((-1,) + (1,) * (dy.ndim - 1)).to(F32)
        out[meta.bias_key] = gw.sum(dim=(0,) + tuple(range(2, gw.ndim)))
    return out


# ---------------------------------------------------------------------------
# Attention blocks (GQA / MLA, tapped as one "attn" layer)
#
# The block tap captures only the block input x_b and receives the block
# output cotangent δy_b from the model backward.  A layer-local recompute
# under an inner capture-mode Tapper then recovers every projection's
# (x, δy) pair: differentiating  Σ_b ⟨y_b, δy_b⟩  with respect to the
# inner projections' outputs (as capture_backward does for the model)
# yields exactly the chain-rule cotangents of the true loss at each of
# them, δy being constant; each projection then applies its own
# dense/scale algebra.  Like the JAX package's, this is a layer-local
# recompute, not a whole-model pass: no STATS ticks, the census stays one
# forward and one backward a step.


def _attn_parts(meta: LayerMeta, cap, dy, params_sub):
    """Run the block again: (inner metas, captures, cotangents) of each
    inner tap.  Inner tap names are rooted at the fixed "blk" prefix (see
    ``gqa_apply`` / ``mla_apply``), so an inner layer's param path
    relative to the block is ``path[1:]``.  The objective is formed in
    f32 (δy cast to f32, ``sum(y.float() * δy)``), as the JAX package
    forms it, so bf16 inner cotangents round alike."""
    if meta.fn is None:
        raise ValueError(
            f"attn layer {'/'.join(map(str, meta.path))} has no rebuild "
            f"closure (a meta read back from a plan's JSON?): realize it "
            f"with the live metas of the capture pass")
    inner_metas: dict[str, LayerMeta] = {}
    tp = Tapper("capture", metas=inner_metas)
    dyf = dy.to(F32)
    with torch.enable_grad():
        y = meta.fn(tp, params_sub, cap["x"])
        names = list(tp.outputs)
        grads = torch.autograd.grad((y.to(F32) * dyf).sum(),
                                    [tp.outputs[n] for n in names])
    return inner_metas, tp.captures, dict(zip(names, grads))


def _attn_each(meta: LayerMeta, params_sub, inner_metas):
    """(name, inner meta re-rooted under meta.path, relative path, param
    subtree) of each inner tap, in sorted order."""
    for iname in sorted(inner_metas):
        im = inner_metas[iname]
        rel = im.path[1:]
        imf = dataclasses.replace(im, path=meta.path + rel, scanned=0,
                                  shared=False)
        yield iname, imf, rel, get_subtree(params_sub, rel)


def _attn_inner(op, meta: LayerMeta, cap, dy, params_sub, weights=None):
    """``op`` over every inner tap of one recompute: the norms summed, or
    the per-projection trees assembled at the block's relative paths."""
    inner_metas, caps, dtaps = _attn_parts(meta, cap, dy, params_sub)
    out = None if op == "norm_sq" else {}
    for iname, imf, rel, psub_i in _attn_each(meta, params_sub,
                                              inner_metas):
        part = _apply_flat(op, imf, caps[iname], dtaps[iname],
                           params_sub=psub_i, weights=weights,
                           norm_method="auto", conv_impl="fgc")
        if op == "norm_sq":
            out = part if out is None else out + part
            continue
        for k2, v2 in part.items():
            out = set_subtree(out, rel + (k2,), v2)
    return out


def attn_pe_grad(meta: LayerMeta, cap, dy, params_sub):
    return _attn_inner("pe_grad", meta, cap, dy, params_sub)


def attn_norm_sq(meta: LayerMeta, cap, dy, params_sub, method: str = "auto"):
    """``ghost`` (the default for ``auto``): each projection's own norm
    realization; ``pe``: the materialized per-projection grads, squared."""
    if method == "auto":
        method = "ghost"
    if method == "pe":
        return _realized(_sumsq(attn_pe_grad(meta, cap, dy, params_sub)),
                         meta, "pe")
    if method != "ghost":
        raise ValueError(f"unknown attn norm method {method!r}")
    return _realized(_attn_inner("norm_sq", meta, cap, dy, params_sub),
                     meta, "ghost")


def attn_contrib(meta: LayerMeta, cap, dy, w, params_sub):
    return _attn_inner("contrib", meta, cap, dy, params_sub, weights=w)


# ---------------------------------------------------------------------------
# Generic local-VJP kind (SSM scans)
#
# The layer is pure, ``y = fn(params_sub, *inputs)``, and its captures are
# its inputs.  The per-example gradient is the VJP of one example's call
# (a batch of one) at its own output cotangent, vmapped over the examples
# with ``params_sub`` shared.  It runs after the capture backward, outside
# any ``torch.utils.checkpoint``, so the saved-tensor hooks that
# ``torch.func`` refuses (fault F4) never meet it.
#
# On a model axis a local_vjp layer runs on the rank's heads, and ``fn``
# stays rank-local (no collective under vmap).  Its leaves are counted
# thus: a sliced leaf (sLSTM's R, sliced on heads) gives the rank's
# slice of the per-example gradient, its norm² partial; a replicated
# leaf that ``fn`` reads for the rank's heads only (``static
# ["model_partial"]``: Mamba2's ``ssd`` params, sLSTM's gate bias ``b``
# at the rank's channels) gives a partial gradient, zero off those heads,
# which ``model_partial_sum`` sums over ``model`` each time a norm or a
# contribution reads it, and which is then whole.  A wholly replicated
# group (``ssd``) so has a whole norm on every rank, never summed again;
# a mixed one (``rec``: R beside b) is a sliced group, whose partial
# norm² takes R's slice on every rank and the whole b on model rank 0
# only (``group_sumsq``), summed over ``model`` once.


def local_vjp_pe_grad(meta: LayerMeta, cap, dy, params_sub):
    """(B, *param) per-example grads of ``params_sub``: δy is cast to the
    layer output's dtype before the VJP, as the JAX package does; the
    ``model_partial`` leaves' summed over ``model``."""
    if meta.fn is None:
        raise ValueError(
            f"local_vjp layer {'/'.join(map(str, meta.path))} has no fn "
            f"(a meta read back from a plan's JSON?): realize it with the "
            f"live metas of the capture pass")
    fn = meta.fn

    def one(inputs_b, dy_b):
        def f(p):
            return fn(p, *[a[None] for a in inputs_b])
        y, vjp = torch.func.vjp(f, params_sub)
        (g,) = vjp(dy_b[None].to(y.dtype))
        return g

    with torch.enable_grad():
        pe = torch.func.vmap(one)(cap["inputs"], dy)
    keys = meta.static.get("model_partial")
    if not keys:
        return pe
    return {**pe, **model_partial_sum({k: pe[k] for k in keys}, meta)}


def local_vjp_norm_sq(meta: LayerMeta, cap, dy, params_sub):
    return _realized(group_sumsq(local_vjp_pe_grad(meta, cap, dy,
                                                   params_sub), meta.path),
                     meta, "vjp")


def local_vjp_contrib(meta: LayerMeta, cap, dy, w, params_sub):
    pe = local_vjp_pe_grad(meta, cap, dy, params_sub)
    return tree_map(lambda leaf: _ee("b...,b->...", leaf, w), pe)


# ---------------------------------------------------------------------------
# Stacked-layer handling: fold meta.scanned leading axes


def _unscanned(meta: LayerMeta) -> LayerMeta:
    return dataclasses.replace(meta, scanned=0, shared=False)


def _split_stack(meta: LayerMeta, cap, dy):
    """Flatten the stacked-layer axes into one leading G axis (views)."""
    k = meta.scanned

    def flat(a):
        return a.reshape((-1,) + tuple(a.shape[k:]))

    return cap_map(flat, cap), flat(dy), tuple(dy.shape[:k])


def _fold_into_seq(meta: LayerMeta, cap, dy):
    """For shared params: fold the stacked axes into the sequence axis, so
    the per-example gradient is summed over applications *before* norms:
    (S1..Sk, B, *rest, D) -> (B, S, *rest, D)."""
    if meta.scanned == 0:
        return cap, dy

    def fold(a):
        return a.reshape((-1,) + tuple(a.shape[meta.scanned:])) \
            .transpose(0, 1)
    return cap_map(fold, cap), fold(dy)


def apply_kind(op: str, meta: LayerMeta, cap, dy, *, params_sub=None,
               weights=None, norm_method: str = "auto", conv_impl: str = "fgc",
               embed_method: str = "segsum", conv_norm: str = "pe",
               attn_norm: str = "auto"):
    """Dispatch ``op`` in {"pe_grad","norm_sq","contrib"} over the kinds,
    handling stacked (scanned) axes and shared parameters."""
    kw = dict(norm_method=norm_method, conv_impl=conv_impl,
              embed_method=embed_method, conv_norm=conv_norm,
              attn_norm=attn_norm)
    if meta.shared and meta.scanned and meta.kind in ("dense", "scale") \
            and not meta.segmented:
        # Fold applications into the sequence axis: the per-example
        # gradient of a shared parameter is the sum over applications,
        # and the fold makes every op (the Gram norm's cross terms too)
        # exact.
        cap, dy = _fold_into_seq(meta, cap, dy)
        return _apply_flat(op, _unscanned(meta), cap, dy,
                           params_sub=params_sub, weights=weights, **kw)
    if meta.shared and meta.scanned and op == "norm_sq":
        # Generic shared fallback: materialize the summed per-example grad
        # (exact cross terms), then take norms.
        pe = apply_kind("pe_grad", meta, cap, dy, params_sub=params_sub,
                        conv_impl=conv_impl)
        return _realized(group_sumsq(pe, meta.path), meta, "pe")
    if not meta.scanned:
        return _apply_flat(op, meta, cap, dy, params_sub=params_sub,
                           weights=weights, **kw)
    if meta.segmented:
        # The segmented kinds reduce over their leading group axis one
        # group at a time already: flatten every stack into it.
        cap_f, dy_f, stack_shape = _split_stack(meta, cap, dy)
        res = _apply_flat(op, _unscanned(meta), cap_f, dy_f,
                          params_sub=params_sub, weights=weights, **kw)
        if op == "norm_sq":
            return res
        if op == "contrib":
            return tree_map(lambda a: a.reshape(stack_shape + a.shape[1:]),
                            res)
        # pe_grad: (B, G, ...) -> (B, *stack, ...)
        return tree_map(lambda a: a.reshape(
            (a.shape[0],) + stack_shape + a.shape[2:]), res)
    cap_f, dy_f, stack_shape = _split_stack(meta, cap, dy)
    meta_f = _unscanned(meta)
    G = dy_f.shape[0]
    if params_sub is not None and not meta.shared:
        psub = tree_map(lambda a: a.reshape((-1,) + tuple(
            a.shape[meta.scanned:])), params_sub)
    else:
        psub = None
    # One stacked layer at a time: peak scratch is one layer's worth.
    # Results land in preallocated (G, ...) buffers (norms: a running sum).
    total, bufs = None, None
    for i in range(G):
        p_i = params_sub if meta.shared else (
            None if psub is None else tree_map(lambda a: a[i], psub))
        res = _apply_flat(op, meta_f, cap_map(lambda a: a[i], cap_f),
                          dy_f[i], params_sub=p_i, weights=weights, **kw)
        if op == "norm_sq" or meta.shared:
            total = res if total is None else (
                total + res if op == "norm_sq"
                else tree_map(torch.add, total, res))
            continue
        if bufs is None:
            bufs = tree_map(lambda a: torch.empty(
                (G,) + tuple(a.shape), dtype=a.dtype, device=a.device), res)
        tree_map(lambda buf, a: buf[i].copy_(a), bufs, res)
    if op == "norm_sq" or meta.shared:
        return total
    if op == "contrib":
        return tree_map(lambda a: a.reshape(stack_shape + a.shape[1:]), bufs)
    # pe_grad: (G, B, *p) -> (B, *stack, *p)
    return tree_map(lambda a: torch.movedim(
        a.reshape(stack_shape + a.shape[1:]), len(stack_shape), 0), bufs)


def apply_norm_contrib(meta: LayerMeta, cap, dy, *, weights,
                       params_sub=None, fused: bool = True,
                       conv_impl: str = "fgc", norm_method: str = "auto",
                       embed_method: str = "segsum",
                       conv_norm: str = "auto", attn_norm: str = "auto"):
    """Per-example squared norms *and* the weighted sum Σ_b w_b·g_b from
    one pass over the captures; valid whenever the weights are known
    entering the pass (stale-coefficient clipping).

    Dense layers that are not segmented go to the fused ``gram_norm_fused``
    realization when ``fused``, the layers the planner marks ``fused``:
    a shared scanned layer folds its stack into the sequence axis first,
    a scanned one takes its stack one layer at a time (the JAX package's
    ``lax.map``) and sums the norms over it; so do unscanned conv layers.
    Every other kind, and the non-fused request, falls back to the
    norm_sq + contrib pair (still one capture pass of the model, just two
    reductions over the same tensors)."""
    if fused and meta.kind == "dense" and not meta.segmented:
        if meta.shared and meta.scanned:
            cap2, dy2 = _fold_into_seq(meta, cap, dy)
            return dense_norm_and_contrib(_unscanned(meta), cap2, dy2,
                                          weights)
        if not meta.scanned:
            return dense_norm_and_contrib(meta, cap, dy, weights)
        cap_f, dy_f, stack_shape = _split_stack(meta, cap, dy)
        meta_f = _unscanned(meta)
        total, bufs = None, None
        for i in range(dy_f.shape[0]):
            n, c = dense_norm_and_contrib(
                meta_f, {k: a[i] for k, a in cap_f.items()}, dy_f[i],
                weights)
            total = n if total is None else total + n
            if bufs is None:
                bufs = tree_map(lambda a: torch.empty(
                    (dy_f.shape[0],) + tuple(a.shape), dtype=a.dtype,
                    device=a.device), c)
            tree_map(lambda buf, a: buf[i].copy_(a), bufs, c)
        return total, tree_map(
            lambda a: a.reshape(stack_shape + a.shape[1:]), bufs)
    if fused and meta.kind == "conv" and not meta.scanned:
        return conv_norm_and_contrib(meta, cap, dy, weights)
    n = apply_kind("norm_sq", meta, cap, dy, params_sub=params_sub,
                   norm_method=norm_method, conv_impl=conv_impl,
                   embed_method=embed_method, conv_norm=conv_norm,
                   attn_norm=attn_norm)
    c = apply_kind("contrib", meta, cap, dy, params_sub=params_sub,
                   weights=weights, conv_impl=conv_impl)
    return n, c


def _apply_flat(op, meta, cap, dy, *, params_sub, weights, norm_method,
                conv_impl, embed_method="segsum", conv_norm="pe",
                attn_norm="auto"):
    kind = meta.kind
    if op not in ("pe_grad", "norm_sq", "contrib"):
        raise ValueError(f"unknown op {op!r}")
    if kind == "dense" and meta.segmented:
        if op == "pe_grad":
            return seg_dense_pe_grad(meta, cap, dy)
        if op == "norm_sq":
            return seg_dense_norm_sq(meta, cap, dy, method=norm_method)
        return seg_dense_contrib(meta, cap, dy, weights)
    if kind == "dense":
        if op == "pe_grad":
            return dense_pe_grad(meta, cap, dy)
        if op == "norm_sq":
            return dense_norm_sq(meta, cap, dy, method=norm_method)
        return dense_contrib(meta, cap, dy, weights)
    if kind == "embed":
        vocab = (params_sub[meta.param_key].shape[-2]
                 if params_sub is not None else meta.static.get("vocab"))
        if op == "pe_grad":
            return embed_pe_grad(meta, cap, dy, vocab)
        if op == "norm_sq":
            return embed_norm_sq(meta, cap, dy, method=embed_method,
                                 vocab=vocab)
        return embed_contrib(meta, cap, dy, weights, vocab)
    if kind == "scale":
        gshape = tuple(params_sub[meta.param_key].shape)
        if op == "pe_grad":
            return scale_pe_grad(meta, cap, dy, gshape)
        if op == "norm_sq":
            return scale_norm_sq(meta, cap, dy, gshape)
        return scale_contrib(meta, cap, dy, weights, gshape)
    if kind == "conv":
        if op == "pe_grad":
            return conv_pe_grad(meta, cap, dy, impl=conv_impl)
        if op == "norm_sq":
            return conv_norm_sq(meta, cap, dy, impl=conv_impl,
                                method=conv_norm)
        return conv_contrib(meta, cap, dy, weights)
    if kind == "attn":
        if op == "pe_grad":
            return attn_pe_grad(meta, cap, dy, params_sub)
        if op == "norm_sq":
            return attn_norm_sq(meta, cap, dy, params_sub, method=attn_norm)
        return attn_contrib(meta, cap, dy, weights, params_sub)
    if kind == "local_vjp":
        if op == "pe_grad":
            return local_vjp_pe_grad(meta, cap, dy, params_sub)
        if op == "norm_sq":
            return local_vjp_norm_sq(meta, cap, dy, params_sub)
        return local_vjp_contrib(meta, cap, dy, weights, params_sub)
    raise ValueError(f"unknown kind {kind}")


# ---------------------------------------------------------------------------
# Tied-parameter cross term: <g_embed_b, g_head_b> for weight-tied LM heads


def tied_embed_head_cross(cap_e, dy_e, cap_d, dy_d):
    """2·⟨g_in, g_out⟩ per example for a parameter used both as an
    embedding table (gather) and, transposed, as the LM head (dense
    ``w_transposed``):

      g_in[v,d]  = Σ_t 1[id_t=v] δe[t,d]
      g_out[v,d] = Σ_s δl[s,v] h[s,d]
      ⟨g_in,g_out⟩ = Σ_{t,s} δl[s, id_t] · (δe[t]·h[s])

    so the (V, D) per-example gradients are never formed: one (B, T, S)
    f32 product and a gather of δl at the token ids."""
    ids2, de = _embed_flat(cap_e, dy_e)                   # (B,T), (B,T,D)
    B, T = ids2.shape
    h = _flatten_seq(cap_d["x"])                          # (B, S, D)
    S = h.shape[1]
    dl = dy_d.reshape(B, S, -1)                           # (B, S, V)
    a = _ee2("btd,bsd->bts", de, h)                       # (B, T, S)
    dl_at = torch.gather(dl, 2, ids2[:, None, :].expand(B, S, T))
    inner = torch.einsum("bts,bst->b", a, dl_at.to(F32))
    return 2.0 * inner
