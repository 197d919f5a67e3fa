"""Per-layer-kind gradient algebra (dense and conv kinds).

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
reach the same identity over im2col patches.

All reductions accumulate in float32 regardless of capture dtype.

The method string ``"pallas"`` keeps the JAX package's spelling so that
``NormCfg`` and configs stay one-to-one; here it means this repo's own
CUDA kernel (:mod:`repro_torch.kernels.ops`).  Scanned, shared,
segmented, embed, scale, attn and local_vjp kinds come with the LM slice
(ROADMAP.md item 11) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.markers import tag
from repro_torch.core import costmodel
from repro_torch.core.tapper import STATS, LayerMeta

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


def _flatten_seq(x):
    """(B, *S, D) -> (B, T, D) with T = prod(S) (possibly 1)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


# ---------------------------------------------------------------------------
# Dense (batched)


def dense_pe_grad(meta: LayerMeta, cap, dy):
    x, g = _flatten_seq(cap["x"]), _flatten_seq(dy)
    if meta.w_transposed:
        w_grad = _ee("bto,bti->boi", g, x)
    else:
        w_grad = _ee("bti,bto->bio", x, g)
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
    if method == "pallas":
        from repro_torch.kernels import ops as kops
        return _realized(kops.gram_norm(x.contiguous(), g.contiguous(),
                                        has_bias=bool(meta.bias_key)),
                         meta, "pallas")
    if method == "rank1":
        n = _ee("bti,bti->b", x, x) * _ee("bto,bto->b", g, g)
        if meta.bias_key:
            n = n + _ee("bto,bto->b", g, g)
        return _realized(n, meta, "rank1")
    if method == "stream":
        pe = dense_pe_grad(meta, cap, dy)
        return _realized(_sumsq(pe), meta, "stream")
    if method != "gram":
        raise ValueError(f"unknown dense norm method {method!r}")
    # gram, chunked over rows to bound the (B, chunk, T) intermediate
    chunk = costmodel.GRAM_CHUNK
    need_bias = bool(meta.bias_key)

    def chunk_norm(xc, gc):
        sx = _ee("bci,bti->bct", xc, x)
        sy = _ee("bco,bto->bct", gc, g)
        n = _ee("bct,bct->b", sx, sy)
        if need_bias:
            n = n + sy.sum(dim=(1, 2))
        return n

    if T <= chunk:
        return _realized(chunk_norm(x, g), meta, "gram")
    n = torch.zeros((B,), dtype=F32, device=x.device)
    for s in range(0, T, chunk):
        n = n + chunk_norm(x[:, s:s + chunk], g[:, s:s + chunk])
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
    n, cw, cb = kops.gram_norm_fused(x, g, w, has_bias=bool(meta.bias_key))
    out = {meta.param_key: cw.T if meta.w_transposed else cw}
    if meta.bias_key:
        out[meta.bias_key] = cb
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
# Dispatch


def apply_kind(op: str, meta: LayerMeta, cap, dy, *, params_sub=None,
               weights=None, norm_method: str = "auto", conv_impl: str = "fgc",
               conv_norm: str = "pe"):
    """Dispatch ``op`` in {"pe_grad","norm_sq","contrib"} over the kinds of
    this slice: unscanned, unshared dense and conv layers."""
    if meta.scanned or meta.shared or meta.segmented:
        raise NotImplementedError(
            f"layer {'/'.join(map(str, meta.path))}: scanned, shared and "
            f"segmented layers come with the LM slice (ROADMAP.md item 11)")
    return _apply_flat(op, meta, cap, dy, params_sub=params_sub,
                       weights=weights, norm_method=norm_method,
                       conv_impl=conv_impl, conv_norm=conv_norm)


def apply_norm_contrib(meta: LayerMeta, cap, dy, *, weights,
                       params_sub=None, fused: bool = True,
                       conv_impl: str = "fgc", norm_method: str = "auto",
                       conv_norm: str = "auto"):
    """Per-example squared norms *and* the weighted sum Σ_b w_b·g_b from
    one pass over the captures; valid whenever the weights are known
    entering the pass (stale-coefficient clipping).

    Unscanned dense (non-segmented) and conv layers, shared or not, go to
    the fused ``gram_norm_fused`` realizations when ``fused``, the layers
    the planner marks ``fused``; the non-fused request falls back to the
    norm_sq + contrib pair (still one capture pass of the model, just two
    reductions over the same tensors).  Scanned layers come with the LM
    slice and raise there."""
    if fused and not meta.scanned:
        if meta.kind == "dense" and not meta.segmented:
            return dense_norm_and_contrib(meta, cap, dy, weights)
        if meta.kind == "conv":
            return conv_norm_and_contrib(meta, cap, dy, weights)
    n = apply_kind("norm_sq", meta, cap, dy, params_sub=params_sub,
                   norm_method=norm_method, conv_impl=conv_impl,
                   conv_norm=conv_norm)
    c = apply_kind("contrib", meta, cap, dy, params_sub=params_sub,
                   weights=weights, conv_impl=conv_impl)
    return n, c


def _apply_flat(op, meta, cap, dy, *, params_sub, weights, norm_method,
                conv_impl, conv_norm="pe"):
    kind = meta.kind
    if op not in ("pe_grad", "norm_sq", "contrib"):
        raise ValueError(f"unknown op {op!r}")
    if kind == "dense":
        if op == "pe_grad":
            return dense_pe_grad(meta, cap, dy)
        if op == "norm_sq":
            return dense_norm_sq(meta, cap, dy, method=norm_method)
        return dense_contrib(meta, cap, dy, weights)
    if kind == "conv":
        if op == "pe_grad":
            return conv_pe_grad(meta, cap, dy, impl=conv_impl)
        if op == "norm_sq":
            return conv_norm_sq(meta, cap, dy, impl=conv_impl,
                                method=conv_norm)
        return conv_contrib(meta, cap, dy, weights)
    if kind in ("embed", "scale", "attn", "local_vjp"):
        raise NotImplementedError(
            f"layer kind {kind!r} comes with the LM slice (ROADMAP.md "
            f"item 11)")
    raise ValueError(f"unknown kind {kind}")
