"""Plain PyTorch versions of the port's kernels (the correctness
contracts), translated from the JAX package's ``kernels/ref.py``.

``ops`` takes these only for tensors on the CPU; on the card they serve
``chip_smoke.py`` as the yardstick each kernel is held against.  Each
repeats its kernel's function in f32: the Gram identity for
``gram_norm`` and ``gram_norm_fused``'s norm, the same-id masked Gram for
``gram_norm_tokmask``, the shifted products for ``pe_conv_grad_2d`` and
``pe_conv_grad_1d`` (which keep f64 inputs in f64), the full (T, S)
softmax for the flash kernels.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def gram_norm_ref(x, dy, *, has_bias: bool = False):
    """out[b] = Σ_{t,t'} (x_t·x_t')(δy_t·δy_t') = ‖δy_bᵀ x_b‖²_F
    (+ ‖Σ_t δy‖² if has_bias)."""
    xf, gf = x.to(F32), dy.to(F32)
    sx = torch.bmm(xf, xf.transpose(1, 2))
    sy = torch.bmm(gf, gf.transpose(1, 2))
    n = torch.einsum("bts,bts->b", sx, sy)
    if has_bias:
        n = n + sy.sum(dim=(1, 2))
    return n


def gram_norm_product_ref(x, dy, *, has_bias: bool = False):
    """:func:`gram_norm_ref`'s function by the per-example product,
    ‖δy_bᵀx_b‖²_F = ‖x_bᵀδy_b‖²_F (+ ‖Σ_t δy‖² if has_bias): the plain
    version where the T×T Grams do not fit (VGG16's conv0–1, T = 65 536:
    17 GB a Gram an example).  f32, or f64 for f64 inputs."""
    dt = torch.promote_types(dy.dtype, F32)
    xf, gf = x.to(dt), dy.to(dt)
    n = torch.bmm(xf.transpose(1, 2), gf).square().sum(dim=(1, 2))
    if has_bias:
        n = n + gf.sum(dim=1).square().sum(dim=1)
    return n


def gram_norm_fused_ref(x, dy, w, *, has_bias: bool = False):
    """Fused ghost norm + weighted contribution:
    (‖δy_bᵀx_b‖²_F [+ ‖Σ_t δy_bt‖²], Σ_b w_b·x_bᵀδy_b, Σ_b w_b·Σ_t δy_bt),
    all f32; the bias sum is zeros without a bias.  The norm goes by the
    T×T Gram identity and the contribution as one (B·T)-row contraction,
    as in the JAX package's reference."""
    xf, gf = x.to(F32), dy.to(F32)
    wf = w.to(device=x.device, dtype=F32)
    sy = torch.bmm(gf, gf.transpose(1, 2))
    n = torch.einsum("bts,bts->b", torch.bmm(xf, xf.transpose(1, 2)), sy)
    c = torch.einsum("b,bti,bto->io", wf, xf, gf)
    cb = torch.zeros((dy.shape[-1],), dtype=F32, device=dy.device)
    if has_bias:
        n = n + sy.sum(dim=(1, 2))
        cb = torch.einsum("b,bto->o", wf, gf)
    return n, c, cb


def gram_norm_tokmask_ref(ids, dy):
    """out[b] = Σ_{t,t'} [id_t = id_t'] (δy_t·δy_t'): the embedding
    gather's ghost norm by the id-masked T×T Gram, in f32."""
    gf = dy.to(F32)
    sy = torch.bmm(gf, gf.transpose(1, 2))
    m = ids[:, :, None] == ids[:, None, :]
    return (sy * m).sum(dim=(1, 2))


def pe_conv_grad_1d_ref(x, dy, K: int):
    """δh[b,d,c,k] = Σ_t x[b,c,t+k] δy[b,d,t] — x padded, stride =
    dilation = 1.  Returns (B, D, C, K) in f32, or f64 for f64 inputs
    (the exact sum ``bounds.sum_bound`` holds a kernel to)."""
    Tp = dy.shape[2]
    dt = torch.promote_types(dy.dtype, F32)
    dyf = dy.to(dt)
    return torch.stack([torch.einsum("bct,bdt->bdc",
                                     x[:, :, k:k + Tp].to(dt), dyf)
                        for k in range(K)], dim=-1)


def pe_conv_grad_2d_ref(x, dy, KH: int, KW: int):
    """δh[b,d,c,kh,kw] = Σ_{h,w} x[b,c,h+kh,w+kw] δy[b,d,h,w] — x padded,
    stride = dilation = 1.  Returns (B, D, C, KH, KW) in f32, or f64 for
    f64 inputs (the exact sum ``bounds.sum_bound`` holds a kernel to)."""
    Hp, Wp = dy.shape[2], dy.shape[3]
    dt = torch.promote_types(dy.dtype, F32)
    dyf = dy.to(dt)
    rows = []
    for kh in range(KH):
        row = []
        for kw in range(KW):
            xs = x[:, :, kh:kh + Hp, kw:kw + Wp].to(dt)
            row.append(torch.einsum("bchw,bdhw->bdc", xs, dyf))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------------------------
# Flash attention: the full-softmax math of the three flash kernels

NEG = -1e30


def _flash_scores(q, k, causal: bool):
    """(B, H, T, S) f32 raw scores q·kᵀ (no scale) with the GQA fold, and
    the causal mask (True where key s <= query t), or None."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.to(F32), kr.to(F32))
    mask = None
    if causal:
        t = torch.arange(T, device=q.device)[:, None]
        mask = torch.arange(S, device=q.device)[None, :] <= t
    return s, mask


def flash_fwd_ref(q, k, v, *, causal: bool = True):
    """q (B, T, H, hd), k/v (B, S, Hkv, hd) -> (o (B, T, H, hd) in q's
    dtype, lse (B, H, T) f32), as the forward kernel computes them:
    masked scores are -1e30, P is cast to v's dtype before P·V, the row
    sum is taken on the f32 P, and lse = m + log(max(l, 1e-30))."""
    hd = q.shape[-1]
    H, Hkv = q.shape[2], k.shape[2]
    s, mask = _flash_scores(q, k, causal)
    s = s * hd ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    vr = v.repeat_interleave(H // Hkv, dim=2)
    acc = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).to(F32),
                       vr.to(F32))
    lc = torch.clamp(l, min=1e-30)
    o = acc / lc.permute(0, 2, 1, 3)
    lse = (m + torch.log(lc))[..., 0]
    return o.to(q.dtype), lse


def flash_delta(o, do):
    """Δ = rowsum(dO∘O) in f32, (B, H, T): the softmax-Jacobian term of
    the backward, formed outside the kernels (as in the JAX package)."""
    return (do.to(F32) * o.to(F32)).sum(-1).transpose(1, 2).contiguous()


def _flash_ds(q, k, v, do, lse, delta, causal):
    """P = exp(s - lse) and dS = P∘(dO·Vᵀ − Δ)·scale, (B, H, T, S) f32 —
    the flash backward's recomputation."""
    hd = q.shape[-1]
    H, Hkv = q.shape[2], k.shape[2]
    scale = hd ** -0.5
    s, mask = _flash_scores(q, k, causal)
    s = s * scale
    if mask is not None:
        s = s.masked_fill(~mask, NEG)
    p = torch.exp(s - lse[..., None])
    vr = v.repeat_interleave(H // Hkv, dim=2).to(F32)
    dp = torch.einsum("bthd,bshd->bhts", do.to(F32), vr)
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_ref(q, k, v, do, lse, delta, *, causal: bool = True):
    """dq = dS·K (dS cast to k's dtype), in q's dtype: the plain version
    of the dq kernel."""
    _, ds = _flash_ds(q, k, v, do, lse, delta, causal)
    rep = q.shape[2] // k.shape[2]
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).to(F32),
                      k.repeat_interleave(rep, dim=2).to(F32))
    return dq.to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, delta, *, causal: bool = True):
    """(dk, dv): dk = dSᵀ·Q, dv = Pᵀ·dO (P and dS cast to the input dtype),
    summed over each KV head's ``rep`` query heads: the plain version of
    the dk/dv kernel."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    p, ds = _flash_ds(q, k, v, do, lse, delta, causal)
    dk = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).to(F32), q.to(F32))
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).to(F32),
                      do.to(F32))
    dk = dk.reshape(B, S, Hkv, H // Hkv, hd).sum(3)
    dv = dv.reshape(B, S, Hkv, H // Hkv, hd).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)
