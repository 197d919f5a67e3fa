"""Plain PyTorch versions of the port's kernels (the correctness
contracts), translated from the JAX package's ``kernels/ref.py``.

``ops`` takes these only for tensors on the CPU; on the card they serve
``chip_smoke.py`` as the yardstick each kernel is held against.  Each
repeats its kernel's function in f32: the Gram identity for
``gram_norm`` and ``gram_norm_fused``'s norm, the shifted products for
``pe_conv_grad_2d``.
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


def pe_conv_grad_2d_ref(x, dy, KH: int, KW: int):
    """δh[b,d,c,kh,kw] = Σ_{h,w} x[b,c,h+kh,w+kw] δy[b,d,h,w] — x padded,
    stride = dilation = 1.  Returns (B, D, C, KH, KW) f32."""
    Hp, Wp = dy.shape[2], dy.shape[3]
    dyf = dy.to(F32)
    rows = []
    for kh in range(KH):
        row = []
        for kw in range(KW):
            xs = x[:, :, kh:kh + Hp, kw:kw + Wp].to(F32)
            row.append(torch.einsum("bchw,bdhw->bdc", xs, dyf))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)
