"""Convolution forward + the paper's per-example conv-gradient trick.

Layout is NC(spatial) for inputs, (D, C/groups, *K) for weights — the
paper's (PyTorch) convention, and the JAX package's.

``pe_conv_grad`` implements Algorithm 2 of Rochette et al. (2019):

  * ``impl="fgc"`` — the paper-faithful lowering: the per-example
    convolution ``x ⊛ δy`` is expressed as a grouped convolution with
    ``groups = B·Γ``, one *extra* spatial dimension holding the layer's
    input channels, ``stride`` and ``dilation`` swapped, and the output
    truncated to the kernel size.  A 2-D layer becomes an ``F.conv3d``
    (so 3-D layers, which would need a 4-D conv, are not served).
  * ``impl="pallas"`` — this repo's own kernel
    (:mod:`repro_torch.kernels.ops`); the name is the JAX package's, so
    configs stay one-to-one.
  * ``impl="bgc"`` — XLA's ``batch_group_count`` has no PyTorch
    counterpart; it raises until a lowering pinned equal to ``fgc``
    exists (ROADMAP.md item 2).
"""
from __future__ import annotations

import torch.nn.functional as F


def _tup(v, rank: int):
    if isinstance(v, (tuple, list)):
        assert len(v) == rank, (v, rank)
        return tuple(int(x) for x in v)
    return (int(v),) * rank


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_forward(x, w, *, stride=1, dilation=1, padding=0, groups: int = 1):
    """y[b,d,t] = Σ_{c,k} x[b, c, s·t + r·k] · w[d,c,k]  (+ groups)."""
    rank = x.ndim - 2
    return _CONV[rank](x, w, stride=_tup(stride, rank),
                       padding=_tup(padding, rank),
                       dilation=_tup(dilation, rank), groups=groups)


def unfold_patches(x, kernel_spatial, *, stride=1, dilation=1, padding=0):
    """im2col: x (B, C, *S) -> (B, C·K, T) patch matrix, K = prod(kernel),
    T = prod(out_spatial).  Channel ordering is input-channel major /
    filter-position minor (``lax.conv_general_dilated_patches``'s order,
    which ``F.unfold`` shares), so per-group feature blocks stay
    contiguous.  1-D inputs go through ``F.unfold`` as (1, T) images."""
    rank = len(kernel_spatial)
    s, r, p = _tup(stride, rank), _tup(dilation, rank), _tup(padding, rank)
    k = tuple(int(v) for v in kernel_spatial)
    if rank == 1:
        x = x.unsqueeze(2)
        k, s, r, p = (1,) + k, (1,) + s, (1,) + r, (0,) + p
    elif rank != 2:
        raise NotImplementedError(
            f"unfold_patches serves 1-D and 2-D convs, got rank {rank}")
    return F.unfold(x, k, dilation=r, padding=p, stride=s)


def conv_output_spatial(in_spatial, kernel_spatial, stride, dilation, padding):
    rank = len(kernel_spatial)
    s, r, p = _tup(stride, rank), _tup(dilation, rank), _tup(padding, rank)
    return tuple(
        (t + 2 * pi - ri * (k - 1) - 1) // si + 1
        for t, k, si, ri, pi in zip(in_spatial, kernel_spatial, s, r, p))


def pe_conv_grad(x, dy, *, kernel_spatial, stride=1, dilation=1, padding=0,
                 groups: int = 1, impl: str = "fgc"):
    """Per-example convolution-weight gradients (Algorithm 2).

    x: (B, C, *S); dy: (B, D, *S').  Returns (B, D, C/Γ, *K).
    """
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.pe_conv_grad(x, dy, kernel_spatial=kernel_spatial,
                                 stride=stride, dilation=dilation,
                                 padding=padding, groups=groups)
    if impl == "bgc":
        raise NotImplementedError(
            "impl='bgc' needs XLA's batch_group_count, which PyTorch lacks; "
            "use impl='fgc' (ROADMAP.md item 2)")
    if impl != "fgc":
        raise ValueError(f"unknown impl {impl!r}")
    rank = len(kernel_spatial)
    if rank not in (1, 2):
        raise NotImplementedError(
            f"fgc lowers a rank-{rank} conv to a rank-{rank + 1} conv; "
            f"PyTorch stops at 3-D")
    B, C = x.shape[:2]
    D = dy.shape[1]
    s, r, p = _tup(stride, rank), _tup(dilation, rank), _tup(padding, rank)
    g = groups
    lhs = x.reshape((1, B * g, C // g) + tuple(x.shape[2:]))
    rhs = dy.reshape((B * D, 1, 1) + tuple(dy.shape[2:])).to(x.dtype)
    out = _CONV[rank + 1](lhs, rhs, stride=(1,) + r,     # stride <- dilation
                          padding=(0,) + p,
                          dilation=(1,) + s,             # dilation <- stride
                          groups=B * g)
    # out: (1, B*D, C/Γ, *K⁺) — truncate the floor-induced extra taps.
    out = out[0][(slice(None), slice(None))
                 + tuple(slice(0, k) for k in kernel_spatial)]
    return out.reshape((B, D, C // g) + tuple(kernel_spatial))
