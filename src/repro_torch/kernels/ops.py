"""Public wrappers + device dispatch for the port's kernels.

The rule, for every wrapper:
  * a CUDA tensor goes to the hand-written kernel (``csrc/*.cu``, built
    at first use by :mod:`repro_torch.kernels.build`), or the call raises;
  * a CPU tensor goes to the plain PyTorch version in
    :mod:`repro_torch.kernels.ref`;
  * nothing falls back from one to the other.

Each wrapper checks types (f32 or bf16 in), contiguity (except
``gram_norm_fused``, whose kernel reads through strides) and shapes,
allocates outputs and scratch with ``torch.empty``, launches on
PyTorch's current stream, and adds one to ``LAUNCHES[<kernel>]`` per
launch.  ``chip_smoke.py`` reads the counts to show that the main path
went through the kernels.

The JAX package's TPU tile autotuner (``_autotune_bd``, ``pick_bd``,
``vmem_budget``, ``REPRO_PE_CONV_BD``) plans VMEM and has no counterpart
here; a Hopper tile sweep belongs to calibration (ROADMAP.md item 13).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref

LAUNCHES = {"pe_conv_grad_2d": 0, "gram_norm": 0, "gram_norm_fused": 0}

_IN_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
_GRAM_BT = 64      # Gram tile rows in csrc/gram_norm.cu
_FUSED_TILE = 64   # contribution tile (Di and Do) of gram_norm_fused


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_pair(name: str, x, dy, ndim: int):
    if x.ndim != ndim or dy.ndim != ndim:
        raise ValueError(f"{name}: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} must both have {ndim} dims")
    if x.shape[0] != dy.shape[0]:
        raise ValueError(f"{name}: batch sizes differ: {x.shape[0]} vs "
                         f"{dy.shape[0]}")
    if x.dtype not in _IN_DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"{name}: x and dy must share f32 or bf16, got "
                        f"{x.dtype} and {dy.dtype}")
    if x.device != dy.device:
        raise ValueError(f"{name}: x on {x.device}, dy on {dy.device}")


def _launch_ready(name: str, *tensors, strided: bool = False) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU inputs
    (take the plain version); raises for anything else.  A ``strided``
    kernel reads through strides with 64-bit offsets, so its inputs skip
    the contiguity and 32-bit size checks."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    if strided:
        return True
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.numel() > _INT_MAX:
            raise ValueError(f"{name}: {tuple(t.shape)} exceeds the kernel's "
                             f"32-bit index range")
    return True


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} ({torch.cuda.get_device_name()})")


def gram_norm(x, dy, *, has_bias: bool = False):
    """x (B, T, Di), dy (B, T, Do) -> (B,) f32 squared per-example norms
    ‖δy_bᵀ x_b‖²_F (+ ‖Σ_t δy_bt‖² with a bias)."""
    _check_pair("gram_norm", x, dy, 3)
    B, T, Di = x.shape
    Do = dy.shape[2]
    if dy.shape[1] != T:
        raise ValueError(f"gram_norm: x has T={T}, dy has T={dy.shape[1]}")
    if not _launch_ready("gram_norm", x, dy):
        return _ref.gram_norm_ref(x, dy, has_bias=has_bias)
    nT = -(-T // _GRAM_BT)
    if B > _GRID_YZ_MAX or nT > _GRID_YZ_MAX:
        raise ValueError(f"gram_norm: grid ({nT}, {nT}, {B}) too large")
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    partial = torch.empty((B, nT, nT), dtype=torch.float32, device=x.device)
    from repro_torch.kernels import build
    lib = build.load("gram_norm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_gram_norm(x.data_ptr(), dy.data_ptr(),
                                 partial.data_ptr(), out.data_ptr(), B, T,
                                 Di, Do, int(has_bias),
                                 int(x.dtype == torch.bfloat16), stream)
    _raise_on(rc, "gram_norm")
    LAUNCHES["gram_norm"] += 1
    return out


def gram_norm_fused(x, dy, w, *, has_bias: bool = False):
    """x (B, T, Di), dy (B, T, Do), w (B,) -> (norms (B,), contribution
    Σ_b w_b·x_bᵀδy_b (Di, Do), bias contribution Σ_b w_b·Σ_t δy_bt (Do,)),
    all f32; the bias contribution is zeros without a bias.

    The kernel reads x and dy through their strides, so a transposed view
    (the conv path's im2col patches) needs no copy."""
    _check_pair("gram_norm_fused", x, dy, 3)
    B, T, Di = x.shape
    Do = dy.shape[2]
    if dy.shape[1] != T or tuple(w.shape) != (B,):
        raise ValueError(f"gram_norm_fused: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)} and w {tuple(w.shape)} do not "
                         f"fit (B, T, Di), (B, T, Do), (B,)")
    if not _launch_ready("gram_norm_fused", x, dy, strided=True):
        return _ref.gram_norm_fused_ref(x, dy, w, has_bias=has_bias)
    if w.device != x.device:
        raise ValueError(f"gram_norm_fused: w on {w.device}, x on {x.device}")
    n_tiles = -(-Di // _FUSED_TILE) * -(-Do // _FUSED_TILE)
    if max(B, T, Di, Do, B * n_tiles) > _INT_MAX \
            or -(-Di // _FUSED_TILE) > _GRID_YZ_MAX:
        raise ValueError(f"gram_norm_fused: {tuple(x.shape)} x "
                         f"{tuple(dy.shape)} exceeds the kernel's grid")
    dev = x.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    cc = torch.empty((Di * Do + Do,), dtype=torch.float32, device=dev)
    c, cb = cc[:Di * Do].view(Di, Do), cc[Di * Do:]
    if B == 0 or Di == 0 or Do == 0:
        return out.zero_(), c.zero_(), cb.zero_()
    wf = w.to(torch.float32).contiguous()
    partial = torch.empty((B, n_tiles), dtype=torch.float32, device=dev)
    # Split the batch into G groups so that about two waves of blocks
    # (three resident per SM) cover the card; each group's contribution
    # has its own slot in cpart, summed in order by the kernel pair.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = max(1, min(B, -(-6 * sms // n_tiles)))
    cpart = (torch.empty((groups, cc.numel()), dtype=torch.float32,
                         device=dev) if groups > 1 else cc)
    from repro_torch.kernels import build
    lib = build.load("gram_norm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_gram_norm_fused(
            x.data_ptr(), *x.stride(), dy.data_ptr(), *dy.stride(),
            wf.data_ptr(), partial.data_ptr(), out.data_ptr(), cc.data_ptr(),
            cpart.data_ptr(), B, T, Di, Do, groups, int(has_bias),
            int(x.dtype == torch.bfloat16), stream)
    _raise_on(rc, "gram_norm_fused")
    LAUNCHES["gram_norm_fused"] += 1
    return out, c, cb


def pe_conv_grad_2d(x, dy, *, KH: int, KW: int):
    """x (B, C, H, W) already padded, dy (B, D, H-KH+1, W-KW+1) ->
    (B, D, C, KH, KW) f32.  Stride = dilation = 1, groups = 1."""
    _check_pair("pe_conv_grad_2d", x, dy, 4)
    B, C, H, W = x.shape
    D, Hp, Wp = dy.shape[1:]
    if (Hp, Wp) != (H - KH + 1, W - KW + 1):
        raise ValueError(f"pe_conv_grad_2d: dy spatial {(Hp, Wp)} does not "
                         f"match x {(H, W)} and kernel {(KH, KW)}")
    if not _launch_ready("pe_conv_grad_2d", x, dy):
        return _ref.pe_conv_grad_2d_ref(x, dy, KH, KW)
    if B > _GRID_YZ_MAX:
        raise ValueError(f"pe_conv_grad_2d: batch {B} too large for the grid")
    out = torch.empty((B, D, C, KH, KW), dtype=torch.float32,
                      device=x.device)
    if out.numel() > _INT_MAX:
        raise ValueError("pe_conv_grad_2d: output exceeds the kernel's "
                         "32-bit index range")
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build
    lib = build.load("pe_conv_grad")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_pe_conv_grad_2d(x.data_ptr(), dy.data_ptr(),
                                       out.data_ptr(), B, C, H, W, D, Hp, Wp,
                                       KH, KW, int(x.dtype == torch.bfloat16),
                                       stream)
    _raise_on(rc, "pe_conv_grad_2d")
    LAUNCHES["pe_conv_grad_2d"] += 1
    return out


def _as_tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def pe_conv_grad(x, dy, *, kernel_spatial, stride=1, dilation=1, padding=0,
                 groups: int = 1):
    """Kernel path for Algorithm 2.  Plain 2-D convs (stride = dilation =
    1, groups = 1) reach ``pe_conv_grad_2d`` after padding x; every other
    conv takes the grouped-conv lowering (``convops`` ``impl="fgc"``, still
    the paper's algorithm), as in the JAX package."""
    from repro_torch.models import convops
    rank = len(kernel_spatial)
    plain = (groups == 1 and _as_tuple(stride, rank) == (1,) * rank
             and _as_tuple(dilation, rank) == (1,) * rank)
    if plain and rank == 1:
        raise NotImplementedError(
            "pe_conv_grad_1d is not ported yet (ROADMAP.md queue 2 item 4)")
    if plain and rank == 2:
        p = _as_tuple(padding, rank)
        if any(p):
            x = F.pad(x, (p[1], p[1], p[0], p[0]))
        dy = dy.to(x.dtype)
        return pe_conv_grad_2d(x.contiguous(), dy.contiguous(),
                               KH=kernel_spatial[0], KW=kernel_spatial[1])
    return convops.pe_conv_grad(x, dy, kernel_spatial=kernel_spatial,
                                stride=stride, dilation=dilation,
                                padding=padding, groups=groups, impl="fgc")
