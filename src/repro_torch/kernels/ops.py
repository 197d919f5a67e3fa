"""Public wrappers + device dispatch for the port's kernels.

The rule, for every wrapper:
  * a CUDA tensor goes to the hand-written kernel (``csrc/*.cu``, built
    at first use by :mod:`repro_torch.kernels.build`), or the call raises;
  * a CPU tensor goes to the plain PyTorch version in
    :mod:`repro_torch.kernels.ref`;
  * nothing falls back from one to the other.

Each wrapper checks types (f32 or bf16 in), contiguity (except
``gram_norm``, ``gram_norm_fused`` and the flash kernels, which read
through strides) and shapes, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream, and adds one to
``LAUNCHES[<kernel>]`` per launch.  ``chip_smoke.py`` reads the counts to show that the main path
went through the kernels.

``gram_norm`` runs one of three routes, picked by shape
(:func:`gram_route`): rank-1 at T = 1, the per-example product (the core
``gram_norm_fused`` shares), or the symmetric Gram.

The three flash kernels (forward, dq, dk/dv) have two designs, chosen
by dtype and head_dim (:func:`flash_design`): bf16 on the tensor cores
(``wgmma``) and f32 FMAs (``fma``).

``flash_attention`` is differentiable: a ``torch.autograd.Function``
runs the forward wrapper and, in its backward, the dq and dk/dv
wrappers, which recompute P from the saved lse (on the CPU each wrapper
takes its plain version, so both devices run one backward
formulation).  On ``device="meta"`` (the planner's shape-only probe) it
returns an empty output of the right shape and launches nothing.

``pe_conv_grad_2d`` runs on the tensor cores (``wgmma``) in both dtypes
(:func:`pe_conv_design`); ``gram_norm_tokmask`` takes a sorted segment
sum up to 16 384 tokens and the masked-Gram tiles above
(:func:`tokmask_route`).

The JAX package's TPU tile autotuner (``_autotune_bd``, ``pick_bd``,
``REPRO_PE_CONV_BD``) plans VMEM and has no counterpart here.  Its
``vmem_budget`` (the calibrated VMEM sweep winner) has one:
:func:`pe_conv_tile_rows`, the output tile rows that calibration's sweep
found fastest for ``pe_conv_grad_2d`` on this card (0 keeps the shape
rule, :func:`pe_conv_tile_rule`: 128 x 64 tiles, or 64 x 128 where D
leaves a 128-row tile a quarter empty).  The 1-D kernel picks 64 x 64,
or 128 x 128 in f32 and 128 x 64 in bf16, by shape in
``csrc/pe_conv_grad.cu``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref

LAUNCHES = {"pe_conv_grad_2d": 0, "pe_conv_grad_1d": 0, "gram_norm": 0,
            "gram_norm_fused": 0, "gram_norm_tokmask": 0, "flash_fwd": 0,
            "flash_dq": 0, "flash_dkv": 0}

_IN_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
# Tiles of csrc/gram_norm.cu: the per-example product (Di x Do), the
# symmetric Gram (token rows), the FMA cores' contraction step, and
# gram_norm_tokmask's token tiles.
_DIRECT_BM, _DIRECT_BN = 128, 64
_GRAM_T = 64
_GRAM_BK = 32
_GRAM_BT = 64
_ROUTES = ("rank1", "direct", "gram")   # repro_gram_norm's route codes
# gram_norm_tokmask's sorted route: the most (id, t) pairs its block-wide
# sort takes in shared memory, its slices of sorted tokens and its chunks
# of features; its route codes.
_TOK_SORT_CAP = 16384
_TOK_SLICE, _TOK_CHUNK = 64, 1024
_TOK_ROUTES = ("sorted", "gram")


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gram_route(T: int, Di: int, Do: int) -> str:
    """The route ``gram_norm`` takes on the card for x (B, T, Di) and
    dy (B, T, Do): "rank1" at T = 1 (‖x_b‖²·‖δy_b‖²); otherwise the
    cheaper, in multiply-adds on the kernels' padded tiles, of "direct"
    (the per-example product x_bᵀδy_b: 128 x 64 tiles of Di x Do, 32-deep
    steps of T) and "gram" (the symmetric Gram pair: 64 x 64 token tiles
    j ≥ i, 32-deep steps of Di and of Do).  ``csrc/gram_norm.cu`` runs
    the route it is given."""
    if min(T, Di, Do) < 1:
        raise ValueError(f"gram_route: T={T}, Di={Di}, Do={Do} must be "
                         f"positive")
    if T == 1:
        return "rank1"
    n_t = _cdiv(T, _GRAM_T)
    gram = (n_t * (n_t + 1) // 2 * _GRAM_T ** 2
            * (_cdiv(Di, _GRAM_BK) + _cdiv(Do, _GRAM_BK)) * _GRAM_BK)
    direct = (_cdiv(Di, _DIRECT_BM) * _DIRECT_BM * _cdiv(Do, _DIRECT_BN)
              * _DIRECT_BN * _cdiv(T, _GRAM_BK) * _GRAM_BK)
    return "direct" if direct <= gram else "gram"


def _waves(blocks: int, sms: int) -> int:
    """Waves of the FMA cores' blocks, two resident an SM."""
    return _cdiv(blocks, 2 * sms)


def direct_splits(B: int, T: int, n_tiles: int, sms: int):
    """(S, chunk): the direct route cuts T into S chunks of ``chunk``
    rows (a multiple of 64, at least 256 rows a chunk once cut), each
    chunk's tile written out and summed in order before it is squared.
    T is cut only where the B·n_tiles blocks leave SMs idle (less than
    one wave); S is then the cut with the least (waves of B·S·n_tiles
    blocks on ``sms`` SMs) x chunk, the fewest chunks among equals."""
    if B * n_tiles >= 2 * sms:
        return 1, _cdiv(T, 64) * 64
    best = None
    for cut in range(1, _cdiv(T, 256) + 1):
        chunk = _cdiv(_cdiv(T, cut), 64) * 64
        s = _cdiv(T, chunk)
        cost = _waves(B * s * n_tiles, sms) * chunk
        if best is None or cost < best[0]:
            best = (cost, s, chunk)
    return best[1], best[2]


def fused_groups(B: int, n_tiles: int, sms: int) -> int:
    """G: ``gram_norm_fused`` splits the batch into G groups of
    ceil(B / G) examples, none empty, each block walking one group
    through one tile; G is the split with the least (waves of
    G·n_tiles blocks on ``sms`` SMs) x (examples a group), the fewest
    groups among equals (each group adds a Di x Do slot to sum)."""
    best = None
    for split in range(1, B + 1):
        bg = _cdiv(B, split)
        g = _cdiv(B, bg)
        cost = _waves(g * n_tiles, sms) * bg
        if best is None or cost < best[0]:
            best = (cost, g)
    return best[1]


def _staging(t):
    """(tmajor, mode) for operand ``t`` (B, T, F): tmajor when its T axis
    is the contiguous one (else its F axis, or neither); mode 16 when
    16-byte copies along that axis are aligned, else 4 (f32: 4-byte
    copies) or 0 (bf16: plain loads).  A size-1 axis counts as
    contiguous."""
    sb, st, sf = (s if n > 1 else 0 for s, n in zip(t.stride(), t.shape))
    per = 16 // t.element_size()
    if sf in (0, 1):
        tmajor, other = False, st
    elif st in (0, 1):
        tmajor, other = True, sf
    else:
        tmajor, other = st < sf, None
    aligned = (other is not None and other % per == 0 and sb % per == 0
               and t.data_ptr() % 16 == 0)
    return tmajor, (16 if aligned else
                    4 if t.dtype == torch.float32 else 0)


def _check_grid(name, x, dy, zs):
    if max(*x.shape, dy.shape[2]) > _INT_MAX or zs > _GRID_YZ_MAX:
        raise ValueError(f"{name}: {tuple(x.shape)} x {tuple(dy.shape)} "
                         f"exceeds the kernel's grid")


def gram_norm(x, dy, *, has_bias: bool = False):
    """x (B, T, Di), dy (B, T, Do) -> (B,) f32 squared per-example norms
    ‖δy_bᵀ x_b‖²_F (+ ‖Σ_t δy_bt‖² with a bias), by the route
    :func:`gram_route` picks.  The kernel reads x and dy through their
    strides, so a transposed view (the conv path's im2col patches) needs
    no copy."""
    _check_pair("gram_norm", x, dy, 3)
    B, T, Di = x.shape
    Do = dy.shape[2]
    if dy.shape[1] != T:
        raise ValueError(f"gram_norm: x has T={T}, dy has T={dy.shape[1]}")
    if not _launch_ready("gram_norm", x, dy, strided=True):
        return _ref.gram_norm_ref(x, dy, has_bias=has_bias)
    dev = x.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    if T == 0:
        return out.zero_()
    if Di == 0 or Do == 0:
        raise ValueError(f"gram_norm: empty feature axis in {tuple(x.shape)} "
                         f"x {tuple(dy.shape)}")
    route = gram_route(T, Di, Do)
    splits, chunk, zs = 1, T, B
    f32 = dict(dtype=torch.float32, device=dev)
    partial = split = colsum = None
    if route == "direct":
        n_tiles = _cdiv(Di, _DIRECT_BM) * _cdiv(Do, _DIRECT_BN)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, chunk = direct_splits(B, T, n_tiles, sms)
        zs = B * splits
        partial = torch.empty((B, n_tiles), **f32)
        if splits > 1:
            split = torch.empty((zs, n_tiles, _DIRECT_BM * _DIRECT_BN),
                                **f32)
    elif route == "gram":
        n_t = _cdiv(T, _GRAM_T)
        partial = torch.empty((B, n_t * (n_t + 1) // 2), **f32)
    _check_grid("gram_norm", x, dy, zs)
    if has_bias and route != "rank1":
        colsum = torch.empty((B, Do), **f32)
    (xt, xmode), (yt, ymode) = _staging(x), _staging(dy)
    from repro_torch.kernels import build
    lib = build.load("gram_norm")
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_gram_norm(
            x.data_ptr(), *x.stride(), dy.data_ptr(), *dy.stride(),
            ptr(partial), ptr(split), ptr(colsum), out.data_ptr(), B, T, Di,
            Do, _ROUTES.index(route), splits, chunk, int(xt), int(yt),
            xmode, ymode, int(has_bias), int(x.dtype == torch.bfloat16),
            stream)
    _raise_on(rc, "gram_norm")
    LAUNCHES["gram_norm"] += 1
    return out


def gram_norm_fused(x, dy, w, *, has_bias: bool = False):
    """x (B, T, Di), dy (B, T, Do), w (B,) -> (norms (B,), contribution
    Σ_b w_b·x_bᵀδy_b (Di, Do), bias contribution Σ_b w_b·Σ_t δy_bt (Do,)),
    all f32; the bias contribution is zeros without a bias.

    One pass of the per-example product core (``gram_norm``'s direct
    route) with the weights; it reads x and dy through their strides, so
    a transposed view (the conv path's im2col patches) needs no copy."""
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
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B,), **f32)
    cc = torch.empty((Di * Do + Do,), **f32)
    c, cb = cc[:Di * Do].view(Di, Do), cc[Di * Do:]
    if min(B, T, Di, Do) == 0:
        return out.zero_(), c.zero_(), cb.zero_()
    n_tiles = _cdiv(Di, _DIRECT_BM) * _cdiv(Do, _DIRECT_BN)
    if B * n_tiles > _INT_MAX:
        raise ValueError(f"gram_norm_fused: {B} x {n_tiles} tiles exceed the "
                         f"kernel's index range")
    # Each group's contribution has its own slot in cpart, summed in order.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = fused_groups(B, n_tiles, sms)
    _check_grid("gram_norm_fused", x, dy, groups)
    wf = w.to(torch.float32).contiguous()
    partial = torch.empty((B, n_tiles), **f32)
    colsum = torch.empty((B, Do), **f32) if has_bias else None
    if not has_bias:
        cb.zero_()
    cpart = torch.empty((groups, Di * Do), **f32) if groups > 1 else c
    (xt, xmode), (yt, ymode) = _staging(x), _staging(dy)
    from repro_torch.kernels import build
    lib = build.load("gram_norm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_gram_norm_fused(
            x.data_ptr(), *x.stride(), dy.data_ptr(), *dy.stride(),
            wf.data_ptr(), partial.data_ptr(),
            None if colsum is None else colsum.data_ptr(), out.data_ptr(),
            c.data_ptr(), cb.data_ptr(), cpart.data_ptr(), B, T, Di, Do,
            groups, int(xt), int(yt), xmode, ymode, int(has_bias),
            int(x.dtype == torch.bfloat16), stream)
    _raise_on(rc, "gram_norm_fused")
    LAUNCHES["gram_norm_fused"] += 1
    return out, c, cb


def tokmask_route(T: int) -> str:
    """The route ``gram_norm_tokmask`` takes on the card for T tokens an
    example: "sorted" (a block-wide sort of the (id, t) pairs, then one
    segment sum a run of equal ids, reading δy once) up to the sort's
    cap of 16 384 pairs, "gram" (the TPU kernel's id-masked Gram tiles,
    2·T²·D FLOP an example) above it."""
    if T < 1:
        raise ValueError(f"tokmask_route: T={T} must be positive")
    return "sorted" if T <= _TOK_SORT_CAP else "gram"


def gram_norm_tokmask(ids, dy):
    """ids (B, T) integer token ids, dy (B, T, D) -> (B,) f32 embedding
    ghost norms Σ_{t,t'} [id_t = id_t']·(δy_t·δy_t') = Σ_v ‖Σ_{t: id_t = v}
    δy_t‖², by the route :func:`tokmask_route` picks.  Every one of the T
    positions is a real token (no padding id is reserved)."""
    if ids.ndim != 2 or dy.ndim != 3 or tuple(ids.shape) != tuple(
            dy.shape[:2]):
        raise ValueError(f"gram_norm_tokmask: ids {tuple(ids.shape)} and dy "
                         f"{tuple(dy.shape)} do not fit (B, T), (B, T, D)")
    if ids.dtype.is_floating_point or ids.dtype.is_complex \
            or ids.dtype == torch.bool:
        raise TypeError(f"gram_norm_tokmask: ids must be integers, got "
                        f"{ids.dtype}")
    if dy.dtype not in _IN_DTYPES:
        raise TypeError(f"gram_norm_tokmask: dy must be f32 or bf16, got "
                        f"{dy.dtype}")
    if ids.device != dy.device:
        raise ValueError(f"gram_norm_tokmask: ids on {ids.device}, dy on "
                         f"{dy.device}")
    ready = _launch_ready("gram_norm_tokmask", dy)
    if ids.dtype == torch.int64 and ids.numel():
        # one reduction and one copy to the host
        lo, hi = torch.stack(torch.aminmax(ids)).tolist()
        if lo < -2 ** 31 or hi >= 2 ** 31:
            raise ValueError("gram_norm_tokmask: ids exceed int32, the "
                             "kernel's id type")
    if not ready:
        return _ref.gram_norm_tokmask_ref(ids, dy)
    B, T, D = dy.shape
    out = torch.empty((B,), dtype=torch.float32, device=dy.device)
    if B == 0:
        return out
    if T == 0 or D == 0:
        return out.zero_()
    route = tokmask_route(T)
    f32 = dict(dtype=torch.float32, device=dy.device)
    order = None
    if route == "sorted":
        blocks = _cdiv(T, _TOK_SLICE) * _cdiv(D, _TOK_CHUNK)
        if B > _GRID_YZ_MAX or B * blocks > _INT_MAX:
            raise ValueError(f"gram_norm_tokmask: grid ({blocks}, {B}) too "
                             f"large")
        order = torch.empty((B, T), dtype=torch.int32, device=dy.device)
        partial = torch.empty((B, blocks), **f32)
    else:
        nT = _cdiv(T, _GRAM_BT)
        if B > _GRID_YZ_MAX or nT > _GRID_YZ_MAX:
            raise ValueError(f"gram_norm_tokmask: grid ({nT}, {nT}, {B}) "
                             f"too large")
        partial = torch.empty((B, nT, nT), **f32)
    per = 16 // dy.element_size()
    vec = D % per == 0 and dy.data_ptr() % 16 == 0
    ids32 = ids.to(torch.int32).contiguous()
    from repro_torch.kernels import build
    lib = build.load("gram_norm")
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_gram_norm_tokmask(
            ids32.data_ptr(), dy.data_ptr(),
            None if order is None else order.data_ptr(), partial.data_ptr(),
            out.data_ptr(), B, T, D, _TOK_ROUTES.index(route), int(vec),
            int(dy.dtype == torch.bfloat16), stream)
    _raise_on(rc, "gram_norm_tokmask")
    LAUNCHES["gram_norm_tokmask"] += 1
    return out


def pe_conv_grad_1d(x, dy, *, K: int):
    """x (B, C, T) already padded, dy (B, D, T-K+1) -> (B, D, C, K) f32.
    Stride = dilation = 1, groups = 1."""
    _check_pair("pe_conv_grad_1d", x, dy, 3)
    B, C, T = x.shape
    D, Tp = dy.shape[1:]
    if Tp != T - K + 1 or K < 1:
        raise ValueError(f"pe_conv_grad_1d: dy length {Tp} does not match x "
                         f"length {T} and kernel {K}")
    if not _launch_ready("pe_conv_grad_1d", x, dy):
        return _ref.pe_conv_grad_1d_ref(x, dy, K)
    if B > _GRID_YZ_MAX:
        raise ValueError(f"pe_conv_grad_1d: batch {B} too large for the grid")
    out = torch.empty((B, D, C, K), dtype=torch.float32, device=x.device)
    if out.numel() > _INT_MAX:
        raise ValueError("pe_conv_grad_1d: output exceeds the kernel's "
                         "32-bit index range")
    if out.numel() == 0:
        return out
    if Tp == 0:
        return out.zero_()
    from repro_torch.kernels import build
    lib = build.load("pe_conv_grad")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_pe_conv_grad_1d(x.data_ptr(), dy.data_ptr(),
                                       out.data_ptr(), B, C, T, D, Tp, K,
                                       int(x.dtype == torch.bfloat16), stream)
    _raise_on(rc, "pe_conv_grad_1d")
    LAUNCHES["pe_conv_grad_1d"] += 1
    return out


def pe_conv_design(dtype) -> str:
    """The product core ``pe_conv_grad_2d`` runs on the card for
    ``dtype`` inputs: "3xtf32-wgmma" for f32 (three TF32 tensor-core
    products of the split operands a stage, summed in f32), "bf16-wgmma"
    for bf16 (one bf16 product, exact in f32)."""
    if dtype not in _IN_DTYPES:
        raise TypeError(f"pe_conv_design: no kernel for {dtype}")
    return "3xtf32-wgmma" if dtype == torch.float32 else "bf16-wgmma"


PE_TILE_ROWS = (0, 64, 128)


def pe_conv_tile_rule(D: int) -> int:
    """Rows of ``pe_conv_grad_2d``'s output tile by the shape rule of
    ``csrc/pe_conv_grad.cu`` (``tile_rows``): 64 where D leaves at least
    a quarter of the 128-row tiles' rows empty, else 128."""
    pd = _cdiv(D, 128) * 128
    return 64 if 4 * (pd - D) >= pd else 128


def pe_conv_tile_rows(device=None) -> int:
    """The output tile rows ``pe_conv_grad_2d`` runs at on ``device``
    (the one this process would run on by default): the winner of the
    tile sweep in the calibration registered for its hardware
    (``calibrate.harness.sweep_pe_conv_tiles``), else 0, the shape rule.
    Read per call, so registering a calibration mid-process takes
    effect."""
    from repro_torch.calibrate import table
    calib = table.lookup(device)
    if calib is None:
        return 0
    return int(calib.kernels.get("pe_conv_grad", {}).get("tile_rows", 0))


def pe_conv_grad_2d(x, dy, *, KH: int, KW: int, tile_rows=None):
    """x (B, C, H, W) already padded, dy (B, D, H-KH+1, W-KW+1) ->
    (B, D, C, KH, KW) f32, by the design :func:`pe_conv_design` names.
    Stride = dilation = 1, groups = 1.  ``tile_rows`` forces the output
    tile's rows on the card (64 or 128; 0 the shape rule); ``None``
    takes :func:`pe_conv_tile_rows`."""
    if tile_rows is not None and tile_rows not in PE_TILE_ROWS:
        raise ValueError(f"pe_conv_grad_2d: tile_rows {tile_rows!r} not in "
                         f"{PE_TILE_ROWS}")
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
    if Hp * Wp == 0:
        return out.zero_()
    if tile_rows is None:
        tile_rows = pe_conv_tile_rows(x.device)
        if tile_rows not in PE_TILE_ROWS:
            raise ValueError(f"pe_conv_grad_2d: the registered calibration's "
                             f"tile_rows {tile_rows!r} not in {PE_TILE_ROWS}")
    from repro_torch.kernels import build
    lib = build.load("pe_conv_grad")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_pe_conv_grad_2d(x.data_ptr(), dy.data_ptr(),
                                       out.data_ptr(), B, C, H, W, D, Hp, Wp,
                                       KH, KW, int(x.dtype == torch.bfloat16),
                                       tile_rows, stream)
    _raise_on(rc, "pe_conv_grad_2d")
    LAUNCHES["pe_conv_grad_2d"] += 1
    return out


def _as_tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def pe_conv_grad(x, dy, *, kernel_spatial, stride=1, dilation=1, padding=0,
                 groups: int = 1):
    """Kernel path for Algorithm 2.  Plain 1-D and 2-D convs (stride =
    dilation = 1, groups = 1) reach ``pe_conv_grad_1d`` / ``pe_conv_grad_2d``
    after padding x; every other conv takes the grouped-conv lowering
    (``convops`` ``impl="fgc"``, still the paper's algorithm), as in the
    JAX package."""
    from repro_torch.models import convops
    rank = len(kernel_spatial)
    plain = (groups == 1 and _as_tuple(stride, rank) == (1,) * rank
             and _as_tuple(dilation, rank) == (1,) * rank)
    if plain and rank in (1, 2):
        p = _as_tuple(padding, rank)
        if any(p):
            # F.pad pads the last axis first: (W_lo, W_hi, H_lo, H_hi).
            x = F.pad(x, tuple(v for pi in reversed(p) for v in (pi, pi)))
        x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
        if rank == 1:
            return pe_conv_grad_1d(x, dy, K=kernel_spatial[0])
        return pe_conv_grad_2d(x, dy, KH=kernel_spatial[0],
                               KW=kernel_spatial[1])
    return convops.pe_conv_grad(x, dy, kernel_spatial=kernel_spatial,
                                stride=stride, dilation=dilation,
                                padding=padding, groups=groups, impl="fgc")


# ---------------------------------------------------------------------------
# Flash attention (csrc/flash_attn.cu)

_FLASH_HD = (16, 32, 64, 128)   # head dims the kernels are built for
_FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def flash_design(which: str, dtype, hd: int) -> str:
    """The kernel design that a call of ``which`` (one of "flash_fwd",
    "flash_dq", "flash_dkv") takes on the card for ``dtype`` inputs at
    head_dim ``hd``: "wgmma" for bf16 calls at head_dim 64 and 128 (bf16
    tensor cores, swizzled tiles through a cp.async ring), "fma" for
    every other call (f32 FMAs from shared memory: f32 inputs, bf16 at
    head_dim 16 and 32).  ``repro_flash_design`` in ``csrc/flash_attn.cu``
    makes the same choice."""
    if which not in _FLASH_KERNELS:
        raise ValueError(f"flash_design: {which!r} is not one of "
                         f"{_FLASH_KERNELS}")
    if dtype not in _IN_DTYPES:
        raise TypeError(f"flash_design: no kernel for {dtype}")
    if hd not in _FLASH_HD:
        raise NotImplementedError(f"flash_design: head_dim {hd} not in "
                                  f"{_FLASH_HD}")
    return "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "fma"


def _rows16(t):
    """``t`` when each of its (b, t, h) rows starts 16-byte aligned, as the
    wgmma design's 16-byte copies need; else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _strides3(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


class FlashShapeError(ValueError):
    """Sequence/block geometry ``flash_attention`` cannot run: a key
    length that does not divide into key blocks, or query heads that are
    not a multiple of the KV heads (the JAX package's error)."""


def _strides3(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _check_qkv(name: str, q, k, v, do=None):
    """q (and dO) (B, T, H, hd), k and v (B, S, Hkv, hd), one dtype, f32
    or bf16, H a multiple of Hkv."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise FlashShapeError(f"{name}: {H} query heads are not a multiple "
                              f"of {Hkv} kv heads")
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B \
            or k.shape[3] != hd \
            or (do is not None and tuple(do.shape) != tuple(q.shape)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, T, H, hd), "
                         f"(B, S, Hkv, hd)")
    dts = {t.dtype for t in (q, k, v, do) if t is not None}
    if len(dts) != 1 or q.dtype not in _IN_DTYPES:
        raise TypeError(f"{name}: inputs must share f32 or bf16, got "
                        f"{sorted(map(str, dts))}")


def _flash_ready(name: str, *tensors) -> bool:
    """True for CUDA inputs the kernels take, False for CPU inputs;
    raises for anything else."""
    if not _launch_ready(name, *tensors, strided=True):
        return False
    hd = tensors[0].shape[-1]
    if hd not in _FLASH_HD:
        raise NotImplementedError(
            f"{name}: head_dim {hd} not in {_FLASH_HD}, the head dims the "
            f"kernels are built for (ROADMAP.md item 11)")
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: inputs on {t.device} and "
                             f"{tensors[0].device}")
        if max(t.shape[:3]) > _INT_MAX or t.shape[2] > _GRID_YZ_MAX:
            raise ValueError(f"{name}: {tuple(t.shape)} exceeds the "
                             f"kernel's grid")
    if tensors[0].shape[0] > _GRID_YZ_MAX:
        raise ValueError(f"{name}: batch {tensors[0].shape[0]} too large "
                         f"for the grid")
    return True


def flash_fwd(q, k, v, *, causal: bool = True):
    """One forward kernel launch: q (B, T, H, hd), k/v (B, S, Hkv, hd) ->
    (o (B, T, H, hd) in q's dtype, lse (B, H, T) f32), by the design
    :func:`flash_design` names.  No padding and no block contract here:
    see :func:`flash_attention`."""
    _check_qkv("flash_fwd", q, k, v)
    if not _flash_ready("flash_fwd", q, k, v):
        return _ref.flash_fwd_ref(q, k, v, causal=causal)
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if flash_design("flash_fwd", q.dtype, hd) == "wgmma":
        q, k, v = _rows16(q), _rows16(k), _rows16(v)
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    from repro_torch.kernels import build
    lib = build.load("flash_attn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_flash_fwd(
            q.data_ptr(), *_strides3(q), k.data_ptr(), *_strides3(k),
            v.data_ptr(), *_strides3(v), o.data_ptr(), lse.data_ptr(),
            B, T, S, H, Hkv, hd, int(causal),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _flash_bwd(which: int, q, k, v, do, lse, delta, causal):
    """One launch of the dq (``which`` 1) or dk/dv (2) kernel."""
    name = "flash_dq" if which == 1 else "flash_dkv"
    _check_qkv(name, q, k, v, do)
    if not _flash_ready(name, q, k, v, do):
        fn = _ref.flash_dq_ref if which == 1 else _ref.flash_dkv_ref
        return fn(q, k, v, do, lse, delta, causal=causal)
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != (B, H, T) or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous (B, H, T) "
                             f"f32 tensor on {dev}")
    if flash_design(name, q.dtype, hd) == "wgmma":
        q, k, v, do = _rows16(q), _rows16(k), _rows16(v), _rows16(do)
    dq = dk = dv = None
    if which == 1:
        dq = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
    else:
        dk = torch.empty((B, S, Hkv, hd), dtype=k.dtype, device=dev)
        dv = torch.empty((B, S, Hkv, hd), dtype=v.dtype, device=dev)
    from repro_torch.kernels import build
    lib = build.load("flash_attn")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_flash_bwd(
            which, q.data_ptr(), *_strides3(q), k.data_ptr(), *_strides3(k),
            v.data_ptr(), *_strides3(v), do.data_ptr(), *_strides3(do),
            lse.data_ptr(), delta.data_ptr(),
            None if dq is None else dq.data_ptr(),
            None if dk is None else dk.data_ptr(),
            None if dv is None else dv.data_ptr(),
            B, T, S, H, Hkv, hd, int(causal),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dq if which == 1 else (dk, dv)


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True):
    """One dq kernel launch -> dq (B, T, H, hd), from the forward's lse and
    Δ = :func:`flash_delta` (both (B, H, T) f32)."""
    return _flash_bwd(1, q, k, v, do, lse, delta, causal)


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """One dk/dv kernel launch -> (dk, dv), each (B, S, Hkv, hd), summed
    over the rep query heads of each KV head, by the design
    :func:`flash_design` names."""
    return _flash_bwd(2, q, k, v, do, lse, delta, causal)


flash_delta = _ref.flash_delta


class _Flash(torch.autograd.Function):
    """The kernels under autograd: the forward saves (q, k, v, o, lse);
    the backward forms Δ once and launches dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = flash_delta(o, do)
        dq = flash_dq(q, k, v, do, lse, delta, causal=ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 512,
                    bk: int = 512):
    """q (B, T, H, hd); k, v (B, S, Hkv, hd) with H % Hkv == 0 ->
    (B, T, H, hd), differentiable.

    The JAX wrapper's contract: ``bq, bk = min(bq, T), min(bk, S)``;
    query lengths that do not divide ``bq`` are zero-padded and sliced
    back (padded rows are dead); a key length that does not divide ``bk``
    raises :class:`FlashShapeError` (padding keys would corrupt every
    real row's softmax normalizer).  The kernels' own tiles (64) are
    independent of ``bq`` / ``bk``."""
    _check_qkv("flash_attention", q, k, v)
    T, S = q.shape[1], k.shape[1]
    bq, bk = min(bq, T), min(bk, S)
    if S % bk:
        raise FlashShapeError(
            f"flash_attention: key length S={S} does not divide into key "
            f"blocks of bk={bk}; pass a bk dividing S (zero-padding keys "
            f"would corrupt the softmax normalizer)")
    pad = -T % bq
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    if q.device.type == "meta":
        out = torch.empty(q.shape, dtype=q.dtype, device="meta")
    else:
        out = _Flash.apply(q, k, v, causal)
    return out[:, :T] if pad else out
