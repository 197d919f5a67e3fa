"""Microbenchmark harness: measure the constants the planner uses, on the
device it plans for (the JAX package's ``repro.calibrate.harness``, for
one device).

One :func:`measure` run produces a
:class:`~repro_torch.calibrate.table.Calibration` for the device:

  * dense f32 matmul FLOP rate, TF32 off (the precision the training
    step runs at, ``launch.train.deterministic_step``) — the unit every
    other cost converts into.  On the card at n = 8192 (three 256 MiB
    operands): the reference's n = 1024 is 2.1 GFLOP, tens of
    microseconds of work there;
  * HBM streaming bandwidth: one read and one write of a 1 GiB f32
    array on the card, far beyond its 50 MB L2 (the reference's 32 MB
    would stream from the L2);
  * on the card only, the kernel sweeps: ``pe_conv_grad_2d``'s output
    tile (the shape rule, 64 rows, 128 rows) over AlexNet's conv1–4 and
    VGG16's conv0, conv1, conv7 and conv12 at B = 4 (the winner feeds
    :func:`repro_torch.kernels.ops.pe_conv_tile_rows`), and
    ``gram_norm_fused``'s time.

On the card every time is the least of a few runs between CUDA events
after a warm-up; on the CPU (``device="cpu"``, the tests) the host clock,
with ``kernels`` left empty: the plain versions there are no tile sweep.
``quick`` takes small sizes (the matmul at n = 256, a 4 MiB stream, which
the card's L2 holds).  Collective bandwidth needs a mesh (ROADMAP.md
item 14).
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.calibrate.table import (Calibration, _no_mesh,
                                         hardware_signature)
from repro_torch.device import resolve_device

# Matmul sizes (n of n x n f32 operands) and stream sizes (bytes).
FLOP_N = {"cuda": 8192, "cpu": 1024}
FLOP_N_QUICK = 256
STREAM_BYTES = {"cuda": 1 << 30, "cpu": 32 << 20}
STREAM_BYTES_QUICK = 4 << 20
# pe_conv_grad_2d's tile sweep: (name, C, H padded, D, K) at 256 px.
PE_TILE_SHAPES = [
    ("alexnet_conv1", 64, 35, 192, 5), ("alexnet_conv2", 192, 17, 384, 3),
    ("alexnet_conv3", 384, 17, 256, 3), ("alexnet_conv4", 256, 17, 256, 3),
    ("vgg16_conv0", 3, 258, 64, 3), ("vgg16_conv1", 64, 258, 64, 3),
    ("vgg16_conv7", 256, 34, 512, 3), ("vgg16_conv12", 512, 18, 512, 3)]
PE_TILE_BATCH = 4
PE_TILE_BATCH_QUICK = 1
# Candidates: 0 is the shape rule (ops.pe_conv_tile_rule), first so that
# it wins a tie.
PE_TILE_CANDIDATES = (0, 64, 128)


def _time(fn, *, device, iters: int = 3, warmup: int = 1) -> float:
    """Least seconds of ``fn()`` over ``iters`` runs after ``warmup``:
    between CUDA events on the card, by the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(iters):
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls in f32 (TF32 off), as the training step runs them."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32 = prev


def measure_flops_per_second(*, quick: bool = False,
                             device="cuda") -> float:
    """Dense f32 matmul throughput, TF32 off (the cost model's FLOP
    unit)."""
    dev = resolve_device(device)
    n = FLOP_N_QUICK if quick else FLOP_N.get(dev.type, FLOP_N["cpu"])
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, n, generator=g, device=dev)
    b = torch.randn(n, n, generator=g, device=dev)
    out = torch.empty(n, n, device=dev)
    with _full_f32():
        t = _time(lambda: torch.mm(a, b, out=out), device=dev,
                  iters=2 if quick else 4)
    return 2.0 * n ** 3 / max(t, 1e-9)


def measure_hbm_bytes_per_second(*, quick: bool = False,
                                 device="cuda") -> float:
    """Streaming read+write bandwidth over an array far beyond cache
    (``quick``: one the card's L2 holds)."""
    dev = resolve_device(device)
    nbytes = (STREAM_BYTES_QUICK if quick
              else STREAM_BYTES.get(dev.type, STREAM_BYTES["cpu"]))
    x = torch.ones(nbytes // 4, device=dev)
    y = torch.empty_like(x)
    t = _time(lambda: torch.mul(x, 1.0000001, out=y), device=dev,
              iters=2 if quick else 5)
    return 2.0 * nbytes / max(t, 1e-9)


def measure_collective_bytes_per_second(axis: str, size: int, **_) -> float:
    """Ring all-reduce wire bandwidth over a mesh axis: one device has
    none to measure."""
    raise NotImplementedError(
        f"collective bandwidth of mesh axis {axis}:{size} comes with "
        f"sharding (ROADMAP.md item 14)")


def _need_card(dev, what: str):
    if dev.type != "cuda":
        raise ValueError(
            f"{what} times the port's CUDA kernels; on {dev} the wrappers "
            f"take their plain versions, which are no kernel sweep (pass "
            f"kernels=False)")


def sweep_pe_conv_tiles(*, quick: bool = False, device="cuda") -> dict:
    """Time ``pe_conv_grad_2d`` under each candidate output tile (0: the
    shape rule; 64 or 128 rows forced) over PE_TILE_SHAPES and report the
    candidate with the least total.  The rule resolves to 64 or 128 rows
    at each shape, so it shares that candidate's time there (as budgets
    that resolve to one tile share a time in the reference's sweep)."""
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    _need_card(dev, "the pe_conv_grad_2d tile sweep")
    B = PE_TILE_BATCH_QUICK if quick else PE_TILE_BATCH
    g = torch.Generator(device=dev).manual_seed(0)
    by_shape: dict[str, dict] = {}
    for name, C, H, D, K in PE_TILE_SHAPES:
        Hp = H - K + 1
        x = torch.randn(B, C, H, H, generator=g, device=dev)
        dy = torch.randn(B, D, Hp, Hp, generator=g, device=dev)
        t = {rows: _time(lambda r=rows: ops.pe_conv_grad_2d(
            x, dy, KH=K, KW=K, tile_rows=r), device=dev,
            iters=2 if quick else 5)
            for rows in sorted({ops.pe_conv_tile_rule(D) if c == 0 else c
                                for c in PE_TILE_CANDIDATES})}
        rule = ops.pe_conv_tile_rule(D)
        by_shape[name] = {str(c): t[rule if c == 0 else c]
                          for c in PE_TILE_CANDIDATES}
        by_shape[name]["rule_rows"] = rule
        del x, dy
    sweep = {str(c): {"seconds": sum(s[str(c)] for s in by_shape.values())}
             for c in PE_TILE_CANDIDATES}
    winner = min(PE_TILE_CANDIDATES, key=lambda c: sweep[str(c)]["seconds"])
    return {"tile_rows": int(winner), "sweep": sweep, "by_shape": by_shape,
            "batch": B, "shapes": [list(s) for s in PE_TILE_SHAPES]}


def time_gram_norm_fused(*, quick: bool = False, device="cuda") -> dict:
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    _need_card(dev, "timing gram_norm_fused")
    B, T, Dm = (2, 64, 32) if quick else (4, 256, 128)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, T, Dm, generator=g, device=dev)
    dy = torch.randn(B, T, Dm, generator=g, device=dev)
    w = torch.rand(B, generator=g, device=dev)
    t = _time(lambda: ops.gram_norm_fused(x, dy, w), device=dev,
              iters=2 if quick else 3)
    return {"seconds": t, "shape": [B, T, Dm]}


def measure(mesh=None, *, quick: bool = False, kernels: bool | None = None,
            device="cuda") -> Calibration:
    """Run the harness on ``device`` and return the resulting
    :class:`Calibration` (not registered — callers decide; see
    :func:`repro_torch.calibrate.get_or_measure`).  ``kernels=None``
    sweeps the kernels on the card and leaves them out on the CPU;
    ``kernels=True`` on the CPU raises."""
    axes = _no_mesh(mesh)
    dev = resolve_device(device)
    if kernels is None:
        kernels = dev.type == "cuda"
    kern = {}
    if kernels:
        kern["pe_conv_grad"] = sweep_pe_conv_tiles(quick=quick, device=dev)
        kern["gram_norm_fused"] = time_gram_norm_fused(quick=quick,
                                                       device=dev)
    return Calibration(
        hardware=hardware_signature(dev), mesh=axes,
        flops_per_second=measure_flops_per_second(quick=quick, device=dev),
        hbm_bytes_per_second=measure_hbm_bytes_per_second(quick=quick,
                                                          device=dev),
        kernels=kern, measured_at=time.time(), source="measured")
