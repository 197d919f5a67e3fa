#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero and prints no ``ok`` line):

1. environment: torch / CUDA versions, the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN (f32 parity);
2. build: every kernel under ``src/repro_torch/kernels/csrc`` with nvcc
   (in parallel, at first use, into ``build/``);
3. kernels against their plain PyTorch versions at the shapes the main
   path gives them (AlexNet, 256 px, B = 32), plus a ragged and a bf16
   case: max error, kernel / plain / library time, and the bound
   (``gram_norm_fused`` on the transposed im2col views the conv path
   hands it, and once on a contiguous copy for comparison);
4. small parity: a toy CNN's clipped gradients on the card (kernels) equal
   the port on the CPU (plain versions; the CPU tests hold those against
   the JAX package), under crb / ghost / bk and the planned stale step;
5. main path: ``PrivacyEngine.private_step`` on full-width AlexNet
   (1000 classes, ~74.7 M params), 3 steps each of crb / ghost / bk with the
   kernel knobs and of the planned step (``strategy="auto"``) under flat
   and stale clipping, σ = 1; launch counts are reset before and read
   after each step, and one more step runs under ``torch.profiler``
   (device busy share, top kernels).  The stale lane's first step is the
   flat bootstrap; each later step must launch ``gram_norm_fused`` once
   per fused layer (conv2-4).  Then, on one batch at σ = 0, the
   ghost(kernel) norms must equal the crb(grouped-conv) norms, the
   crb(kernel) clipped sum the crb(grouped-conv) one, the fused stale
   step the unfused one on the same lagged norms, and two fused stale
   steps must be bitwise equal.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): f32 outside the
# tensor cores, bf16 on them, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# A bf16 case feeds bf16 inputs, but every kernel and its plain version do
# their arithmetic in f32, so it is held to the f32 tolerance: a kernel
# that multiplied or accumulated in bf16 fails it.
RTOL = {"float32": 1e-4, "bfloat16": 1e-4}

B = 32
IMG = 256
# (name, C, H padded, D, K) of AlexNet's plain convs conv1..conv4 at 256 px.
PE_CASES = [("conv1", 64, 35, 192, 5), ("conv2", 192, 17, 384, 3),
            ("conv3", 384, 17, 256, 3), ("conv4", 256, 17, 256, 3)]
# (name, T, Di, Do) of every layer's Gram: conv im2col, then fc (T = 1).
GRAM_CASES = [("conv0", 3969, 363, 64), ("conv1", 961, 1600, 192),
              ("conv2", 225, 1728, 384), ("conv3", 225, 3456, 256),
              ("conv4", 225, 2304, 256), ("fc0", 1, 12544, 4096),
              ("fc1", 1, 4096, 4096), ("fc2", 1, 4096, 1000)]
# The layers a stale plan fuses on full-width AlexNet at B = 32.
FUSED_CASES = GRAM_CASES[2:5]


class SmokeFailure(Exception):
    pass


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters):
    """Mean ms of ``fn`` over ``iters`` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def compare(torch, got, want, dtype, floor=1e-3):
    """Max abs error, and whether every entry is within rtol of the
    plain version (relative to the entry, with an absolute floor of
    rtol · floor times the largest entry for entries near zero)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    rtol = RTOL[dtype]
    ok = bool((err <= rtol * want.abs() + rtol * floor * scale).all())
    return err.max().item(), err.max().item() / max(scale, 1e-30), ok


def kernel_cases(torch):
    """Phase 3: every kernel against its plain version."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import convops
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    pe_cases = [(n, 32, c, h, d, k, "float32", True)
                for n, c, h, d, k in PE_CASES]
    pe_cases += [("ragged", 3, 5, 13, 70, 3, "float32", False),
                 ("conv2_bf16", 32, 192, 17, 384, 3, "bfloat16", False)]
    for name, b, c, h, d, k, dt, main in pe_cases:
        tdt = getattr(torch, dt)
        hp = h - k + 1
        x, dy = rnd(b, c, h, h, dtype=tdt), rnd(b, d, hp, hp, dtype=tdt)
        got = ops.pe_conv_grad_2d(x, dy, KH=k, KW=k)
        torch.cuda.synchronize()
        want = ref.pe_conv_grad_2d_ref(x, dy, k, k)
        abs_err, rel_err, ok = compare(torch, got, want, dt)
        del got, want
        flops = 2 * b * d * c * k * k * hp * hp
        nbytes = (x.numel() + dy.numel()) * x.element_size() \
            + b * d * c * k * k * 4
        b_ms, b_by = bound(flops, nbytes, dt)
        row = {"kernel": "pe_conv_grad_2d", "case": name, "dtype": dt,
               "shape": {"B": b, "C": c, "H": h, "D": d, "K": k},
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "rtol": RTOL[dt], "ok": ok,
               "kernel_ms": cuda_ms(torch, lambda: ops.pe_conv_grad_2d(
                   x, dy, KH=k, KW=k), 10),
               "plain_ms": cuda_ms(torch, lambda: ref.pe_conv_grad_2d_ref(
                   x, dy, k, k), 3),
               "library_ms": cuda_ms(torch, lambda: convops.pe_conv_grad(
                   x, dy, kernel_spatial=(k, k), impl="fgc"), 3),
               "library": "F.conv3d grouped-conv lowering (fgc)",
               "bound_ms": b_ms, "bound_by": b_by, "main_path": main}
        rows.append(row)
        log(row)
        del x, dy

    gram_cases = [(n, 32, t, di, do, "float32", True)
                  for n, t, di, do in GRAM_CASES]
    gram_cases += [("ragged", 3, 100, 70, 33, "float32", False),
                   ("conv2_bf16", 32, 225, 1728, 384, "bfloat16", False)]
    for name, b, t, di, do, dt, main in gram_cases:
        tdt = getattr(torch, dt)
        x, dy = rnd(b, t, di, dtype=tdt), rnd(b, t, do, dtype=tdt)
        got = ops.gram_norm(x, dy, has_bias=True)
        torch.cuda.synchronize()
        want = ref.gram_norm_ref(x, dy, has_bias=True)
        abs_err, rel_err, ok = compare(torch, got, want, dt)

        def library():
            pe = torch.bmm(x.transpose(1, 2).float(), dy.float())
            return pe.square().sum((1, 2)) + dy.float().sum(1).square().sum(1)

        # ‖δy_bᵀx_b‖²_F needs the cheaper of its two contractions: the
        # Grams (2·T²·(Di+Do) per example, the kernel's route) or the
        # direct product δy_bᵀx_b (2·T·Di·Do), which is far less at
        # conv0 and conv1.
        flops = 2 * b * t * min(t * (di + do), di * do)
        nbytes = (x.numel() + dy.numel()) * x.element_size() + b * 4
        b_ms, b_by = bound(flops, nbytes, dt)
        row = {"kernel": "gram_norm", "case": name, "dtype": dt,
               "shape": {"B": b, "T": t, "Di": di, "Do": do},
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "rtol": RTOL[dt], "ok": ok,
               "kernel_ms": cuda_ms(torch, lambda: ops.gram_norm(
                   x, dy, has_bias=True), 5),
               "plain_ms": cuda_ms(torch, lambda: ref.gram_norm_ref(
                   x, dy, has_bias=True), 3),
               "library_ms": cuda_ms(torch, library, 3),
               "library": "bmm materialize + square-sum (several calls)",
               "bound_ms": b_ms, "bound_by": b_by, "main_path": main}
        rows.append(row)
        log(row)
        del x, dy, got, want
        torch.cuda.empty_cache()
    rows += fused_cases(torch, rnd)
    bad = [f"{r['kernel']}@{r['case']}" for r in rows if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return rows


def fused_cases(torch, rnd):
    """``gram_norm_fused`` at conv2-4 as the conv path hands it over
    (transposed views of the (B, C·K, T) patches and (B, D, T)
    cotangents, read in place), conv3 once more on contiguous copies, a
    ragged and a bf16 case."""
    from repro_torch.kernels import ops, ref
    cases = [(n, 32, t, di, do, "float32", True)
             for n, t, di, do in FUSED_CASES]
    cases += [("conv3_contiguous", 32, 225, 3456, 256, "float32", False),
              ("ragged", 3, 100, 70, 33, "float32", False),
              ("conv2_bf16", 32, 225, 1728, 384, "bfloat16", False)]
    rows = []
    for name, b, t, di, do, dt, main in cases:
        tdt = getattr(torch, dt)
        x = rnd(b, di, t, dtype=tdt).transpose(1, 2)
        dy = rnd(b, do, t, dtype=tdt).transpose(1, 2)
        copy_ms = None
        if name == "conv3_contiguous":
            # What a wrapper that copied the views would add first.
            xv, dyv = x, dy
            copy_ms = cuda_ms(torch, lambda: (xv.contiguous(),
                                              dyv.contiguous()), 3)
            x, dy = x.contiguous(), dy.contiguous()
        w = torch.rand(b, device="cuda")
        got = ops.gram_norm_fused(x, dy, w, has_bias=True)
        torch.cuda.synchronize()
        want = ref.gram_norm_fused_ref(x, dy, w, has_bias=True)
        # The norms are sums of squares; the contributions are signed sums
        # over B·T terms whose entries can cancel to near zero, so their
        # error is held against rtol times the largest entry.
        errs = [compare(torch, a, c, dt, floor=f)
                for a, c, f in zip(got, want, (1e-3, 1.0, 1.0))]
        del got, want

        def library():
            pe = torch.bmm(x.transpose(1, 2).float(), dy.float())
            sb = dy.float().sum(1)
            return (pe.square().sum((1, 2)) + sb.square().sum(1),
                    torch.einsum("b,bio->io", w, pe),
                    torch.einsum("b,bo->o", w, sb))

        # Both outputs need the per-example products x_bᵀδy_b.
        flops = 2 * b * t * di * do
        nbytes = (x.numel() + dy.numel()) * x.element_size() \
            + (2 * b + di * do + do) * 4
        b_ms, b_by = bound(flops, nbytes, dt)
        row = {"kernel": "gram_norm_fused", "case": name, "dtype": dt,
               "shape": {"B": b, "T": t, "Di": di, "Do": do},
               "layout": "contiguous" if x.is_contiguous() else
               "strided views",
               "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "rtol": RTOL[dt], "ok": all(e[2] for e in errs),
               "kernel_ms": cuda_ms(torch, lambda: ops.gram_norm_fused(
                   x, dy, w, has_bias=True), 5),
               "plain_ms": cuda_ms(torch, lambda: ref.gram_norm_fused_ref(
                   x, dy, w, has_bias=True), 3),
               "library_ms": cuda_ms(torch, library, 3),
               "library": "bmm materialize + square-sum + einsum with w",
               "bound_ms": b_ms, "bound_by": b_by, "main_path": main}
        if copy_ms is not None:
            row["copy_ms"] = copy_ms
        rows.append(row)
        log(row)
        del x, dy
        torch.cuda.empty_cache()
    return rows


def tree_close(torch, got, want, rtol, atol, what):
    for k in want:
        if isinstance(want[k], dict):
            tree_close(torch, got[k], want[k], rtol, atol, f"{what}/{k}")
        else:
            a, b = got[k].float().cpu(), want[k].float().cpu()
            check(torch.allclose(a, b, rtol=rtol, atol=atol),
                  f"{what}/{k}: max diff {(a - b).abs().max().item():.3e}")


def small_parity(torch):
    """Phase 4: the toy CNN's clipped sums on the card equal the CPU's."""
    from repro_torch.core import ClipPolicy, clipped_grad_sum
    from repro_torch.models.cnn import CNN, toy_cnn_config
    from repro_torch.tree import tree_map
    m = CNN(toy_cnn_config(4, 2.0, c0=16, img=32))
    params, _ = m.init(3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"img": torch.randn(4, 3, 32, 32, generator=gen),
             "label": torch.randint(0, 10, (4,), generator=gen)}
    knobs = dict(norm_method="pallas", conv_impl="pallas",
                 conv_norm="pallas")
    for strategy in ("crb", "ghost", "bk"):
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), params)
            bt = {k: v.to(dev) for k, v in batch.items()}
            out[dev] = clipped_grad_sum(m.apply, p, bt, l2_clip=1.0,
                                        strategy=strategy, **knobs)
        check(torch.allclose(out["cuda"][0].cpu(), out["cpu"][0],
                             rtol=1e-5), f"toy {strategy}: losses differ")
        check(torch.allclose(out["cuda"][2].cpu(), out["cpu"][2],
                             rtol=1e-4), f"toy {strategy}: norms differ")
        tree_close(torch, out["cuda"][1], out["cpu"][1], 1e-4, 1e-6,
                   f"toy {strategy} clipped sum")
    # The planned stale step with the kernel knobs fuses every layer
    # (gram_norm_fused on each conv and dense layer), from the same
    # lagged norms on both devices.
    prev = out["cpu"][2]
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), params)
        bt = {k: v.to(dev) for k, v in batch.items()}
        out[dev] = clipped_grad_sum(
            m.apply, p, bt, l2_clip=1.0, strategy="auto",
            clip_policy=ClipPolicy(mode="stale"), prev_norms_sq=prev.to(dev),
            **knobs)
    check(torch.allclose(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-4),
          "toy auto stale: norms differ")
    tree_close(torch, out["cuda"][1], out["cpu"][1], 1e-4, 1e-6,
               "toy auto stale clipped sum")
    log({"phase": "small_parity", "ok": True,
         "strategies": ["crb", "ghost", "bk", "auto stale"]})


def main_path(torch):
    """Phase 5: full-width AlexNet DP-SGD steps through the engine."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import (ClipPolicy, DPConfig, NormCfg,
                                  PrivacyEngine, clipped_grad_sum)
    from repro_torch.data import SyntheticImageDataset
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import CNN
    from repro_torch.optim import adamw_init

    cfg = get_config("alexnet")
    check(cfg.img_size == IMG and cfg.n_classes == 1000, "alexnet config")
    model = CNN(cfg)
    params, _ = model.init(0, device="cuda")
    n_params = sum(v.numel() for layer in params.values()
                   for v in layer.values())
    t0 = time.perf_counter()
    n_examples = 4096
    ds = SyntheticImageDataset(IMG, 1000, n_examples=n_examples, seed=0)
    batches = []
    for s in range(5):
        b = ds.batch(range(s * B, (s + 1) * B))
        batches.append({"img": torch.from_numpy(b["img"]).cuda(),
                        "label": torch.from_numpy(
                            b["label"].astype(np.int64)).cuda()})
    log({"phase": "main_path_setup", "arch": "alexnet", "img": IMG,
         "classes": 1000, "params": n_params, "batch": B,
         "data_s": time.perf_counter() - t0})

    auto = NormCfg(conv_impl="pallas")
    # (lane, strategy, clipping, norm knobs, kernels each step launches:
    # a count per step, or None for "at least once")
    runs = [("crb", "crb", "flat", NormCfg(conv_impl="pallas"),
             {"pe_conv_grad_2d": None}),
            ("ghost", "ghost", "flat", NormCfg(dense="pallas", conv="pallas"),
             {"gram_norm": None}),
            ("bk", "bk", "flat", NormCfg(dense="pallas", conv="pallas",
                                         conv_impl="pallas"),
             {"gram_norm": None}),
            ("auto_flat", "auto", "flat", auto, {"pe_conv_grad_2d": None}),
            ("auto_stale", "auto", "stale", auto,
             {"pe_conv_grad_2d": None, "gram_norm_fused": len(FUSED_CASES)})]
    launches = {k: 0 for k in ops.LAUNCHES}
    steps = 3
    for lane, strategy, clipping, norm, needs in runs:
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy=strategy,
                      norm=norm, clipping=clipping)
        eng = PrivacyEngine(model.apply, params, batches[0], dp,
                            optimizer="adamw", lr=1e-3, run_seed=0,
                            sampling_rate=B / n_examples, device="cuda")
        plan = eng.explain() if strategy == "auto" else None
        p, opt = params, adamw_init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses, per_step = [], [], []
        for s in range(steps):
            ops.reset_launches()
            t = time.perf_counter()
            p, opt, loss, aux = eng.private_step(p, opt, batches[s], step=s)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            per_step.append(dict(ops.LAUNCHES))
            losses.append(float(loss))
        counts = {k: sum(c[k] for c in per_step) for k in ops.LAUNCHES}
        for k, v in counts.items():
            launches[k] += v
        prof = profile_step(torch, lambda: eng.private_step(
            p, opt, batches[steps], step=steps))
        check(all(math.isfinite(v) for v in losses),
              f"{lane}: non-finite loss {losses}")
        for k, n in needs.items():
            check(counts[k] > 0, f"{lane}: kernel {k} never launched")
            if n is not None:
                # The stale lane's step 0 is the flat bootstrap (no fused
                # pass); every later step fuses each planned layer once.
                got = [c[k] for c in per_step]
                check(got == [0] + [n] * (steps - 1),
                      f"{lane}: {k} launches per step {got}, expected "
                      f"0 then {n}")
        log({"phase": "main_path", "lane": lane, "strategy": strategy,
             "clipping": clipping, "norm": dataclass_dict(norm),
             "plan": plan, "losses": losses,
             "step_ms": step_ms, "step_ms_after_first": step_ms[1:],
             "launches": counts, "launches_each_step": per_step,
             "launches_per_step": {k: v / steps for k, v in counts.items()},
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "profiled_step": prof,
             "clip_fraction": float(aux["clip_fraction"]),
             "report": eng.report()})
        del p, opt, eng

    # Kernel realizations against the grouped-conv (library) route on one
    # batch at σ = 0: norms and clipped sums (f32 sums in another order).
    b = batches[4]
    timed = {}

    def run(name, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = clipped_grad_sum(model.apply, params, b, l2_clip=1.0, **kw)
        torch.cuda.synchronize()
        timed[name] = (time.perf_counter() - t) * 1e3
        return out

    _, sum_fgc, n_fgc = run("crb_fgc", strategy="crb", conv_impl="fgc")
    _, sum_k, n_k = run("crb_kernel", strategy="crb", conv_impl="pallas")
    tree_close(torch, sum_k, sum_fgc, 1e-4, 1e-6,
               "crb(kernel) vs crb(fgc) clipped sum")
    del sum_k
    check(torch.allclose(n_k, n_fgc, rtol=1e-4), "crb norms differ")
    _, _, n_ghost = run("ghost_kernel", strategy="ghost",
                        norm_method="pallas", conv_norm="pallas")
    rel = ((n_ghost - n_fgc).abs() / n_fgc).max().item()
    check(rel <= 1e-4, f"ghost(kernel) vs crb(fgc) norms: rel {rel:.3e}")

    # The stale step on the same lagged norms (this batch's own): fused
    # (gram_norm_fused) equals unfused (Gram norm + conv weight gradient),
    # and two fused runs are bitwise equal.  cuDNN may pick backward
    # algorithms that sum in a varying order, so it is held to
    # deterministic ones here (the lanes above were timed without).
    torch.backends.cudnn.deterministic = True

    def stale(name, fused):
        return run(name, strategy="auto", conv_impl="pallas",
                   clip_policy=ClipPolicy(mode="stale", fused=fused),
                   prev_norms_sq=n_fgc)

    _, sum_f1, n_f1 = stale("stale_fused", True)
    _, sum_f2, n_f2 = stale("stale_fused_again", True)
    _, sum_u, n_u = stale("stale_unfused", False)
    check(torch.allclose(n_f1, n_u, rtol=1e-4, atol=1e-6),
          "stale fused vs unfused norms differ")
    tree_close(torch, sum_f1, sum_u, 1e-4, 1e-6,
               "stale fused vs unfused clipped sum")
    check(torch.equal(n_f1, n_f2), "two fused stale runs: norms differ")
    for k in sum_f1:
        for leaf in sum_f1[k]:
            check(torch.equal(sum_f1[k][leaf], sum_f2[k][leaf]),
                  f"two fused stale runs differ at {k}/{leaf}")
    log({"phase": "main_path_checks", "ok": True,
         "ghost_vs_crb_fgc_norm_max_rel": rel,
         "stale_fused_vs_unfused_norm_max_rel":
             ((n_f1 - n_u).abs() / n_u).max().item(),
         "stale_fused_bitwise_repeatable": True,
         "call_ms_one_batch": timed})
    return launches


def profile_step(torch, fn, top=8):
    """One step under ``torch.profiler``: wall ms, summed CUDA kernel ms,
    the device's busy share (kernel ms / wall ms, one stream) and the
    kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    kernels.sort(key=lambda k: -k[1])
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top": [{"kernel": name[:90], "ms": ms, "calls": n}
                    for name, ms, n in kernels[:top]]}


def dataclass_dict(obj):
    import dataclasses
    return dataclasses.asdict(obj)


def summarize(rows, launches):
    """One entry per kernel: sums over the main path's shapes (one step's
    worth of each kernel's calls), errors over every case."""
    meta = {
        "pe_conv_grad_2d": ("src/repro_torch/kernels/csrc/pe_conv_grad.cu",
                            "src/repro/kernels/pe_conv_grad.py:72"),
        "gram_norm": ("src/repro_torch/kernels/csrc/gram_norm.cu",
                      "src/repro/kernels/gram_norm.py:78"),
        "gram_norm_fused": ("src/repro_torch/kernels/csrc/gram_norm.cu",
                            "src/repro/kernels/gram_norm.py:145"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = [r for r in mine if r["main_path"]]
        t_ops = sum(r["bound_ms"] for r in main if r["bound_by"] ==
                    "operations")
        t_bytes = sum(r["bound_ms"] for r in main if r["bound_by"] ==
                      "bytes")
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            "ms": sum(r["kernel_ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": t_ops + t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in main),
            "cases": [r["case"] for r in main]})
    return out


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure("src/repro_torch is missing: run chip_smoke.py "
                           "from the root of a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    smi = nvidia_smi_line()
    log({"phase": "env", "python": sys.version.split()[0],
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    info = build.build_all()
    regs = {stem: [ln.split("info    : ")[-1] for ln in text.splitlines()
                   if "registers" in ln]
            for stem, text in info["ptxas"].items()}
    log({"phase": "build", "seconds": info["seconds"],
         "built": info["built"], "ptxas": regs})

    t = time.perf_counter()
    rows = kernel_cases(torch)
    log({"phase": "kernels_done", "seconds": time.perf_counter() - t})
    small_parity(torch)
    t = time.perf_counter()
    launches = main_path(torch)
    log({"phase": "main_path_done", "seconds": time.perf_counter() - t})

    log(nvidia_smi_line())
    log({"kernels": summarize(rows, launches)})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
