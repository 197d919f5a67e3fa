#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero and prints no ``ok`` line):

1. environment: torch / CUDA versions, the card's name and power limit;
   TF32 is switched off for matmuls and cuDNN (f32 parity);
2. build: every kernel under ``src/repro_torch/kernels/csrc`` with nvcc
   (in parallel, at first use, into ``build/``); ptxas's registers and
   spills per kernel;
3. kernels against their plain PyTorch versions at the shapes the main
   path gives them (AlexNet, 256 px, B = 32; Llama-3.2-1B, B = 8,
   T = 1024), plus ragged and bf16 cases: max error, kernel / plain /
   library time, and the bound (``pe_conv_grad_2d`` on the tensor cores,
   each case twice to show it bitwise repeatable, its design named,
   ``ops.pe_conv_design``; both conv gradients, kernel and plain f32
   version, held to the f32 sum bound of ``kernels/bounds.py`` against an
   f64 product, every other kernel to rtol 1e-4 of its plain version
   (``compare``); ``gram_norm`` and ``gram_norm_fused`` on
   the transposed im2col views the conv path hands them, each twice to
   show it bitwise repeatable, ``gram_norm_fused`` once more on a
   contiguous copy for comparison; each ``gram_norm`` row names its route,
   ``ops.gram_route``; the flash forward, dq and dk/dv at the model's
   (8, 1024, 32, 64) with rep 1 in bf16 and f32, at rep 4, full
   (non-causal) and with a ragged T, each twice to show all three
   bitwise repeatable; each flash row names its design, ``wgmma`` for
   the bf16 calls (forward, dq and dk/dv), ``fma`` for the f32 ones,
   after the library's ``repro_flash_design`` is checked against
   ``ops.flash_design``; where the wgmma design takes the main path's
   call, the fma design is timed on the same inputs as the earlier time;
   each dq row also holds dq + dk/dv beside SDPA's backward; the SDPA
   yardstick is the fastest backend ``sdpa_kernel`` offers);
4. small parity: a toy CNN's clipped gradients on the card (kernels) equal
   the port on the CPU (plain versions; the CPU tests hold those against
   the JAX package), under crb / ghost / bk and the planned stale step;
   and a reduced Llama-3.2-1B's (flash kernels) under bk and ``auto``;
5. main path: ``PrivacyEngine.private_step`` on full-width AlexNet
   (1000 classes, ~74.7 M params), 3 steps each of crb / ghost / bk with the
   kernel knobs and of the planned step (``strategy="auto"``) under flat
   and stale clipping, σ = 1; launch counts are reset before and read
   after each step, and one more step runs under ``torch.profiler``
   (device busy share, top kernels).  ghost and bk must launch
   ``gram_norm`` once a layer (8) each step.  The stale lane's first step
   is the flat bootstrap; each later step must launch ``gram_norm_fused``
   once per fused layer (conv2-4).  Then, on one batch at σ = 0, the
   ghost(kernel) norms must equal the crb(grouped-conv) norms, the
   crb(kernel) clipped sum the crb(grouped-conv) one, the fused stale
   step the unfused one on the same lagged norms, and two fused stale
   steps must be bitwise equal.
6. LM main path: ``PrivacyEngine.private_step`` on full-width
   Llama-3.2-1B (16 layers, d_model 2048, 32/8 heads, vocab 128 256, tied
   embeddings, bf16, ``attn_impl="flash"``; ~1.24 B params), B = 8,
   T = 1024, σ = 1: 3 steps each of bk (the config's strategy) and
   ``auto`` flat, step ms, peak memory and one profiled step each (with
   each flash kernel's device time a launch).  Each step's capture pass
   must launch every flash kernel once per layer (16).
7. ``gram_norm_tokmask`` at its own entry point (no model path calls it,
   as in the JAX package): once on Llama-3.2-1B's embedding cotangent
   shape (B = 8, T = 1024, D = 2048, bf16, the token ids of a synthetic
   batch), checked against ``kinds.embed_norm_sq``'s segment sum.
8. 1-D conv lane: a network of five plain 1-D convs (AlexNet's conv
   widths at stride 1, ReLU, mean over time, a 10-class dense head, f32),
   B = 32, T = 4096, σ = 1: 3 ``private_step``s each of crb and ``auto``
   flat with ``conv_impl="pallas"``; the crb lane must launch
   ``pe_conv_grad_1d`` 5 times each step; then crb(kernel) against
   crb(grouped conv) on one batch at σ = 0.
9. CLI lanes: ``python -m repro_torch.launch.train`` in a process of its
   own, twice per lane, once straight through and once with
   ``--fail-at 3`` (it restarts from its step-1 checkpoint): full-width
   AlexNet ``auto`` flat and stale (B = 32, 6 steps, checkpoint every 2),
   and Llama-3.2-1B at full width and depth 2 (B = 8, T = 1024, bf16,
   flash, ``auto``, 4 steps).  The two runs' last checkpoints (params,
   optimizer state, clip state, ledger) must be bitwise equal.

The kernel cases of phase 3 include ``pe_conv_grad_1d`` (the JAX kernel
test's sweep and the 1-D lane's five layer shapes, f32 and bf16, each
twice to show it bitwise repeatable; per layer its time, its bound (3 x
FLOP at the TF32 rate for f32, the bf16 peak for bf16) and its share of
it, and the bound at the f32 FMA peak its route runs on) and
``gram_norm_tokmask`` (B = 8, T = 1024, D = 2048 in bf16 and f32, random
and heavily repeated ids, a ragged T = 1000; each against the plain
version and the segment sum; each row names its route,
``ops.tokmask_route``).

The line before the last is a JSON object with one entry per kernel
(eight, each with its share of its bound); the last line is
``{"ok": true, "device": {...}}``.
"""
import functools
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): f32 outside the
# tensor cores, TF32 and bf16 on them, and HBM3 bandwidth.  The f32 rows
# of the product-sum kernels (both conv gradients, gram_norm,
# gram_norm_fused) are bounded at 3 x FLOP at the TF32 rate, the least
# an error-compensated (3xTF32) tensor-core sum needs, which the f32 sum
# bound (kernels/bounds.py) admits; each keeps its bound at the f32 FMA
# rate beside it (fma_bound_ms).
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# A bf16 case feeds bf16 inputs, but every kernel and its plain version do
# their arithmetic in f32, so it is held to the f32 tolerance: a kernel
# that multiplied or accumulated in bf16 fails it.  The conv gradients
# are held to the f32 sum bound instead (sum_rule).
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

# Llama-3.2-1B's main-path batch.  gqa_apply repeats K and V to all 32
# query heads before attention (as the JAX package does), so the model
# path runs the flash kernels at rep 1; rep 4 (32 / 8) is checked alone.
LM_B, LM_T, LM_LAYERS = 8, 1024, 16
# (case, B, T, H, Hkv, hd, causal, dtype, on the main path)
FLASH_CASES = [("llama_bf16", LM_B, LM_T, 32, 32, 64, True, "bfloat16", True),
               ("llama_f32", LM_B, LM_T, 32, 32, 64, True, "float32", False),
               ("llama_rep4_bf16", LM_B, LM_T, 32, 8, 64, True, "bfloat16",
                False),
               ("full_f32", 2, 256, 8, 8, 64, False, "float32", False),
               ("ragged_f32", 2, 100, 4, 2, 64, True, "float32", False)]
# The flash kernels' outputs are in the input dtype, so a bf16 output is
# held to bf16's tolerance per entry (one rounding flip is at most 2^-7 of
# the entry) and an f32 output to f32's; entries near zero get an absolute
# floor of 1e-5 of the largest entry.  A bf16 output also gets FLASH_ULPS
# bf16 ulps of its row's RMS (over head_dim): the forward rounds P to bf16
# tile by tile against the running max, the plain version once against the
# row's max, which moves an entry by up to about 2 such ulps.
# tests/test_torch_flash_cuda.py holds this bound against that rounding,
# and against a forward that drops a key tile or is 3 % off on one.
FLASH_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
FLASH_ATOL = 1e-5
FLASH_ULPS = 4
FLASH_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")

# The 1-D conv lane: five plain 1-D convs with AlexNet's conv widths at
# stride 1, (name, C, D, K, padding), B = 32, T = 4096, f32, 10 classes.
C1_B, C1_T, C1_CLASSES = 32, 4096, 10
C1_LAYERS = [("conv0", 3, 64, 11, 5), ("conv1", 64, 192, 5, 2),
             ("conv2", 192, 384, 3, 1), ("conv3", 384, 256, 3, 1),
             ("conv4", 256, 256, 3, 1)]
# pe_conv_grad_1d's sweep in the JAX kernel tests, (B, C, D, T, K).
PE1D_SWEEP = [(2, 5, 6, 20, 3), (1, 3, 8, 33, 5), (4, 2, 2, 9, 2)]
# gram_norm_tokmask at Llama-3.2-1B's embedding cotangent: (case, B, T, D,
# id range, dtype, on its entry path).  A range of 16 repeats every id
# about 64 times per example; the vocabulary's 128 256 leaves almost only
# the diagonal.  The last case is one token past the sort's cap of 16 384
# (ops.tokmask_route), where the masked-Gram route runs.
TOK_CASES = [("llama_bf16", LM_B, LM_T, 2048, 128256, "bfloat16", True),
             ("llama_f32", LM_B, LM_T, 2048, 128256, "float32", False),
             ("repeated_bf16", LM_B, LM_T, 2048, 16, "bfloat16", False),
             ("repeated_f32", LM_B, LM_T, 2048, 16, "float32", False),
             ("ragged_repeated_f32", LM_B, 1000, 2048, 16, "float32", False),
             ("ragged_bf16", LM_B, 1000, 2048, 128256, "bfloat16", False),
             ("past_sort_cap_f32", 1, 16385, 64, 128256, "float32", False)]
# The CLI lanes: (lane, arguments after the module, steps).
CLI_LANES = [
    ("cli_alexnet_auto_flat",
     ["--arch", "alexnet", "--full", "--batch", "32", "--strategy", "auto",
      "--noise", "1.0"], 6),
    ("cli_alexnet_auto_stale",
     ["--arch", "alexnet", "--full", "--batch", "32", "--strategy", "auto",
      "--clip-mode", "stale", "--noise", "1.0"], 6),
    ("cli_llama_depth2_auto",
     ["--arch", "llama3.2-1b", "--full", "--layers", "2", "--batch",
      str(LM_B), "--seq", str(LM_T), "--strategy", "auto", "--attn-impl",
      "flash", "--noise", "1.0"], 4)]
CLI_TIMEOUT_S = 420


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


def ptxas_summary(text):
    """``nvcc -Xptxas -v``'s log as {kernel: "registers, spills"}, each
    kernel named by its function and template arguments."""
    import re
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = part = m.group(1)
            # _Z<length><name>, or _ZN and <length><name> parts (the
            # file's anonymous namespace first): the last part
            i = 3 if mangled.startswith("_ZN") else 2
            while (d := re.match(r"\d+", mangled[i:])):
                i += d.end() + int(d.group(0))
                part = mangled[i - int(d.group(0)):i]
            args = ("bf16" if "bfloat16" in mangled else "f32") + "".join(
                "," + a for a in re.findall(r"L[ib](\d+)E", mangled))
            name = f"{part}<{args}>"
            out[name] = ""
        elif name and "spill" in ln:
            out[name] = ln.strip()
        elif name and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            out[name] = f"{regs.group(1) if regs else '?'} registers; " \
                + out[name]
    return out


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
    """(least ms, "operations" or "bytes"): ``flops`` at the peak of
    ``dtype`` (a key of PEAK_FLOPS) against ``nbytes`` at HBM's rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def product_bound(flops, nbytes, dtype):
    """(least ms, "operations" or "bytes", least ms at the f32 FMA rate) of
    a product-sum kernel: f32 inputs at 3 x ``flops`` at the TF32 rate,
    bf16 inputs at the bf16 rate."""
    fma_ms = bound(flops, nbytes, "float32")[0]
    if dtype == "float32":
        return (*bound(3 * flops, nbytes, "tf32"), fma_ms)
    return (*bound(flops, nbytes, dtype), fma_ms)


def sum_rule(got, plain, fn, x, dy, n):
    """The conv gradients' check (``kernels/bounds.py``): the kernel's and
    the plain f32 version's largest error against the f64 product ``fn``
    of f64 inputs, as multiples of 2^-24·√n·Σ|x|·|δy| over the n terms
    of each sum.  Both must be at most 1: a bound that failed the plain
    version would be wrong.  Returns (kernel's, plain's, ok)."""
    from repro_torch.kernels import bounds
    exact = fn(x.double(), dy.double())
    absprod = fn(x.double().abs(), dy.double().abs())
    k_mult, k_ok = bounds.sum_bound(got, exact, absprod, n)
    p_mult, p_ok = bounds.sum_bound(plain, exact, absprod, n)
    return k_mult, p_mult, k_ok and p_ok


def compare(torch, got, want, dtype, floor=1e-3, rtol=None):
    """Max abs error, and whether every entry is within rtol of the
    plain version (relative to the entry, with an absolute floor of
    rtol · floor times the largest entry for entries near zero)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    rtol = RTOL[dtype] if rtol is None else rtol
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
        again = ops.pe_conv_grad_2d(x, dy, KH=k, KW=k)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        want = ref.pe_conv_grad_2d_ref(x, dy, k, k)
        abs_err, rel_err, _ = compare(torch, got, want, dt)
        mult, plain_mult, rule_ok = sum_rule(
            got, want, lambda a, g_: ref.pe_conv_grad_2d_ref(a, g_, k, k),
            x, dy, hp * hp)
        del got, again, want
        flops = 2 * b * d * c * k * k * hp * hp
        nbytes = (x.numel() + dy.numel()) * x.element_size() \
            + b * d * c * k * k * 4
        b_ms, b_by, fma_ms = product_bound(flops, nbytes, dt)
        k_ms = cuda_ms(torch, lambda: ops.pe_conv_grad_2d(x, dy, KH=k, KW=k),
                       10)
        row = {"kernel": "pe_conv_grad_2d", "case": name, "dtype": dt,
               "shape": {"B": b, "C": c, "H": h, "D": d, "K": k},
               "route": ops.pe_conv_design(tdt),
               "check": "f32 sum bound (kernels/bounds.py), n = H'W'",
               "bound_multiple": mult, "plain_bound_multiple": plain_mult,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "ok": rule_ok and repeat, "bitwise_repeat": repeat,
               "kernel_ms": k_ms, "tflops": flops / k_ms / 1e9,
               "plain_ms": cuda_ms(torch, lambda: ref.pe_conv_grad_2d_ref(
                   x, dy, k, k), 3),
               "library_ms": cuda_ms(torch, lambda: convops.pe_conv_grad(
                   x, dy, kernel_spatial=(k, k), impl="fgc"), 3),
               "library": "F.conv3d grouped-conv lowering (fgc)",
               "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma_ms,
               "bound_share": b_ms / k_ms, "main_path": main}
        rows.append(row)
        log(row)
        del x, dy
        torch.cuda.empty_cache()

    # The conv layers' operands as the conv path hands them over:
    # transposed views of the (B, C·K, T) patches and (B, D, T)
    # cotangents, read in place; the fc layers' (B, 1, F) rows.
    gram_cases = [(n, 32, t, di, do, "float32", True)
                  for n, t, di, do in GRAM_CASES]
    gram_cases += [("ragged", 3, 100, 70, 33, "float32", False),
                   ("conv1_bf16", 32, 961, 1600, 192, "bfloat16", False),
                   ("conv2_bf16", 32, 225, 1728, 384, "bfloat16", False)]
    for name, b, t, di, do, dt, main in gram_cases:
        tdt = getattr(torch, dt)
        if t > 1:
            x = rnd(b, di, t, dtype=tdt).transpose(1, 2)
            dy = rnd(b, do, t, dtype=tdt).transpose(1, 2)
        else:
            x, dy = rnd(b, t, di, dtype=tdt), rnd(b, t, do, dtype=tdt)
        got = ops.gram_norm(x, dy, has_bias=True)
        again = ops.gram_norm(x, dy, has_bias=True)
        torch.cuda.synchronize()
        want = ref.gram_norm_ref(x, dy, has_bias=True)
        abs_err, rel_err, ok = compare(torch, got, want, dt)
        ok = ok and bool(torch.equal(got, again))

        def library():
            pe = torch.bmm(x.transpose(1, 2).float(), dy.float())
            return pe.square().sum((1, 2)) + dy.float().sum(1).square().sum(1)

        # ‖δy_bᵀx_b‖²_F needs the cheaper of its two contractions: the
        # symmetric Gram pair over the token pairs t ≤ t' (T·(T+1)·(Di+Do)
        # per example) or the direct product δy_bᵀx_b (2·T·Di·Do); at
        # T = 1 it is rank-1 and the bytes bound it.
        flops = 2 * b * min(t * (t + 1) * (di + do) // 2, t * di * do)
        nbytes = (x.numel() + dy.numel()) * x.element_size() + b * 4
        b_ms, b_by, fma_ms = product_bound(flops, nbytes, dt)
        row = {"kernel": "gram_norm", "case": name, "dtype": dt,
               "shape": {"B": b, "T": t, "Di": di, "Do": do},
               "route": ops.gram_route(t, di, do),
               "layout": "contiguous" if x.is_contiguous() else
               "strided views",
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "rtol": RTOL[dt], "ok": ok, "bitwise_repeat": ok,
               "kernel_ms": cuda_ms(torch, lambda: ops.gram_norm(
                   x, dy, has_bias=True), 5),
               "plain_ms": cuda_ms(torch, lambda: ref.gram_norm_ref(
                   x, dy, has_bias=True), 3),
               "library_ms": cuda_ms(torch, library, 3),
               "library": "bmm materialize + square-sum (several calls)",
               "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma_ms,
               "main_path": main}
        rows.append(row)
        log(row)
        del x, dy, got, want
        torch.cuda.empty_cache()
    rows += fused_cases(torch, rnd)
    rows += pe1d_cases(torch, rnd)
    rows += tokmask_cases(torch)
    rows += flash_cases(torch, rnd)
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
        again = ops.gram_norm_fused(x, dy, w, has_bias=True)
        torch.cuda.synchronize()
        want = ref.gram_norm_fused_ref(x, dy, w, has_bias=True)
        # The norms are sums of squares; the contributions are signed sums
        # over B·T terms whose entries can cancel to near zero, so their
        # error is held against rtol times the largest entry.
        errs = [compare(torch, a, c, dt, floor=f)
                for a, c, f in zip(got, want, (1e-3, 1.0, 1.0))]
        same = all(bool(torch.equal(a, c)) for a, c in zip(got, again))
        del got, again, want

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
        b_ms, b_by, fma_ms = product_bound(flops, nbytes, dt)
        row = {"kernel": "gram_norm_fused", "case": name, "dtype": dt,
               "shape": {"B": b, "T": t, "Di": di, "Do": do},
               "layout": "contiguous" if x.is_contiguous() else
               "strided views",
               "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "rtol": RTOL[dt], "ok": all(e[2] for e in errs) and same,
               "bitwise_repeat": same,
               "kernel_ms": cuda_ms(torch, lambda: ops.gram_norm_fused(
                   x, dy, w, has_bias=True), 5),
               "plain_ms": cuda_ms(torch, lambda: ref.gram_norm_fused_ref(
                   x, dy, w, has_bias=True), 3),
               "library_ms": cuda_ms(torch, library, 3),
               "library": "bmm materialize + square-sum + einsum with w",
               "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma_ms,
               "main_path": main}
        if copy_ms is not None:
            row["copy_ms"] = copy_ms
        rows.append(row)
        log(row)
        del x, dy
        torch.cuda.empty_cache()
    return rows


def pe1d_cases(torch, rnd):
    """``pe_conv_grad_1d`` at the 1-D lane's five layer shapes (x padded,
    T' = 4096) in f32 (the lane's dtype) and bf16, the JAX kernel test's
    sweep in both dtypes and a ragged case (T' not a multiple of the
    32-deep stage, D and C·K wider than one tile); each launched twice
    to show it bitwise repeatable, and held to the f32 sum bound with
    n = T'.  Each row's bound is at 3xTF32 (f32) or the bf16 peak; the
    kernel runs on f32 FMAs (the per-example product core) in both
    dtypes, and ``fma_bound_ms`` is its bound at the f32 FMA peak.
    Library: the grouped-conv lowering
    (``convops.pe_conv_grad(impl="fgc")``), one conv call, the route
    every non-plain conv takes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import convops
    cases = [(f"lane_{n}", C1_B, c, d, C1_T + 2 * p, k, dt, dt == "float32")
             for dt in ("float32", "bfloat16") for n, c, d, k, p in C1_LAYERS]
    cases += [(f"sweep{i}", b, c, d, t, k, dt, False)
              for i, (b, c, d, t, k) in enumerate(PE1D_SWEEP)
              for dt in ("float32", "bfloat16")]
    cases += [("ragged", 3, 70, 130, 100, 4, "float32", False)]
    rows = []
    for name, b, c, d, t, k, dt, main in cases:
        tdt = getattr(torch, dt)
        tp = t - k + 1
        x, dy = rnd(b, c, t, dtype=tdt), rnd(b, d, tp, dtype=tdt)
        got = ops.pe_conv_grad_1d(x, dy, K=k)
        again = ops.pe_conv_grad_1d(x, dy, K=k)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        want = ref.pe_conv_grad_1d_ref(x, dy, k)
        abs_err, rel_err, _ = compare(torch, got, want, dt)
        mult, plain_mult, rule_ok = sum_rule(
            got, want, lambda a, g_: ref.pe_conv_grad_1d_ref(a, g_, k), x, dy,
            tp)
        flops = 2 * b * d * c * k * tp
        nbytes = (x.numel() + dy.numel()) * x.element_size() \
            + b * d * c * k * 4
        b_ms, b_by, fma_ms = product_bound(flops, nbytes, dt)
        k_ms = cuda_ms(torch, lambda: ops.pe_conv_grad_1d(x, dy, K=k), 10)
        row = {"kernel": "pe_conv_grad_1d", "case": name, "dtype": dt,
               "shape": {"B": b, "C": c, "T": t, "D": d, "K": k},
               "route": "fma (per-example product core)",
               "check": "f32 sum bound (kernels/bounds.py), n = T'",
               "bound_multiple": mult, "plain_bound_multiple": plain_mult,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "ok": rule_ok and repeat,
               "bitwise_repeat": repeat, "kernel_ms": k_ms,
               "tflops": flops / k_ms / 1e9,
               "plain_ms": cuda_ms(torch, lambda: ref.pe_conv_grad_1d_ref(
                   x, dy, k), 3),
               "library_ms": cuda_ms(torch, lambda: convops.pe_conv_grad(
                   x, dy, kernel_spatial=(k,), impl="fgc"), 3),
               "library": "F.conv2d grouped-conv lowering (fgc)",
               "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma_ms,
               "bound_share": b_ms / k_ms, "main_path": main}
        rows.append(row)
        log(row)
        del x, dy, got, again, want
    torch.cuda.empty_cache()
    return rows


def embed_segsum(ids, dy):
    """The port's embedding norm by sorted segment sums
    (``kinds.embed_norm_sq(method="segsum")``), what the model path runs."""
    from repro_torch.core import kinds
    from repro_torch.core.tapper import LayerMeta
    meta = LayerMeta("embed", ("tok_emb",), param_key="emb")
    return kinds.embed_norm_sq(meta, {"ids": ids}, dy, method="segsum")


def tokmask_cases(torch):
    """``gram_norm_tokmask`` against its plain version (the id-masked
    Gram) and against the segment sum, with random and heavily repeated
    ids and a ragged T; each launched twice to show it bitwise
    repeatable.  The ids are int32, as the model's token batches are;
    ``int64_ids_ms`` times the call on the same ids in int64, which adds
    the wrapper's int32 range check (one reduction and one copy to the
    host).  Library: the plain Gram einsum, masked; the segment sum's
    time stands beside it."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, b, t, d, v, dt, main in TOK_CASES:
        tdt = getattr(torch, dt)
        ids64 = torch.randint(0, v, (b, t), generator=g, device="cuda")
        ids = ids64.to(torch.int32)
        dy = torch.randn(b, t, d, generator=g, device="cuda").to(tdt)
        got = ops.gram_norm_tokmask(ids, dy)
        again = ops.gram_norm_tokmask(ids, dy)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        want = ref.gram_norm_tokmask_ref(ids, dy)
        seg = embed_segsum(ids, dy)
        abs_err, rel_err, ok = compare(torch, got, want, dt, floor=0.0)
        _, seg_rel, seg_ok = compare(torch, got, seg, dt, floor=0.0)
        route = ops.tokmask_route(t)
        pairs = int((ids[:, :, None] == ids[:, None, :]).sum())

        def library():
            f = dy.float()
            m = ids[:, :, None] == ids[:, None, :]
            return (torch.einsum("btd,bsd->bts", f, f) * m).sum((1, 2))

        # The function needs the cheaper of two routes: the Gram over the
        # pairs of equal ids (2·D each), or a segment sum of each id's rows
        # (about 2·T·D per example).
        flops = min(2 * d * pairs, 2 * b * t * d)
        nbytes = ids.numel() * ids.element_size() \
            + dy.numel() * dy.element_size() + b * 4
        b_ms, b_by = bound(flops, nbytes, dt)
        row = {"kernel": "gram_norm_tokmask", "case": name, "dtype": dt,
               "shape": {"B": b, "T": t, "D": d, "id_range": v},
               "route": route, "equal_id_pairs": pairs,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "segsum_max_rel_err": seg_rel, "rtol": RTOL[dt],
               "ok": ok and seg_ok and repeat, "bitwise_repeat": repeat,
               "kernel_ms": cuda_ms(torch, lambda: ops.gram_norm_tokmask(
                   ids, dy), 10),
               "int64_ids_ms": cuda_ms(torch, lambda: ops.gram_norm_tokmask(
                   ids64, dy), 10),
               "plain_ms": cuda_ms(torch, lambda: ref.gram_norm_tokmask_ref(
                   ids, dy), 3),
               "library_ms": cuda_ms(torch, library, 3),
               "library": "masked Gram einsum (f32)",
               "segsum_ms": cuda_ms(torch, lambda: embed_segsum(ids, dy), 3),
               "bound_ms": b_ms, "bound_by": b_by, "main_path": main}
        rows.append(row)
        log(row)
        del ids, ids64, dy, got, again, want, seg
    torch.cuda.empty_cache()
    return rows


def flash_close(torch, got, want):
    """``compare`` for a flash output, by its own dtype (see FLASH_RTOL):
    max abs error, its share of the largest entry, and whether every
    entry is within bound."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    bound = (FLASH_RTOL["bfloat16" if bf16 else "float32"] * want.abs()
             + FLASH_ATOL * scale)
    if bf16:
        rms = want.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
        bound = bound + FLASH_ULPS * torch.exp2(torch.floor(
            torch.log2(rms)) - 7)
    return (err.max().item(), err.max().item() / max(scale, 1e-30),
            bool((err <= bound).all()))


def flash_cases(torch, rnd):
    """The flash forward, dq and dk/dv kernels against their plain
    versions (``ref.flash_fwd_ref`` / ``flash_dq_ref`` / ``flash_dkv_ref``,
    the full (T, S) softmax); the library yardstick is
    ``F.scaled_dot_product_attention``'s forward and its backward (one
    call giving dq, dk and dv), timed only here."""
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    flib = build.load("flash_attn")
    for which, kern in enumerate(FLASH_NAMES):
        for dt in ("float32", "bfloat16"):
            for hd in (16, 32, 64, 128):
                want = ops.flash_design(kern, getattr(torch, dt), hd)
                got = flib.repro_flash_design(which, hd, int(dt == "bfloat16"))
                check(got == (want == "wgmma"),
                      f"{kern} {dt} hd {hd}: the library's design ({got}) "
                      f"is not ops.flash_design's ({want})")
    rows = []
    for name, b, t, h, hkv, hd, causal, dt, main in FLASH_CASES:
        tdt = getattr(torch, dt)
        q, do = rnd(b, t, h, hd, dtype=tdt), rnd(b, t, h, hd, dtype=tdt)
        k, v = rnd(b, t, hkv, hd, dtype=tdt), rnd(b, t, hkv, hd, dtype=tdt)
        o, lse = ops.flash_fwd(q, k, v, causal=causal)
        o2, lse2 = ops.flash_fwd(q, k, v, causal=causal)
        delta = ops.flash_delta(o, do)
        bwd = (q, k, v, do, lse, delta)
        dq = ops.flash_dq(*bwd, causal=causal)
        dk, dv = ops.flash_dkv(*bwd, causal=causal)
        dq2 = ops.flash_dq(*bwd, causal=causal)
        dk2, dv2 = ops.flash_dkv(*bwd, causal=causal)
        torch.cuda.synchronize()
        repeat = {"flash_fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
                  "flash_dq": torch.equal(dq, dq2),
                  "flash_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
        del o2, lse2, dq2, dk2, dv2
        ro, rl = ref.flash_fwd_ref(q, k, v, causal=causal)
        rdq = ref.flash_dq_ref(*bwd, causal=causal)
        rdk, rdv = ref.flash_dkv_ref(*bwd, causal=causal)
        rtol = FLASH_RTOL[dt]
        errs = {"flash_fwd": [flash_close(torch, o, ro),
                              flash_close(torch, lse, rl)],
                "flash_dq": [flash_close(torch, dq, rdq)],
                "flash_dkv": [flash_close(torch, dk, rdk),
                              flash_close(torch, dv, rdv)]}
        del ro, rl, rdq, rdk, rdv

        lib_fwd, lib_bwd = sdpa_backends(torch, F, q, k, v, do, causal,
                                         hkv != h)
        # No PyTorch call computes dq alone: SDPA's backward (dq, dk and
        # dv in one call) stands as the library on the dk/dv row only, so
        # the kernels line counts it once (the dq row holds it beside
        # dq + dk/dv).
        times = {
            "flash_fwd": (lambda: ops.flash_fwd(q, k, v, causal=causal),
                          lambda: ref.flash_fwd_ref(q, k, v, causal=causal),
                          lib_fwd, "F.scaled_dot_product_attention forward"),
            "flash_dq": (lambda: ops.flash_dq(*bwd, causal=causal),
                         lambda: ref.flash_dq_ref(*bwd, causal=causal),
                         {"ms": None}, "none: no PyTorch call computes dq "
                         "alone (SDPA's backward is on the flash_dkv row)"),
            "flash_dkv": (lambda: ops.flash_dkv(*bwd, causal=causal),
                          lambda: ref.flash_dkv_ref(*bwd, causal=causal),
                          lib_bwd, "F.scaled_dot_product_attention backward "
                                   "(dq, dk and dv in one call)")}
        # (query, key) pairs the causal mask keeps (T = S here); the
        # forward does 2 hd-deep products per pair (q.k, p.v), dq 3
        # (q.k, do.v, ds.k), dk/dv 4 (q.k, do.v, p^T.do, ds^T.q).
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        es = q.element_size()
        io = (q.numel() + k.numel() + v.numel()) * es
        rows_bhT = b * h * t * 4
        work = {"flash_fwd": (4 * hd * pairs, io + q.numel() * es
                              + rows_bhT),
                "flash_dq": (6 * hd * pairs, io + 2 * q.numel() * es
                             + 2 * rows_bhT),
                "flash_dkv": (8 * hd * pairs, io + q.numel() * es
                              + (k.numel() + v.numel()) * es + 2 * rows_bhT)}
        case_rows = {}
        for kern, (kfn, pfn, lib, lib_what) in times.items():
            flops, nbytes = work[kern]
            b_ms, b_by = bound(flops, nbytes, dt)
            e = errs[kern]
            k_ms = cuda_ms(torch, kfn, 20)
            row = {"kernel": kern, "case": name, "dtype": dt,
                   "design": ops.flash_design(kern, tdt, hd),
                   "shape": {"B": b, "T": t, "H": h, "Hkv": hkv, "hd": hd,
                             "causal": causal},
                   "max_abs_err": max(x[0] for x in e),
                   "max_rel_err": max(x[1] for x in e),
                   "rtol": rtol, "ok": all(x[2] for x in e) and repeat[kern],
                   "bitwise_repeat": repeat[kern],
                   "kernel_ms": k_ms, "tflops": flops / k_ms / 1e9,
                   "plain_ms": cuda_ms(torch, pfn, 2),
                   "library_ms": lib["ms"], "library": lib_what,
                   "library_backend": lib.get("backend"),
                   "library_backends": lib.get("backends"),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / k_ms, "main_path": main,
                   "calls_per_step": LM_LAYERS if main else 1}
            if main and row["design"] == "wgmma":
                # the fma design, which these calls took before, on the
                # same inputs
                flib.repro_flash_fma_only(1)
                try:
                    row["earlier_ms"] = cuda_ms(torch, kfn, 20)
                finally:
                    flib.repro_flash_fma_only(0)
                row["earlier_design"] = "fma"
            case_rows[kern] = row
        # The backward's two kernels together, beside SDPA's one call for
        # dq, dk and dv.
        case_rows["flash_dq"]["bwd_sum_ms"] = (
            case_rows["flash_dq"]["kernel_ms"]
            + case_rows["flash_dkv"]["kernel_ms"])
        case_rows["flash_dq"]["sdpa_bwd_ms"] = lib_bwd["ms"]
        for row in case_rows.values():
            rows.append(row)
            log(row)
        del q, k, v, do, o, lse, delta, bwd, dq, dk, dv
        torch.cuda.empty_cache()
    return rows


def sdpa_backends(torch, F, q, k, v, do, causal, gqa):
    """SDPA's forward and backward (one call for dq, dk and dv) on
    (B, H, T, hd) views, under each backend ``sdpa_kernel`` offers: the
    fastest backend that takes these inputs is the yardstick.  Returns
    ({"ms", "backend", "backends"} for the forward, the same for the
    backward)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qh, kh, vh = (a.detach().transpose(1, 2).requires_grad_(True)
                  for a in (q, k, v))
    dout = do.transpose(1, 2)
    sdpa = functools.partial(F.scaled_dot_product_attention,
                             is_causal=causal, enable_gqa=gqa)
    fwd, bwd = {}, {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(be):
                out = sdpa(qh, kh, vh)
                fwd[be.name] = cuda_ms(torch, lambda: sdpa(qh, kh, vh), 5)
                bwd[be.name] = cuda_ms(torch, lambda: torch.autograd.grad(
                    out, (qh, kh, vh), dout, retain_graph=True), 5)
            del out
        except RuntimeError as err:  # this backend does not take them
            fwd[be.name] = bwd[be.name] = f"unavailable: {str(err)[:80]}"
        torch.cuda.empty_cache()
    res = []
    for times in (fwd, bwd):
        ok = {n: ms for n, ms in times.items() if isinstance(ms, float)}
        check(ok, f"no SDPA backend takes these inputs: {times}")
        best = min(ok, key=ok.get)
        res.append({"ms": ok[best], "backend": best, "backends": times})
    return res


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


def small_lm_parity(torch):
    """Phase 4 (LM): a reduced Llama-3.2-1B (2 layers, head_dim 16, f32,
    ``attn_impl="flash"``) gives the same clipped sums on the card (the
    flash kernels) as on the CPU, under bk and ``auto``."""
    from repro_torch.configs import get_config
    from repro_torch.core import clipped_grad_sum
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import tree_map
    cfg = get_config("llama3.2-1b").reduced().replace(attn_impl="flash")
    m = TransformerLM(cfg)
    params, _ = m.init(3, device="cpu")
    b = SyntheticLMDataset(cfg.vocab, 16, n_examples=8).batch(range(4))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    for strategy in ("bk", "auto"):
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), params)
            bt = {k: v.to(dev) for k, v in batch.items()}
            n0 = ops.LAUNCHES["flash_fwd"]
            out[dev] = clipped_grad_sum(m.apply, p, bt, l2_clip=1.0,
                                        strategy=strategy)
            launched = ops.LAUNCHES["flash_fwd"] - n0
            check(launched == (cfg.n_layers if dev == "cuda" else 0),
                  f"reduced llama {strategy} on {dev}: {launched} flash "
                  f"forward launches")
        check(torch.allclose(out["cuda"][0].cpu(), out["cpu"][0],
                             rtol=1e-5), f"llama {strategy}: losses differ")
        check(torch.allclose(out["cuda"][2].cpu(), out["cpu"][2],
                             rtol=1e-4), f"llama {strategy}: norms differ")
        tree_close(torch, out["cuda"][1], out["cpu"][1], 1e-4, 1e-6,
                   f"reduced llama {strategy} clipped sum")
    log({"phase": "small_lm_parity", "ok": True,
         "strategies": ["bk", "auto"]})


def main_path(torch, lanes):
    """Phase 5: full-width AlexNet DP-SGD steps through the engine; each
    lane's launches, step by step, go to ``lanes``."""
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
    steps = 3
    # (lane, strategy, clipping, norm knobs, kernels each step launches:
    # the count of each step).  crb takes pe_conv_grad_2d once a plain
    # conv (conv1-4), auto flat and stale once (conv1, planned pe; conv0's
    # stride 4 takes the grouped-conv lowering); ghost
    # and bk take gram_norm once a layer (8); the stale lane's step 0 is
    # the flat bootstrap (no fused pass), each later step fuses conv2-4
    # once.
    runs = [("crb", "crb", "flat", NormCfg(conv_impl="pallas"),
             {"pe_conv_grad_2d": [len(PE_CASES)] * steps}),
            ("ghost", "ghost", "flat", NormCfg(dense="pallas", conv="pallas"),
             {"gram_norm": [len(GRAM_CASES)] * steps}),
            ("bk", "bk", "flat", NormCfg(dense="pallas", conv="pallas",
                                         conv_impl="pallas"),
             {"gram_norm": [len(GRAM_CASES)] * steps}),
            ("auto_flat", "auto", "flat", auto,
             {"pe_conv_grad_2d": [1] * steps}),
            ("auto_stale", "auto", "stale", auto,
             {"pe_conv_grad_2d": [1] * steps,
              "gram_norm_fused": [0] + [len(FUSED_CASES)] * (steps - 1)})]
    launches = {k: 0 for k in ops.LAUNCHES}
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
        lanes[lane] = {k: [c[k] for c in per_step]
                       for k, v in counts.items() if v}
        prof = profile_step(torch, lambda: eng.private_step(
            p, opt, batches[steps], step=steps))
        check(all(math.isfinite(v) for v in losses),
              f"{lane}: non-finite loss {losses}")
        for k, want in needs.items():
            check(counts[k] > 0, f"{lane}: kernel {k} never launched")
            got = [c[k] for c in per_step]
            check(got == want,
                  f"{lane}: {k} launches per step {got}, expected {want}")
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


def lm_main_path(torch, launches, lanes):
    """Phase 6: full-width Llama-3.2-1B DP-SGD steps through the engine,
    bk and ``auto`` flat; adds the flash launches to ``launches`` and each
    lane's launches per step to ``lanes``.  Returns each lane's flash
    kernels' device time in its profiled step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig, PrivacyEngine
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models.lm import TransformerLM
    from repro_torch.optim import adamw_init
    from repro_torch.tree import get_subtree, leaf_paths

    cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
           cfg.vocab, cfg.hd) == (LM_LAYERS, 2048, 32, 8, 8192, 128256, 64)
          and cfg.tie_embeddings and cfg.dtype == "bfloat16",
          "llama3.2-1b config")
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    params, _ = model.init(0, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(get_subtree(params, p).numel()
                   for p in leaf_paths(params))
    t0 = time.perf_counter()
    n_examples = 4096
    ds = SyntheticLMDataset(cfg.vocab, LM_T, n_examples=n_examples, seed=0)
    batches = []
    for s in range(4):
        b = ds.batch(range(s * LM_B, (s + 1) * LM_B))
        batches.append({k: torch.from_numpy(v).cuda() for k, v in b.items()})
    log({"phase": "lm_setup", "arch": cfg.name, "params": n_params,
         "batch": LM_B, "seq": LM_T, "init_s": init_s,
         "data_s": time.perf_counter() - t0})
    flash = FLASH_NAMES
    steps = 3
    profiled = {}
    for lane, strategy in (("llama_bk", "bk"), ("llama_auto_flat", "auto")):
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy=strategy)
        eng = PrivacyEngine(model.apply, params, batches[0], dp,
                            optimizer="adamw", lr=1e-4, run_seed=0,
                            sampling_rate=LM_B / n_examples, device="cuda")
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
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = {k: sum(c[k] for c in per_step) for k in ops.LAUNCHES}
        for k, v in counts.items():
            launches[k] += v
        lanes[lane] = {k: [c[k] for c in per_step]
                       for k, v in counts.items() if v}
        prof = profile_step(torch, lambda: eng.private_step(
            p, opt, batches[steps], step=steps), top=10, named=flash)
        profiled[lane] = prof.get("named", {})
        check(all(math.isfinite(v) for v in losses),
              f"{lane}: non-finite loss {losses}")
        for k in flash:
            got = [c[k] for c in per_step]
            # one capture pass per step (bk, and auto with no weighted
            # backward): each layer's attention launches each kernel once
            check(got == [LM_LAYERS] * steps,
                  f"{lane}: {k} launches per step {got}, expected "
                  f"{LM_LAYERS}")
        log({"phase": "lm_main_path", "lane": lane, "strategy": strategy,
             "clipping": "flat", "plan": plan, "losses": losses,
             "step_ms": step_ms, "step_ms_after_first": step_ms[1:],
             "launches_each_step": per_step,
             "peak_mem_gb": peak, "profiled_step": prof,
             "clip_fraction": float(aux["clip_fraction"]),
             "report": eng.report()})
        del p, opt, eng, aux
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return profiled


def tokmask_path(torch, launches, lanes):
    """Phase 7: ``gram_norm_tokmask`` through its entry point,
    ``ops.gram_norm_tokmask`` (no model path calls it, as in the JAX
    package), on Llama-3.2-1B's embedding cotangent shape: the token ids
    of a synthetic batch (B = 8, T = 1024) and a bf16 δy (B, T, 2048) from
    a seed.  The norms must be finite, one per example, and equal the
    segment sum the model path runs (rtol 1e-4)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    ds = SyntheticLMDataset(128256, LM_T, n_examples=4096, seed=0)
    ids = torch.from_numpy(ds.batch(range(LM_B))["tokens"]).cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    dy = torch.randn(LM_B, LM_T, 2048, generator=g,
                     device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    norms = ops.gram_norm_tokmask(ids, dy)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t) * 1e3
    counts = dict(ops.LAUNCHES)
    for k, v in counts.items():
        launches[k] += v
    lanes["tokmask_entry"] = {k: [v] for k, v in counts.items() if v}
    check(counts["gram_norm_tokmask"] == 1,
          f"tokmask path: {counts['gram_norm_tokmask']} launches")
    check(norms.shape == (LM_B,) and bool(torch.isfinite(norms).all()),
          "tokmask path: norms not finite or of the wrong shape")
    seg = embed_segsum(ids, dy)
    rel = ((norms - seg).abs() / seg).max().item()
    check(rel <= 1e-4, f"tokmask path vs segsum: rel {rel:.3e}")
    log({"phase": "tokmask_path", "ok": True, "shape": [LM_B, LM_T, 2048],
         "dtype": "bfloat16", "call_ms_first": call_ms,
         "segsum_max_rel_err": rel, "launches": counts})


def conv1d_lane(torch, launches, lanes):
    """Phase 8: DP-SGD on the network of plain 1-D convs (C1_LAYERS),
    crb and ``auto`` flat with ``conv_impl="pallas"``."""
    from repro_torch.core import DPConfig, NormCfg, PrivacyEngine
    from repro_torch.core import clipped_grad_sum
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw_init

    def apply(params, batch, tp):
        h = batch["x"]
        for name, _, _, _, pad in C1_LAYERS:
            h = torch.relu(tp.conv(name, h, params[name]["w"],
                                   params[name]["b"], padding=pad))
        logits = tp.dense("head", h.mean(dim=2), params["head"]["w"],
                          params["head"]["b"])
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 1, batch["label"][:, None])[:, 0]

    gen = torch.Generator().manual_seed(0)
    params = {}
    for name, c, d, k, _ in C1_LAYERS:
        params[name] = {"w": (torch.randn(d, c, k, generator=gen)
                              * (c * k) ** -0.5).cuda(),
                        "b": torch.zeros(d, device="cuda")}
    d = C1_LAYERS[-1][2]
    params["head"] = {"w": (torch.randn(d, C1_CLASSES, generator=gen)
                            * d ** -0.5).cuda(),
                      "b": torch.zeros(C1_CLASSES, device="cuda")}
    g = torch.Generator(device="cuda").manual_seed(1)
    steps = 3
    batches = [{"x": torch.randn(C1_B, 3, C1_T, generator=g, device="cuda"),
                "label": torch.randint(0, C1_CLASSES, (C1_B,), generator=g,
                                       device="cuda")}
               for _ in range(steps + 2)]
    knobs = NormCfg(conv_impl="pallas")
    for lane, strategy in (("conv1d_crb", "crb"),
                           ("conv1d_auto_flat", "auto")):
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy=strategy,
                      norm=knobs)
        eng = PrivacyEngine(apply, params, batches[0], dp, optimizer="adamw",
                            lr=1e-3, run_seed=0, sampling_rate=C1_B / 4096,
                            device="cuda")
        plan = decisions = None
        if strategy == "auto":
            plan = eng.explain()
            decisions = {n: [lp.norm_method, lp.stash, lp.fused]
                         for n, lp in eng.plan().layers.items()}
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
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = {k: sum(c[k] for c in per_step) for k in ops.LAUNCHES}
        for k, v in counts.items():
            launches[k] += v
        lanes[lane] = {k: [c[k] for c in per_step]
                       for k, v in counts.items() if v}
        prof = profile_step(torch, lambda: eng.private_step(
            p, opt, batches[steps], step=steps))
        check(all(math.isfinite(v) for v in losses),
              f"{lane}: non-finite loss {losses}")
        got = [c["pe_conv_grad_1d"] for c in per_step]
        if strategy == "crb":
            check(got == [len(C1_LAYERS)] * steps,
                  f"{lane}: pe_conv_grad_1d launches per step {got}, "
                  f"expected {len(C1_LAYERS)}")
        log({"phase": "conv1d_lane", "lane": lane, "strategy": strategy,
             "clipping": "flat", "norm": dataclass_dict(knobs),
             "plan": plan, "plan_layers": decisions, "losses": losses,
             "step_ms": step_ms, "step_ms_after_first": step_ms[1:],
             "launches_each_step": per_step, "peak_mem_gb": peak,
             "profiled_step": prof,
             "clip_fraction": float(aux["clip_fraction"]),
             "report": eng.report()})
        del p, opt, eng, aux
        torch.cuda.empty_cache()

    # The kernel route against the grouped-conv route on one batch at
    # σ = 0: per-example norms and clipped sums (f32 sums in another order).
    b = batches[steps + 1]
    _, sum_fgc, n_fgc = clipped_grad_sum(apply, params, b, l2_clip=1.0,
                                         strategy="crb", conv_impl="fgc")
    _, sum_k, n_k = clipped_grad_sum(apply, params, b, l2_clip=1.0,
                                     strategy="crb", conv_impl="pallas")
    check(torch.allclose(n_k, n_fgc, rtol=1e-4), "1-D crb norms differ")
    tree_close(torch, sum_k, sum_fgc, 1e-4, 1e-6,
               "1-D crb(kernel) vs crb(fgc) clipped sum")
    log({"phase": "conv1d_checks", "ok": True,
         "crb_kernel_vs_fgc_norm_max_rel":
             ((n_k - n_fgc).abs() / n_fgc).max().item()})
    del params, batches
    torch.cuda.empty_cache()


def _bitwise_same(np, a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.reshape(-1).view(np.uint8),
                               b.reshape(-1).view(np.uint8)))


def same_checkpoint(d1, d2, step, stale):
    """The two runs' checkpoints of ``step``: every array bitwise equal
    (params, optimizer state, clip state), the same ledger and plan
    fingerprint.  Returns the number of arrays compared."""
    import numpy as np
    from repro_torch.checkpoint import Checkpointer
    m1, m2 = Checkpointer(d1).read_meta(step), Checkpointer(d2).read_meta(step)
    for key in ("ledger", "plan_fingerprint", "clip_keys", "run_seed",
                "noise_device"):
        check(m1[key] == m2[key], f"checkpoints differ in {key}: "
                                  f"{m1[key]} vs {m2[key]}")
    check(m1["noise_device"] == "cuda", "noise drawn off the card")
    name = f"step_{step:09d}"
    with np.load(os.path.join(d1, name, "arrays.npz")) as za, \
            np.load(os.path.join(d2, name, "arrays.npz")) as zb:
        check(sorted(za.files) == sorted(zb.files), "different leaves")
        for part in ("['params']", "['opt']") + (("['clip']",) if stale
                                                  else ()):
            check(any(k.startswith(part) for k in za.files),
                  f"no {part} leaves in the checkpoint")
        for k in za.files:
            check(_bitwise_same(np, za[k], zb[k]),
                  f"resumed run differs from the straight run at {k}")
        return len(za.files)


def run_cli(args, ckpt_dir):
    """One ``python -m repro_torch.launch.train`` process; returns (its
    JSON summary, its stdout, wall seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args,
           "--ckpt-dir", ckpt_dir]
    t = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"{' '.join(args)}: timed out after "
                           f"{CLI_TIMEOUT_S} s") from e
    wall = time.perf_counter() - t
    check(proc.returncode == 0,
          f"{' '.join(args)}: exit {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('{"train_summary"')]
    check(lines, f"{' '.join(args)}: no summary line")
    return json.loads(lines[-1])["train_summary"], proc.stdout, wall


def cli_lanes():
    """Phase 9: kill-and-resume through the training CLI, bitwise."""
    base = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    for lane, args, steps in CLI_LANES:
        common = args + ["--steps", str(steps), "--ckpt-every", "2"]
        d_straight, d_killed = str(base / lane / "straight"), \
            str(base / lane / "killed")
        s1, _, wall1 = run_cli(common, d_straight)
        s2, out2, wall2 = run_cli(common + ["--fail-at", "3"], d_killed)
        check(s1["restarts"] == 0 and s2["restarts"] == 1,
              f"{lane}: restarts {s1['restarts']}, {s2['restarts']}")
        check("[restore] resuming from step 2" in out2,
              f"{lane}: the killed run did not resume from step 2")
        check(all(math.isfinite(v) for v in s1["losses_last_segment"]
                  + s2["losses_last_segment"]), f"{lane}: non-finite loss")
        n = same_checkpoint(d_straight, d_killed, steps - 1,
                            "stale" in lane)
        log({"phase": "cli_lane", "lane": lane, "args": common,
             "bitwise_equal_arrays": n, "ok": True,
             "straight": {"wall_s": wall1, **s1},
             "killed_at_3": {"wall_s": wall2, **s2},
             "disk_free_gb": shutil.disk_usage(base).free / 1e9})
        shutil.rmtree(base / lane, ignore_errors=True)
    shutil.rmtree(base, ignore_errors=True)


def profile_step(torch, fn, top=8, named=()):
    """One step under ``torch.profiler``: wall ms, summed CUDA kernel ms,
    the device's busy share (kernel ms / wall ms, one stream), the
    kernels that took the most device time and, for each string in
    ``named``, the device time and launches of the kernels whose names
    hold it."""
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
    found = {}
    for part in named:
        ms = sum(m for name, m, _ in kernels if part in name)
        n = sum(c for name, _, c in kernels if part in name)
        found[part] = {"ms": ms, "launches": n,
                       "ms_per_launch": ms / n if n else None}
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top": [{"kernel": name[:90], "ms": ms, "calls": n}
                    for name, ms, n in kernels[:top]], "named": found}


def dataclass_dict(obj):
    import dataclasses
    return dataclasses.asdict(obj)


def summarize(rows, launches, lanes, profiled):
    """One entry per kernel: sums over the main path's shapes (one step's
    worth of each kernel's calls: a flash row counts once per layer),
    errors over every case; launches over the paths' counted steps, and
    step by step for each lane that launched the kernel.  A flash entry
    also names its design at the main path's shape, the fma design's
    time a call on the same inputs where the wgmma design took the call,
    and its device time a launch in each Llama lane's profiled step
    (``profiled``)."""
    meta = {
        "pe_conv_grad_2d": ("src/repro_torch/kernels/csrc/pe_conv_grad.cu",
                            "src/repro/kernels/pe_conv_grad.py:72"),
        "pe_conv_grad_1d": ("src/repro_torch/kernels/csrc/pe_conv_grad.cu",
                            "src/repro/kernels/pe_conv_grad.py:51"),
        "gram_norm": ("src/repro_torch/kernels/csrc/gram_norm.cu",
                      "src/repro/kernels/gram_norm.py:78"),
        "gram_norm_fused": ("src/repro_torch/kernels/csrc/gram_norm.cu",
                            "src/repro/kernels/gram_norm.py:145"),
        "gram_norm_tokmask": ("src/repro_torch/kernels/csrc/gram_norm.cu",
                              "src/repro/kernels/gram_norm.py:182"),
        "flash_fwd": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                      "src/repro/kernels/flash_attn.py:160"),
        "flash_dq": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                     "src/repro/kernels/flash_attn.py:210"),
        "flash_dkv": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                      "src/repro/kernels/flash_attn.py:229"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = [r for r in mine if r["main_path"]]

        def per_step(key, rows_):
            return sum(r[key] * r.get("calls_per_step", 1) for r in rows_)

        t_ops = per_step("bound_ms", [r for r in main
                                      if r["bound_by"] == "operations"])
        t_bytes = per_step("bound_ms", [r for r in main
                                        if r["bound_by"] == "bytes"])
        calls = sum(r.get("calls_per_step", 1) for r in main)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_per_step": {lane: c[name] for lane, c in lanes.items()
                                  if c.get(name)},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            "ms": per_step("kernel_ms", main),
            "ms_per_call": per_step("kernel_ms", main) / calls,
            "plain_ms": per_step("plain_ms", main),
            "bound_ms": t_ops + t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": (None if any(r["library_ms"] is None
                                       for r in main)
                           else per_step("library_ms", main)),
            "cases": [r["case"] for r in main]}
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        if name == "gram_norm_tokmask":
            entry["design"] = main[0]["route"]
            entry["segsum_ms"] = per_step("segsum_ms", main)
        if "fma_bound_ms" in main[0]:
            entry["fma_bound_ms"] = per_step("fma_bound_ms", main)
        if "bound_multiple" in main[0]:
            entry["bound_multiple"] = max(r["bound_multiple"] for r in mine)
            entry["plain_bound_multiple"] = max(r["plain_bound_multiple"]
                                                for r in mine)
        if name in ("pe_conv_grad_1d", "pe_conv_grad_2d"):
            entry["design"] = main[0]["route"]
            entry["tflops"] = (sum(r["kernel_ms"] * r["tflops"] for r in main)
                               / sum(r["kernel_ms"] for r in main))
            entry["ms_by_layer"] = {r["case"]: r["kernel_ms"] for r in main}
        if name == "gram_norm":
            entry["routes"] = {r["case"]: r["route"] for r in main}
            entry["ms_by_route"] = {
                route: sum(r["kernel_ms"] for r in main
                           if r["route"] == route)
                for route in ("direct", "gram", "rank1")}
        if name in FLASH_NAMES:
            entry["design"] = main[0]["design"]
            if "earlier_ms" in main[0]:
                entry["earlier_ms_per_call"] = main[0]["earlier_ms"]
            entry["library_backend"] = main[0]["library_backend"]
            if name == "flash_dq":
                entry["bwd_sum_ms_per_call"] = main[0]["bwd_sum_ms"]
                entry["sdpa_bwd_ms_per_call"] = main[0]["sdpa_bwd_ms"]
            entry["profiled_ms_per_launch"] = {
                lane: found[name]["ms_per_launch"]
                for lane, found in profiled.items() if name in found}
        out.append(entry)
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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    info = build.build_all()
    log({"phase": "build", "seconds": info["seconds"],
         "built": info["built"],
         "ptxas": {stem: ptxas_summary(text)
                   for stem, text in info["ptxas"].items()}})

    t = time.perf_counter()
    rows = kernel_cases(torch)
    log({"phase": "kernels_done", "seconds": time.perf_counter() - t})
    small_parity(torch)
    small_lm_parity(torch)
    lanes = {}
    t = time.perf_counter()
    launches = main_path(torch, lanes)
    log({"phase": "main_path_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    profiled = lm_main_path(torch, launches, lanes)
    log({"phase": "lm_main_path_done", "seconds": time.perf_counter() - t})
    tokmask_path(torch, launches, lanes)
    t = time.perf_counter()
    conv1d_lane(torch, launches, lanes)
    log({"phase": "conv1d_lane_done", "seconds": time.perf_counter() - t})
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cli_lanes()
    log({"phase": "cli_lanes_done", "seconds": time.perf_counter() - t})

    log(nvidia_smi_line())
    log({"kernels": summarize(rows, launches, lanes, profiled)})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
