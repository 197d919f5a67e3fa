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
4. calibrate: ``repro_torch.calibrate.measure()`` on the card (f32 matmul
   at n = 8192 with TF32 off, a 1 GiB stream, ``pe_conv_grad_2d``'s tile
   sweep over AlexNet's conv1-4 and VGG16's conv0, conv1, conv7, conv12 at
   B = 4, ``gram_norm_fused``'s time): the FLOP rate, the HBM bandwidth
   (at most the data sheet's 3.35 TB/s, or the stream read the L2), FLOP
   per HBM byte, the sweep and its winner, the digest, beside the card's
   name and power limit; every tile at every swept shape, and the plain
   version, within the f32 sum bound; the blob saved under ``build/``
   and loaded back strictly;
5. small parity: a toy CNN's clipped gradients on the card (kernels) equal
   the port on the CPU (plain versions; the CPU tests hold those against
   the JAX package), under crb / ghost / bk and the planned stale step;
   and a reduced Llama-3.2-1B's (flash kernels) under bk and ``auto``;
   then (phase ``dp_attn_parity``, f32, σ = 0) the block-level
   ``"attn"`` tap: reduced Llama-3.2-1B (flash) and reduced MLA with
   ``dp_attn=True`` under bk's ``attn_norm`` ghost and pe give the norms
   (rtol 1e-4) and clipped sums (the reference's f32 sum tolerance) of
   per-projection taps, launching the flash forward three times a layer,
   and MLA's prefill plus decode (absorbed and not) equals one causal
   forward within the flash rows' f32 tolerance;
6. main path: ``PrivacyEngine.private_step`` on full-width AlexNet
   (1000 classes, ~74.7 M params), 3 steps each of crb / ghost / bk with the
   kernel knobs and of the planned step (``strategy="auto"``) under flat,
   stale and per_layer (uniform and auto budgets) clipping, σ = 1; launch
   counts are reset before and read
   after each step, and one more step runs under ``torch.profiler``
   (device busy share, top kernels).  ghost and bk must launch
   ``gram_norm`` once a layer (8) each step.  The stale lane's first step
   is the flat bootstrap; each later step must launch ``gram_norm_fused``
   once per fused layer (conv2-4); a per_layer lane launches what its plan
   says.  Then, on one batch at σ = 0, the
   ghost(kernel) norms must equal the crb(grouped-conv) norms, the
   crb(kernel) clipped sum the crb(grouped-conv) one, the fused stale
   step the unfused one on the same lagged norms, and two fused stale
   steps must be bitwise equal.
7. VGG16: the same on full-width VGG16 (169 814 824 params), B = 32: crb
   (``pe_conv_grad_2d`` at all 13 convs; B = 16 for this lane alone, with
   the reason printed, if B = 32 does not fit), ghost and bk (``gram_norm``
   once a layer, 16), ``auto`` flat, per_layer and stale (the launches the
   plan says); every lane's step-0 per-example norms equal crb's.
8. the paper's toy CNNs (Figs 1-3) at ``toy_cnn_config``'s defaults
   (c0 = 25, 256 px, 10 classes): L = 4 at rate 2 with kernels 3 and 5,
   and L = 3 at rate 1, c0 = 32, kernel 5; B = 32 under crb, ghost, bk
   and ``auto`` flat, as for VGG16.
9. LM main path: ``PrivacyEngine.private_step`` on full-width
   Llama-3.2-1B (16 layers, d_model 2048, 32/8 heads, vocab 128 256, tied
   embeddings, bf16, ``attn_impl="flash"``; ~1.24 B params), B = 8,
   T = 1024, σ = 1: 3 steps each of bk (the config's strategy) and
   ``auto`` flat, step ms, peak memory and one profiled step each (with
   each flash kernel's device time a launch).  Each step's capture pass
   must launch every flash kernel once per layer (16).  Then, on the
   same params and batches: ``auto`` under per_layer (uniform budgets)
   and stale clipping (phase ``lm_clip_modes``: the stale plan fuses
   wq, wo and the three MLP denses of every layer, 80
   ``gram_norm_fused`` launches a step after the flat bootstrap; the
   lane names the fused layers, or prints its plan if there are none),
   and bk with ``remat=False`` and ``remat=True`` (phase ``lm_remat``:
   step ms and peak of each; a remat step launches the flash forward 32
   times, the forward and the recompute; the clipped noise-free sums of
   one batch are bitwise equal, or else within the bf16 lane's
   tolerance, and the lane says which).
   Then (phase ``lm_dp_attn``) ``dp_attn=True``: ``auto`` flat as
   planned and with the ``"attn"`` block pinned to ghost and to pe, 3
   steps each: the plan, step ms, peak, busy share, top device time;
   each step must launch each flash kernel once a layer for every pass
   over the blocks its plan runs (``attn_passes``: the capture pass, the
   norm phase's recompute, the contribution's unless stashed: 48).
9b. OLMo-1B (phase ``olmo_main_path``): the same bk and ``auto`` flat
   lanes on full-width OLMo-1B (16 layers, d_model 2048, 16/16 heads,
   head_dim 128, vocab 50 304, non-parametric LayerNorm, tied, bf16,
   flash): the flash kernels at head_dim 128 on a model.
9f. DeepSeek-V3's first layer at full width (phase ``deepseek_layer0``:
   MLA, d_model 7168, 128 heads, q / kv ranks 1536 / 512, nope / rope /
   v 128 / 64 / 128, dense SwiGLU d_ff 18 432, vocab 129 280 untied,
   bf16, weights drawn on the card; cut to one layer, no experts, no
   remat or FSDP): ``auto`` flat with ``dp_attn=True,
   attn_impl="xla"``, B = 4, T = 512, 3 steps (plan, step ms, peak, and
   the DP gradient's own peak; no kernel of this repo launches); then
   serving 4 prompts of 128 tokens, 32 out, with the absorbed decode off
   and on: prefill ms, decode ms a token, the latent cache's 1152 bytes
   a token, decode-equals-forward against the f32 forward
   (``serve_checks_f32_ref``).
9g. the static verifier (phase ``dp_verify``): ``engine.verify()`` on
   fake CUDA tensors, ``strategy="auto"`` at full width: AlexNet
   (B = 32) under flat, per_layer and stale clipping, VGG16 (B = 32)
   flat, Llama-3.2-1B (B = 8, T = 1024, flash) stale and flat with
   ``dp_attn``.  Each report must hold no error; each lane prints the
   seconds of the trace and the passes, the graph's nodes, its nodes per
   kernel op and the rise of ``max_memory_allocated`` during
   ``verify()`` (under 1 % of the step's peak); one real
   ``private_step`` of the same engine (after a stale lane's bootstrap)
   must launch each kernel as many times as the graph holds its nodes.
   One mutant on the card (the clip dropped, AlexNet ``auto`` flat)
   must report ``clip_missing`` and ``unclipped_batch_reduction``; the
   dispatcher's cost a launch is measured (``gram_norm`` through its
   op against its CUDA implementation called directly); and
   ``python -m repro_torch.launch.dpcheck`` over the reduced AlexNet,
   VGG16 and Llama-3.2-1B under every clipping mode must exit 0.
9h. the MoE and enc-dec families (``run_moe_encdec``): full-width
   Granite-3.0-1B-A400M (phase ``moe_main_path``: cut from 24 layers to
   GR_DEPTH = 3, d_model 1024, 16/8 heads, 32 experts top-8 of d_ff
   512, vocab 49 155, bf16, gather dispatch, flash; B = 8, T = 1024)
   under ghost (``gram_norm`` on every dense layer that is not an
   expert, 16 a step; flash 6 of each kernel a step), ``auto`` flat and
   stale (the launches their plans
   say; the plan's realization of each expert layer printed; no expert
   fuses), then stale fused against unfused, the ghost norms with the
   kernels against the plain versions, and two deterministic ghost sums
   bitwise; the verifier on it (phase ``moe_verify``: ``auto`` stale
   reports exactly the gather dispatch's global-capacity finding, its
   kernel nodes equal a real step's launches; ``dpcheck`` over reduced
   Granite and Seamless gives the JAX package's verdicts on Granite,
   FAIL, and the port's own on Seamless, PASS); serving (phase
   ``moe_encdec_serve``: Granite and SeamlessM4T-v2 through
   ``generate_batch``, 8 requests in batches of 4, 128-token prompts, 32
   out, decode-equals-forward; one full-width DeepSeek-V3 MoE layer,
   1.34e10 params drawn on the card, served); the three MoE dispatches on
   a reduced Granite (phase ``moe_dispatch``: equal outputs and norms
   with no token dropped, deterministic sums bitwise); full-width
   SeamlessM4T-large-v2 (phase ``encdec_main_path``: 12 + 12 layers,
   d_model 1024, GELU d_ff 8192, vocab 256 206, bf16, remat, flash;
   B = 8, 512 source frames, 512 target tokens) under bk (``gram_norm``
   193 a step) and ``auto`` flat, flash 60 / 36 / 36 a pass (encoder
   full, decoder causal, cross full over the source, the decoder's
   forward again under remat).
9i. the SSM and hybrid families (``run_recurrent``): xLSTM-125M at full
   width cut to 4 of its 12 layers (phase ``ssm_main_path``: one
   super-block of 3 mLSTM and 1 sLSTM, d_model 768, vocab 50 304, bf16;
   B = 8, T = 128) under bk (``gram_norm`` 23 a step), ``auto`` stale (``gram_norm_fused`` once a
   fused dense of the stack, as its plan says) and ``auto`` flat (no
   kernel of this repo: its plan realizes every norm with the plain
   versions); Zamba2-2.7B at full width cut to 1 super-block (phase
   ``hybrid_main_path``: 6 Mamba2 layers and the shared attention + MLP
   block applied once, d_model 2560, bf16, remat; B = 4, T = 512) under
   bk (``gram_norm`` 20 a step) and ``auto`` flat; on each, in f32 at
   full width on 2 examples at the lane's T (Zamba2's first 256 of its
   512 tokens), bk's group norms (the
   ``local_vjp`` and the shared block's folded groups included) against
   ``naive``'s, each example alone and the two together
   (``recurrent_exactness``), and on Zamba2 bk's clipped sums with
   ``remat=True`` bitwise those with ``remat=False``; then serving both
   (phase ``ssm_serve``, beside the CLI lanes' processes: xLSTM not
   cut, Zamba2 cut to 18 of its 54 layers; prompts prefilled one
   token at a time), held decode-equals-forward (``serve_checks_f32_ref``:
   bf16 within twice the bf16 forward's distance from the f32 forward,
   f32 within RECURRENT_F32_OF_LARGEST of the largest logit; one
   ``generate_batch`` pass a model, its prefill and decode steps timed
   in place).  Each recurrent lane runs one timed step, none profiled
   (stale: the bootstrap and a stale step timed).
10. ``gram_norm_tokmask`` at its own entry point (no model path calls it,
   as in the JAX package): once on Llama-3.2-1B's embedding cotangent
   shape (B = 8, T = 1024, D = 2048, bf16, the token ids of a synthetic
   batch), checked against ``kinds.embed_norm_sq``'s segment sum.
11. 1-D conv lane: a network of five plain 1-D convs (AlexNet's conv
   widths at stride 1, ReLU, mean over time, a 10-class dense head, f32),
   B = 32, T = 4096, σ = 1: 3 ``private_step``s each of crb and ``auto``
   flat with ``conv_impl="pallas"``; the crb lane must launch
   ``pe_conv_grad_1d`` 5 times each step; then crb(kernel) against
   crb(grouped conv) on one batch at σ = 0.
12. calibrated plans: full-width AlexNet and VGG16 ``auto`` flat and
   stale, planned under the measured calibration beside the analytic
   plan: both fingerprints, the layers whose realization differs, and
   ``predicted_step_seconds`` against the lane's measured step.
13. CLI lanes: ``python -m repro_torch.launch.train`` in a process of its
   own, twice per lane (the AlexNet lanes' six processes at once, then
   the Llama lane's two; beside the AlexNet processes this process
   serves, phases 14, 15 and ``ssm_serve``, and the Llama pair waits
   for phase 14, ``cli_lanes_beside_serving``), once straight through
   and once with ``--fail-at 3`` (it restarts from its step-1
   checkpoint): full-width AlexNet ``auto`` flat and stale (B = 32, 4
   steps, checkpoint every 2),
   AlexNet ``auto`` stale with ``--calibration`` the blob of phase 4 (its
   ``[calibrate]`` and ``[replan]`` lines printed; it must end bitwise
   equal to the uncalibrated stale lane where the calibrated tile is the
   shape rule, within f32 tolerance where it forces another), and
   Llama-3.2-1B at full width and depth 2 (B = 8, T = 1024, bf16, flash,
   ``auto``, 4 steps).  The two runs' last checkpoints (params, optimizer
   state, clip state, ledger) must be bitwise equal.
13b. data parallelism on one card (phase ``sharded_main_path``): two
   ranks of one process group on cuda:0 under ``torch.distributed.run``
   with gloo (NCCL's refusal of two ranks on one device is probed and
   printed; gloo's staging of a CUDA tensor through the host is traced):
   full-width AlexNet, B = 32 over ``data:2``, σ = 1, SGD with momentum,
   2 steps each of crb (``conv_impl="pallas"``), ``auto`` flat and
   ``auto`` stale, each lane twice; per rank the step ms, the
   all-reduce's ms and the peak; each rank launches what its plan says;
   the ranks' params bitwise equal, the two runs bitwise equal, and the
   single-device engine's params on the same global batches within the
   bound ``shard_reference`` derives from the f32 sum bound.  Then
   Llama-3.2-1B at full width cut to 1 layer, B = 8, T = 1024, bf16,
   flash, ``auto`` stale on ``data:2``: every flash kernel once a layer
   a step per rank, ``gram_norm_fused`` 5 a layer and step after the
   bootstrap,
   one all-reduce a param leaf (the tied embed/head group once), ranks
   bitwise equal; the collective calibration over the gloo group
   (``measure_collective_bytes_per_second``); ``engine.verify()`` of
   AlexNet ``auto`` stale on a ``data:2`` spec over fake CUDA tensors
   (the sharding pass; kernel nodes equal to a real step's launches);
   and the training CLI under ``torch.distributed.run --nproc_per_node
   2`` with ``--mesh data:2 --backend gloo``, 4 steps, straight and with
   ``--fail-at 2`` at once: the step-3 checkpoints bitwise equal.
13c. model-axis sharding on one card (phase ``model_axis_path``): the
   tensor-sharded step (``PrivacyEngine(param_axes=)``) of gloo ranks
   sharing cuda:0, as 13b's: full-width AlexNet, B = 32, σ = 1, SGD with
   momentum, 2 steps each of crb (``conv_impl="pallas"``), ``auto`` flat
   and ``auto`` stale on ``model:2`` (2 ranks) and on ``data:2,model:2``
   (4 ranks); Llama-3.2-1B at full width cut to 1 layer, B = 8,
   T = 1024, bf16, flash, ``auto`` stale and bk (the kernel norms:
   ``gram_norm`` on every sliced dense) on ``model:2``; each lane twice.
   Per rank: step ms (first run), ms in the model-group and
   the data-group collectives (second run, each collective synchronized
   and timed), peak GB, launches each step against the plan (every flash
   kernel once a layer a step on the rank's 16 of 32 heads), bytes a
   step over ``model`` beside the plan's ``coll_bytes_by_axis``.  The
   ranks of one model slot bitwise equal across data ranks, the two runs
   bitwise equal, AlexNet's gathered params within ``shard_reference``'s
   bound of the single-device step.  The bf16 Llama lanes' params cannot
   show a wrong gradient (lr 1e-4 under AdamW moves none by a bf16 ulp),
   so one f32 gradient of the same model on ``model:2`` (bk, the kernel
   norms, per-layer clipping) is held against one device's: its loss,
   per-example and per-layer norms and gathered gradient
   (``ma_f32_check``); and ``gram_norm`` at each slice shape the
   Llama lanes handed it against its plain version.  Also: the
   collective calibration over the model group, ``engine.verify()`` of
   AlexNet ``auto`` stale on a ``data:2,model:2`` spec over fake CUDA
   tensors (clean, "partitioned over model", its kernel nodes equal to a
   real rank's stale step), and
   the training CLI under ``--nproc_per_node 4 --mesh data:2,model:2
   --backend gloo``, straight and ``--fail-at 2``: the step-3
   checkpoints (whole arrays) bitwise equal.
13d. the MoE family on a model axis (phase ``moe_model_axis_path``, its
   comment below): Granite-3.0-1B-A400M at full width cut to 1 layer on
   ``model:2`` and ``data:2,model:2``, one DeepSeek-V3 MoE layer at full
   width (routed experts cut to 64) on ``model:2``; ranks and runs
   bitwise, within a derived bound of one device, an f32 gradient of
   each (the DeepSeek-V3 layer's at 16 routed experts), the kernels at
   the slice shapes.  In the same two worlds, the attention-only families
   on a model axis (its comment): SeamlessM4T-large-v2 at full width
   cut to 1 + 1 layers on ``model:2`` and ``data:2,model:2``,
   Chameleon-34B (qk-norm on sliced heads) at full width cut to depth 1
   on ``model:2``, remat on; the same checks, an f32 gradient of each.
13e. the recurrent families on a model axis (phase
   ``recurrent_model_axis_path``, its comment below): xLSTM-125M at full
   width cut to 4 layers on 64 of its 128 tokens, bk and ``auto`` stale
   on ``model:2``, ``auto`` flat on ``data:2,model:2``; Zamba2-2.7B at
   full width cut to 1 super-block on 64 of its 512 tokens, bk on
   ``model:2``, ``auto`` flat on ``data:2,model:2``; each recurrence on
   the rank's heads.  Ranks and
   runs bitwise, within a derived bound of one device, the model group's
   all-reduces a step as reckoned from the layers and the same at
   T = 16, an f32 gradient of each, the kernels at the slice shapes.
13f. FSDP on a live mesh (phase ``fsdp_path``, its comment below; its
   lanes run in worlds 13b and 13e start anyway): full-width GLM-4-9B cut
   to 1 layer on ``data:2,model:2`` with ``fsdp=True``, ``auto`` stale
   twice and bk with and without FSDP; each rank's persistent params
   half the replicated lane's, the runs and the two bk lanes bitwise, the
   data group's gather and gradient bytes as reckoned, the kernels at
   GLM's slice shapes; an f32 Llama-3.2-1B gradient under FSDP on
   ``data:2`` against one device's.
   The mesh phases' torchrun worlds start while the phase before runs
   (``World``, ``await_gate``): their ranks import, load the kernel
   libraries and join their gloo group, then wait for the parent's go
   before they touch the card.
14. serving (phase ``serve_lane``): ``launch.serve.generate_batch`` at
   full width on Llama-3.2-1B and GLM-4-9B (40 layers, d_model 4096,
   32/2 heads, head_dim 128, vocab 151 552; bf16, weights drawn on the
   card), 8 requests in batches of 4, 128-token prompts, 32 tokens out:
   prefill ms, decode ms a token, tokens/s, peak memory; then
   decode-equals-forward (prefill and 4 decode steps against one causal
   forward: in bf16 within twice the forward's own spread over another
   length, and on an f32 copy of the weights within the flash rows' f32
   tolerance); serving launches no kernel of this repo.
15. the serving CLI: ``python -m repro_torch.launch.serve --arch glm4-9b
   --n-requests 8 --batch 4 --gen 16`` (reduced) in its own process:
   exit 0 and its ``served`` line.

Each phase prints its seconds.  The kernel cases of phase 3 hold the
conv gradients at VGG16's conv shapes and ``gram_norm`` at its Grams too
(B = 4; conv1's also at B = 32, where x holds 56 % of the 32-bit range;
past T = 16 384 against the plain version's product form in f64).
The kernel cases of phase 3 include ``pe_conv_grad_1d`` (the JAX kernel
test's sweep and the 1-D lane's five layer shapes, f32 and bf16, each
twice to show it bitwise repeatable; per layer its time, its bound (3 x
FLOP at the TF32 rate for f32, the bf16 peak for bf16) and its share of
it, and the bound at the f32 FMA peak its route runs on) and
``gram_norm_tokmask`` (B = 8, T = 1024, D = 2048 in bf16 and f32, random
and heavily repeated ids, a ragged T = 1000; each against the plain
version and the segment sum; each row names its route,
``ops.tokmask_route``), ``gram_norm_fused`` at the five denses the stale
Llama plan fuses (one layer, bf16), and the flash kernels at OLMo-1B's
(8, 1024, 16, 128), at Granite's and Seamless's shapes, and with a key
length S other than T (cross attention: S = T/2, S = 2T, ragged), and
``gram_norm`` at Granite's router (Do = 32) and at the recurrent lanes'
denses (xLSTM's wq, Zamba2's in_proj, a shared dense folded over its
two applications).

The line before the last is a JSON object with one entry per kernel
(eight, each with its share of its bound); the last line is
``{"ok": true, "device": {...}}``.
"""
import atexit
import functools
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import threading
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
# (name, Di, Do) of the denses a stale plan fuses in each layer of
# full-width Llama-3.2-1B (tests/test_torch_planner.py holds the plan).
LM_FUSED_CASES = [("llama_wq", 2048, 2048), ("llama_wo", 2048, 2048),
                  ("llama_w_gate", 2048, 8192), ("llama_w_up", 2048, 8192),
                  ("llama_w_down", 8192, 2048)]

# Full-width VGG16 (paper Table 1, 3x256x256, 1000 classes), and its
# kernel cases at a small batch: (name, C, H padded, D, K) of its distinct
# conv shapes, and (name, T, Di, Do) of its Grams (conv im2col, then fc).
VGG16_PARAMS = 169_814_824
VGG_B = 4
VGG_PE_CASES = [("vgg16_conv0", 3, 258, 64, 3), ("vgg16_conv1", 64, 258, 64, 3),
                ("vgg16_conv2", 64, 130, 128, 3),
                ("vgg16_conv3", 128, 130, 128, 3),
                ("vgg16_conv4", 128, 66, 256, 3),
                ("vgg16_conv5", 256, 66, 256, 3),
                ("vgg16_conv7", 256, 34, 512, 3),
                ("vgg16_conv8", 512, 34, 512, 3),
                ("vgg16_conv10", 512, 18, 512, 3)]
VGG_GRAM_CASES = [("vgg16_conv0", 65536, 27, 64),
                  ("vgg16_conv1", 65536, 576, 64),
                  ("vgg16_conv2", 16384, 576, 128),
                  ("vgg16_conv3", 16384, 1152, 128),
                  ("vgg16_conv4", 4096, 1152, 256),
                  ("vgg16_conv5", 4096, 2304, 256),
                  ("vgg16_conv7", 1024, 2304, 512),
                  ("vgg16_conv8", 1024, 4608, 512),
                  ("vgg16_conv10", 256, 4608, 512),
                  ("vgg16_fc0", 1, 32768, 4096), ("vgg16_fc1", 1, 4096, 4096),
                  ("vgg16_fc2", 1, 4096, 1000)]
# Past this T the plain gram_norm's T x T Grams do not fit (17 GB an
# example at T = 65 536): its product form, in f64, is the check there.
GRAM_T_PLAIN_MAX = 16384

# Llama-3.2-1B's main-path batch.  gqa_apply repeats K and V to all 32
# query heads before attention (as the JAX package does), so the model
# path runs the flash kernels at rep 1; rep 4 (32 / 8) is checked alone.
LM_B, LM_T, LM_LAYERS = 8, 1024, 16
# Granite-3.0-1B-A400M's lane (B, T, layers), and SeamlessM4T-v2's (B,
# source frames = target tokens, layers of each stack).
GR_B, GR_T, GR_LAYERS = 8, 1024, 24
# The Granite lanes' depth: cut from GR_LAYERS to make room for phase
# moe_model_axis_path in the script's time (12, then 6 when its DeepSeek-V3
# layer grew to 64 routed experts, then 3 beside the attention families'
# model-axis lanes).
GR_DEPTH = 3
SM_B, SM_T, SM_LAYERS = 8, 512, 12
# (case, B, T, H, Hkv, hd, causal, dtype, on the main path)
FLASH_CASES = [("llama_bf16", LM_B, LM_T, 32, 32, 64, True, "bfloat16", True),
               ("llama_f32", LM_B, LM_T, 32, 32, 64, True, "float32", False),
               ("llama_rep4_bf16", LM_B, LM_T, 32, 8, 64, True, "bfloat16",
                False),
               ("olmo_bf16", LM_B, LM_T, 16, 16, 128, True, "bfloat16",
                False),
               ("full_f32", 2, 256, 8, 8, 64, False, "float32", False),
               ("ragged_f32", 2, 100, 4, 2, 64, True, "float32", False),
               # Granite-3.0-1B-A400M's causal calls (K and V repeated to
               # the 16 query heads) and SeamlessM4T-v2's encoder / cross
               # calls (full, S = T = 512 on its lane)
               ("granite_bf16", GR_B, GR_T, 16, 16, 64, True, "bfloat16",
                False),
               ("seamless_full_bf16", SM_B, SM_T, 16, 16, 64, False,
                "bfloat16", False),
               # cross attention with another key length S (the last
               # field): S = T/2, S = 2T, a ragged T over a ragged S
               ("cross_half_bf16", 2, 512, 8, 8, 64, False, "bfloat16",
                False, 256),
               ("cross_double_f32", 2, 256, 8, 4, 64, False, "float32",
                False, 512),
               ("cross_ragged_bf16", 2, 100, 8, 2, 64, False, "bfloat16",
                False, 260),
               ("cross_ragged_f32", 2, 100, 8, 2, 64, False, "float32",
                False, 260)]
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
# The calibration blob the calibrate phase saves (ignored by git).
CALIB_BLOB = ROOT / "build" / "chip_smoke_calibration.json"
# The CLI lanes: (lane, arguments after the module, steps, the lane whose
# final checkpoint this one's is held to, or None).  The calibrated lane
# plans under the calibrate phase's blob and runs the mispredict loop.
_ALEX_STALE = ["--arch", "alexnet", "--full", "--batch", "32", "--strategy",
               "auto", "--clip-mode", "stale", "--noise", "1.0"]
CLI_LANES = [
    ("cli_alexnet_auto_flat",
     ["--arch", "alexnet", "--full", "--batch", "32", "--strategy", "auto",
      "--noise", "1.0"], 4, None),
    ("cli_alexnet_auto_stale", _ALEX_STALE, 4, None),
    ("cli_alexnet_auto_stale_calibrated",
     _ALEX_STALE + ["--calibration", str(CALIB_BLOB.relative_to(ROOT))], 4,
     "cli_alexnet_auto_stale"),
    ("cli_llama_depth2_auto",
     ["--arch", "llama3.2-1b", "--full", "--layers", "2", "--batch",
      str(LM_B), "--seq", str(LM_T), "--strategy", "auto", "--attn-impl",
      "flash", "--noise", "1.0"], 4, None)]
CLI_TIMEOUT_S = 420


class SmokeFailure(Exception):
    pass


T_START = time.perf_counter()
LOG_LOCK = threading.Lock()


def log(obj):
    """One JSON line (a phase's ``*_done`` line also gets the seconds
    since the script started), written whole: the CLI lanes' thread logs
    beside the main thread's serving (``cli_lanes_beside_serving``)."""
    if isinstance(obj, dict) and str(obj.get("phase", "")).endswith("_done"):
        obj = dict(obj, elapsed_s=time.perf_counter() - T_START)
    line = (json.dumps(obj) if isinstance(obj, dict) else str(obj)) + "\n"
    with LOG_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


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
    pe_cases += [(n, VGG_B, c, h, d, k, "float32", False)
                 for n, c, h, d, k in VGG_PE_CASES]
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
    # VGG16's at a small batch, and conv1 at the main path's B = 32
    # (x holds 1.21e9 entries, 56 % of the 32-bit range).
    gram_cases += [(n, VGG_B, t, di, do, "float32", False)
                   for n, t, di, do in VGG_GRAM_CASES]
    gram_cases += [("vgg16_conv1_b32", 32, 65536, 576, 64, "float32",
                    False)]
    # Granite-3.0-1B-A400M's router (d_model x 32 experts), contiguous
    gram_cases += [("granite_router_bf16", GR_B, GR_T, 1024, 32,
                    "bfloat16", False),
                   ("granite_router_f32", GR_B, GR_T, 1024, 32, "float32",
                    False)]
    gram_cases += [(n, b, t, di, do, dt, False)
                   for n, b, t, di, do, dt in RECURRENT_GRAM_CASES]
    contiguous = {"granite_router_bf16", "granite_router_f32"} | {
        c[0] for c in RECURRENT_GRAM_CASES}
    for name, b, t, di, do, dt, main in gram_cases:
        tdt = getattr(torch, dt)
        if name in contiguous:
            x, dy = rnd(b, t, di, dtype=tdt), rnd(b, t, do, dtype=tdt)
        elif t > 1:
            x = rnd(b, di, t, dtype=tdt).transpose(1, 2)
            dy = rnd(b, do, t, dtype=tdt).transpose(1, 2)
        else:
            x, dy = rnd(b, t, di, dtype=tdt), rnd(b, t, do, dtype=tdt)
        got = ops.gram_norm(x, dy, has_bias=True)
        again = ops.gram_norm(x, dy, has_bias=True)
        torch.cuda.synchronize()
        if t <= GRAM_T_PLAIN_MAX:
            plain = functools.partial(ref.gram_norm_ref, x, dy)
            want = plain(has_bias=True)
        else:
            plain = functools.partial(ref.gram_norm_product_ref, x, dy)
            want = ref.gram_norm_product_ref(x.double(), dy.double(),
                                             has_bias=True)
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
               "plain": plain.func.__name__,
               "plain_ms": cuda_ms(torch, lambda: plain(has_bias=True), 3),
               "library_ms": cuda_ms(torch, library, 3),
               "library": "bmm materialize + square-sum (several calls)",
               "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma_ms,
               "main_path": main}
        rows.append(row)
        log(row)
        del x, dy, got, want, plain
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
    ragged and a bf16 case; and at the five denses a stale plan fuses in
    each layer of full-width Llama-3.2-1B (B = 8, T = 1024, bf16, one
    layer of the stack: the (B, T, D) rows the capture holds)."""
    from repro_torch.kernels import ops, ref
    cases = [(n, 32, t, di, do, "float32", True)
             for n, t, di, do in FUSED_CASES]
    cases += [("conv3_contiguous", 32, 225, 3456, 256, "float32", False),
              ("ragged", 3, 100, 70, 33, "float32", False),
              ("conv2_bf16", 32, 225, 1728, 384, "bfloat16", False)]
    cases += [(n, LM_B, LM_T, di, do, "bfloat16", False)
              for n, di, do in LM_FUSED_CASES]
    rows = []
    for name, b, t, di, do, dt, main in cases:
        tdt = getattr(torch, dt)
        if name.startswith("llama_"):
            x, dy = rnd(b, t, di, dtype=tdt), rnd(b, t, do, dtype=tdt)
        else:
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
        hb = not name.startswith("llama_")     # the LM denses have none
        got = ops.gram_norm_fused(x, dy, w, has_bias=hb)
        again = ops.gram_norm_fused(x, dy, w, has_bias=hb)
        torch.cuda.synchronize()
        want = ref.gram_norm_fused_ref(x, dy, w, has_bias=hb)
        # The norms are sums of squares; the contributions are signed sums
        # over B·T terms whose entries can cancel to near zero, so their
        # error is held against rtol times the largest entry.
        errs = [compare(torch, a, c, dt, floor=f)
                for a, c, f in zip(got, want, (1e-3, 1.0, 1.0))]
        same = all(bool(torch.equal(a, c)) for a, c in zip(got, again))
        del got, again, want

        def library():
            pe = torch.bmm(x.transpose(1, 2).float(), dy.float())
            if not hb:
                return (pe.square().sum((1, 2)),
                        torch.einsum("b,bio->io", w, pe))
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
                   x, dy, w, has_bias=hb), 5),
               "plain_ms": cuda_ms(torch, lambda: ref.gram_norm_fused_ref(
                   x, dy, w, has_bias=hb), 3),
               "library_ms": cuda_ms(torch, library, 3),
               "library": "bmm materialize + square-sum + einsum with w",
               "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma_ms,
               "main_path": main}
        if name.startswith("llama_"):
            row.update(lane="llama_auto_stale", calls_per_step=LM_LAYERS)
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
    for name, b, t, h, hkv, hd, causal, dt, main, *key_len in FLASH_CASES:
        tdt = getattr(torch, dt)
        S = key_len[0] if key_len else t
        q, do = rnd(b, t, h, hd, dtype=tdt), rnd(b, t, h, hd, dtype=tdt)
        k, v = rnd(b, S, hkv, hd, dtype=tdt), rnd(b, S, hkv, hd, dtype=tdt)
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
        # (query, key) pairs the causal mask keeps (T = S when causal);
        # the forward does 2 hd-deep products per pair (q.k, p.v), dq 3
        # (q.k, do.v, ds.k), dk/dv 4 (q.k, do.v, p^T.do, ds^T.q).
        pairs = b * h * (t * (t + 1) // 2 if causal else t * S)
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
                   "shape": {"B": b, "T": t, "S": S, "H": h, "Hkv": hkv,
                             "hd": hd, "causal": causal},
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
    """Phase 5: the toy CNN's clipped sums on the card equal the CPU's."""
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
    """Phase 5 (LM): a reduced Llama-3.2-1B (2 layers, head_dim 16, f32,
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


def _sum_close(torch, got, want, what):
    """The JAX package's f32 clipped-sum tolerance
    (``tests/test_exactness.py`` ``_sum_tol``): rtol 3e-3, atol 3e-4 of
    the largest entry (at least 1)."""
    from repro_torch.tree import get_subtree, leaf_paths
    paths = leaf_paths(want)
    scale = max(max(get_subtree(want, q).abs().max().item() for q in paths),
                1.0)
    tree_close(torch, got, want, 3e-3, 3e-4 * scale, what)


def dp_attn_parity(torch):
    """Phase 5b: the block-level ``"attn"`` tap on the card, f32, σ = 0.
    Reduced Llama-3.2-1B (2 layers, ``attn_impl="flash"``) with
    ``dp_attn=True`` under bk's ``attn_norm`` ghost and pe gives the
    per-example norms (rtol 1e-4) and clipped sums (the reference's f32
    sum tolerance) of ``dp_attn=False`` on the same params and batch: the
    same function, realized by a layer-local recompute, which launches
    the flash kernels once more a layer for the norm and once more for
    the contribution.  Then reduced MLA (``attn_impl="xla"``) does the
    same, and its prefill plus decode (absorbed and not) equals one causal
    forward within the flash rows' f32 tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.core import clipped_grad_sum
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models.lm import TransformerLM
    base = get_config("llama3.2-1b")
    rec = {}
    for lane, cfg in (("llama_flash",
                       base.reduced().replace(attn_impl="flash")),
                      ("mla_xla", base.replace(mla=True).reduced()
                       .replace(attn_impl="xla"))):
        plain = TransformerLM(cfg)
        blk = TransformerLM(cfg.replace(dp_attn=True))
        params, _ = plain.init(3, device="cuda")
        b = SyntheticLMDataset(cfg.vocab, 16, n_examples=8).batch(range(4))
        batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        _, want_sum, want_n = clipped_grad_sum(plain.apply, params, batch,
                                               l2_clip=0.05, strategy="bk")
        for method in ("ghost", "pe"):
            ops.reset_launches()
            _, got_sum, got_n = clipped_grad_sum(
                blk.apply, params, batch, l2_clip=0.05, strategy="bk",
                attn_norm=method)
            fwd = ops.LAUNCHES["flash_fwd"]
            want_fwd = 3 * cfg.n_layers if cfg.attn_impl == "flash" else 0
            check(fwd == want_fwd, f"{lane} dp_attn {method}: {fwd} flash "
                  f"forward launches, expected {want_fwd}")
            check(torch.allclose(got_n, want_n, rtol=1e-4),
                  f"{lane} dp_attn {method}: norms differ by "
                  f"{(got_n / want_n - 1).abs().max().item():.3e}")
            _sum_close(torch, got_sum, want_sum,
                       f"{lane} dp_attn {method} clipped sum")
            rec[f"{lane}_{method}"] = {
                "norm_rel_err": (got_n / want_n - 1).abs().max().item(),
                "flash_fwd_launches": fwd}
    cfg = base.replace(mla=True).reduced()
    params, _ = TransformerLM(cfg).init(3, device="cuda")
    prompts = torch.from_numpy(SyntheticLMDataset(cfg.vocab, 8, n_examples=8)
                               .batch(range(2))["tokens"]).cuda()
    for absorbed in (False, True):
        m = TransformerLM(cfg.replace(mla_absorbed_decode=absorbed))
        logits, cache = m.prefill(params, prompts, max_len=12)
        outs, toks = [logits], []
        for _ in range(4):
            toks.append(torch.argmax(outs[-1], -1))
            logits, cache = m.decode_step(params, cache, toks[-1])
            outs.append(logits)
        with torch.no_grad():
            full = m.logits(params, torch.cat(
                [prompts, torch.stack(toks, 1)], 1))
        errs = [flash_close(torch, o, full[:, 7 + i])
                for i, o in enumerate(outs)]
        check(all(e[2] for e in errs), f"MLA decode (absorbed={absorbed}) "
              f"differs from the forward: {[e[:2] for e in errs]}")
        rec[f"mla_decode_absorbed_{str(absorbed).lower()}"] = {
            "max_abs_err": max(e[0] for e in errs),
            "max_rel_err": max(e[1] for e in errs)}
    log({"phase": "dp_attn_parity", "ok": True, "checks": rec})


def planned_needs(eng, steps):
    """The launches each step of a planned lane must make, read off its
    plan: ``pe_conv_grad_2d`` once per plain conv (stride and dilation 1,
    one group) the plan materializes (``pe``), ``gram_norm_fused`` once
    per fused layer (once per layer of a scanned stack).  A stale lane's
    step 0 is the flat bootstrap, under the flat plan."""
    from repro_torch.core import costmodel

    def count(plan):
        pe = fused = 0
        for n, lp in plan.layers.items():
            st = plan.metas[n].static
            plain = (st.get("groups", 1) == 1
                     and all(v == 1 for v in _pair(st.get("stride", 1)))
                     and all(v == 1 for v in _pair(st.get("dilation", 1))))
            pe += lp.kind == "conv" and lp.norm_method == "pe" and plain
            # a scanned layer's fused pass runs once a layer of its stack
            fused += lp.fused * math.prod(
                plan.tap_shapes[n].shape[:plan.metas[n].scanned])
        return pe, fused

    pe, fused = count(eng.plan())
    if eng.dp.clipping.mode != "stale":
        return {"pe_conv_grad_2d": [pe] * steps,
                "gram_norm_fused": [0] * steps}
    flat = costmodel.get_plan(
        eng.apply_fn, eng._params_spec, eng._batch_spec,
        **dict(eng._planner_opts(), clip_mode="flat"))
    return {"pe_conv_grad_2d": [count(flat)[0]] + [pe] * (steps - 1),
            "gram_norm_fused": [0] + [fused] * (steps - 1)}


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def run_lanes(torch, phase, model, params, batches, runs, lanes, launches,
              steps=3, n_examples=4096, lr=1e-3, named=(), also_needs=None,
              no_kernel=False, profile=True):
    """Each lane of ``runs`` — (lane, strategy, clipping, norm knobs, the
    launches each step must make: a dict, or a function of the engine
    and the step count, such as ``planned_needs``, which reads them off
    the lane's plan; optionally the planner's per-layer overrides) —
    through ``PrivacyEngine``, σ = 1, C = 1, AdamW: ``steps`` timed
    ``private_step``s with the launch counts set to 0 before each step
    and read after it, then one profiled step (``named``: kernel name
    parts whose device time it reports).  Adds the counts to
    ``launches`` and each lane's, step by step, to ``lanes``;
    ``also_needs`` adds launches every lane must make; ``profile=False``
    skips the profiled step.  A lane must launch some kernel of the repo,
    or, with ``no_kernel``, none.
    Returns {lane: {"step_ms", "norms0" (step 0's per-example norms),
    "plan" (the realizations of a planned lane), "profiled" (the
    profiled step), "peak_mem_gb"}}."""
    from repro_torch.core import DPConfig, PrivacyEngine
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw_init
    out = {}
    for lane, strategy, clipping, norm, needs, *rest in runs:
        B = int(next(iter(batches[0].values())).shape[0])
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy=strategy,
                      norm=norm, clipping=clipping,
                      overrides=rest[0] if rest else ())
        eng = PrivacyEngine(model.apply, params, batches[0], dp,
                            optimizer="adamw", lr=lr, run_seed=0,
                            sampling_rate=B / n_examples, device="cuda")
        plan = realized = None
        if strategy == "auto":
            plan = eng.explain()
            realized = eng.plan().realizations()
        if callable(needs):
            needs = needs(eng, steps)
        needs = dict(needs, **(also_needs or {}))
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
            if s == 0:
                norms0 = aux["per_example_norms"].detach().clone()
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = {k: sum(c[k] for c in per_step) for k in ops.LAUNCHES}
        for k, v in counts.items():
            launches[k] += v
        lanes[lane] = {k: [c[k] for c in per_step]
                       for k, v in counts.items() if v}
        prof = profile_step(torch, lambda: eng.private_step(
            p, opt, batches[steps], step=steps), top=10 if named else 8,
            named=named) if profile else {}
        check(all(math.isfinite(v) for v in losses),
              f"{lane}: non-finite loss {losses}")
        for k, want in needs.items():
            got = [c[k] for c in per_step]
            check(got == want,
                  f"{lane}: {k} launches per step {got}, expected {want}")
        if no_kernel:
            check(not any(counts.values()),
                  f"{lane}: launched {counts}, expected no kernel")
        else:
            check(any(sum(w) for w in needs.values()),
                  f"{lane}: no kernel of the lane launched")
        log({"phase": phase, "lane": lane, "strategy": strategy,
             "clipping": dataclass_dict(clipping) if not isinstance(
                 clipping, str) else clipping,
             "norm": dataclass_dict(norm), "batch": B, "plan": plan,
             "plan_realizations": realized, "losses": losses,
             "step_ms": step_ms, "step_ms_after_first": step_ms[1:],
             "launches": counts, "launches_each_step": per_step,
             "launches_per_step": {k: v / steps for k, v in counts.items()},
             "peak_mem_gb": peak, "profiled_step": prof,
             "clip_fraction": float(aux["clip_fraction"]),
             "report": eng.report()})
        out[lane] = {"step_ms": step_ms, "norms0": norms0, "plan": realized,
                     "profiled": prof, "peak_mem_gb": peak}
        del p, opt, eng, aux
        torch.cuda.empty_cache()
    return out


def image_batches(torch, img, classes, B, n, n_examples=4096):
    """``n`` synthetic image batches of ``B`` on the card, from seed 0."""
    import numpy as np
    from repro_torch.data import SyntheticImageDataset
    ds = SyntheticImageDataset(img, classes, n_examples=n_examples, seed=0)
    out = []
    for s in range(n):
        b = ds.batch(range(s * B, (s + 1) * B))
        out.append({"img": torch.from_numpy(b["img"]).cuda(),
                    "label": torch.from_numpy(
                        b["label"].astype(np.int64)).cuda()})
    return out


def main_path(torch, lanes, launches, timings):
    """Phase 6: full-width AlexNet DP-SGD steps through the engine; each
    lane's launches, step by step, go to ``lanes``, its step ms to
    ``timings``."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, NormCfg, clipped_grad_sum
    from repro_torch.models.cnn import CNN

    cfg = get_config("alexnet")
    check(cfg.img_size == IMG and cfg.n_classes == 1000, "alexnet config")
    model = CNN(cfg)
    params, _ = model.init(0, device="cuda")
    n_params = sum(v.numel() for layer in params.values()
                   for v in layer.values())
    t0 = time.perf_counter()
    batches = image_batches(torch, IMG, 1000, B, 5)
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
    out = run_lanes(torch, "main_path", model, params, batches, runs, lanes,
                    launches, steps)
    timings["alexnet"] = {k: v["step_ms"] for k, v in out.items()}
    alexnet_per_layer(torch, model, params, batches, lanes, launches,
                      timings)

    # Kernel realizations against the grouped-conv (library) route on one
    # batch at σ = 0: norms and clipped sums (f32 sums in another order).
    b = batches[4]
    timed = {}

    def run(name, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = clipped_grad_sum(model.apply, params, b, l2_clip=1.0, **kw)
        torch.cuda.synchronize()
        timed[name] = (time.perf_counter() - t) * 1e3
        return res

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
    del sum_f1, sum_f2, sum_u, sum_fgc, params, batches
    torch.cuda.empty_cache()


def alexnet_per_layer(torch, model, params, batches, lanes, launches,
                      timings):
    """Phase 6 (alexnet_per_layer): full-width AlexNet, ``auto`` under
    per_layer clipping with uniform and auto (tracked-quantile) budgets;
    each step launches what the plan says (``planned_needs``: conv1's
    ``pe_conv_grad_2d``)."""
    from repro_torch.core import ClipPolicy, NormCfg
    t = time.perf_counter()
    auto = NormCfg(conv_impl="pallas")
    runs = [("auto_per_layer_uniform", "auto", ClipPolicy(mode="per_layer"),
             auto, planned_needs),
            ("auto_per_layer_auto", "auto",
             ClipPolicy(mode="per_layer", budgets="auto"), auto,
             planned_needs)]
    out = run_lanes(torch, "alexnet_per_layer", model, params, batches, runs,
                    lanes, launches)
    timings["alexnet"].update({k: v["step_ms"] for k, v in out.items()})
    log({"phase": "alexnet_per_layer_done",
         "seconds": time.perf_counter() - t})


def vgg16_main_path(torch, lanes, launches, timings):
    """Phase 7 (vgg16_main_path): full-width VGG16 (3x256x256, 1000 classes,
    169 814 824 params, not cut), B = 32: crb with the conv kernel
    (``pe_conv_grad_2d`` at all 13 convs), ghost and bk with the kernel
    norms (``gram_norm`` once a layer, 16), ``auto`` flat, per_layer and
    stale (the launches the plan says).  crb falls back to B = 16 alone
    if B = 32 does not fit the card, and says so.  Step 0's per-example
    norms of every lane (the same params and batch) must equal crb's."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, NormCfg
    from repro_torch.models.cnn import CNN, VGG16

    t0 = time.perf_counter()
    cfg = get_config("vgg16")
    check(cfg.img_size == IMG and cfg.n_classes == 1000, "vgg16 config")
    model = CNN(cfg)
    params, _ = model.init(0, device="cuda")
    n_params = sum(v.numel() for layer in params.values()
                   for v in layer.values())
    check(n_params == VGG16_PARAMS, f"vgg16 params {n_params}")
    batches = image_batches(torch, IMG, 1000, B, 4)
    log({"phase": "vgg16_setup", "arch": "vgg16", "img": IMG,
         "classes": 1000, "params": n_params, "batch": B,
         "setup_s": time.perf_counter() - t0})
    n_conv, n_layers = len(VGG16), len(VGG16) + 3
    steps = 3
    kern = NormCfg(dense="pallas", conv="pallas")
    auto = NormCfg(conv_impl="pallas")
    crb = [("vgg16_crb", "crb", "flat", NormCfg(conv_impl="pallas"),
            {"pe_conv_grad_2d": [n_conv] * steps})]
    try:
        out = run_lanes(torch, "vgg16_main_path", model, params, batches,
                        crb, lanes, launches, steps)
        crb_batch = B
    except torch.cuda.OutOfMemoryError as e:
        oom, crb_batch = str(e).splitlines()[0], B // 2
    if crb_batch != B:
        # outside the except clause, so the failed lane's tensors are free
        torch.cuda.empty_cache()
        log({"phase": "vgg16_main_path", "lane": "vgg16_crb",
             "note": f"crb at B = {B} does not fit the card ({oom}); "
                     f"B = {crb_batch} for this lane alone"})
        half = [{k: v[:crb_batch] for k, v in b.items()} for b in batches]
        out = run_lanes(torch, "vgg16_main_path", model, params, half, crb,
                        lanes, launches, steps)
    runs = [("vgg16_ghost", "ghost", "flat", kern,
             {"gram_norm": [n_layers] * steps}),
            ("vgg16_bk", "bk", "flat", NormCfg(dense="pallas", conv="pallas",
                                               conv_impl="pallas"),
             {"gram_norm": [n_layers] * steps}),
            ("vgg16_auto_flat", "auto", "flat", auto, planned_needs),
            ("vgg16_auto_per_layer", "auto", ClipPolicy(mode="per_layer"),
             auto, planned_needs),
            ("vgg16_auto_stale", "auto", "stale", auto, planned_needs)]
    out.update(run_lanes(torch, "vgg16_main_path", model, params, batches,
                         runs, lanes, launches, steps))
    ref_norms = out["vgg16_crb"]["norms0"]
    rel = {}
    for lane, o in out.items():
        n = o["norms0"][:crb_batch]
        rel[lane] = ((n - ref_norms).abs() / ref_norms).max().item()
        check(rel[lane] <= 1e-4,
              f"{lane}: step-0 norms vs crb's, rel {rel[lane]:.3e}")
    timings["vgg16"] = {k: v["step_ms"] for k, v in out.items()}
    log({"phase": "vgg16_checks", "ok": True, "crb_batch": crb_batch,
         "step0_norms_max_rel_vs_crb": rel,
         "seconds": time.perf_counter() - t0})
    del params, batches
    torch.cuda.empty_cache()


# The paper's toy CNNs (Figs 1-3) at toy_cnn_config's defaults (c0 = 25,
# 256 px, 10 classes): (name, L, channel rate, kernel, c0).
TOY_CNNS = [("toy_L4_r2_k3", 4, 2.0, 3, 25), ("toy_L4_r2_k5", 4, 2.0, 5, 25),
            ("toy_L3_r1_k5_c32", 3, 1.0, 5, 32)]


def toy_cnns(torch, lanes, launches):
    """Phase 8 (toy_cnns): the toy CNNs of TOY_CNNS, B = 32, under crb (the
    conv kernel at every conv), ghost and bk (the kernel norms, once a
    layer) and ``auto`` flat (what the plan says)."""
    from repro_torch.core import NormCfg
    from repro_torch.models.cnn import CNN, toy_cnn_config
    t0 = time.perf_counter()
    steps = 3
    for name, L, rate, k, c0 in TOY_CNNS:
        cfg = toy_cnn_config(L, rate, kernel=k, c0=c0)
        check(cfg.img_size == IMG and cfg.n_classes == 10, "toy config")
        model = CNN(cfg)
        params, _ = model.init(0, device="cuda")
        batches = image_batches(torch, IMG, 10, B, steps + 1)
        runs = [(f"{name}_crb", "crb", "flat", NormCfg(conv_impl="pallas"),
                 {"pe_conv_grad_2d": [L] * steps}),
                (f"{name}_ghost", "ghost", "flat",
                 NormCfg(dense="pallas", conv="pallas"),
                 {"gram_norm": [L + 1] * steps}),
                (f"{name}_bk", "bk", "flat",
                 NormCfg(dense="pallas", conv="pallas", conv_impl="pallas"),
                 {"gram_norm": [L + 1] * steps}),
                (f"{name}_auto_flat", "auto", "flat",
                 NormCfg(conv_impl="pallas"), planned_needs)]
        out = run_lanes(torch, "toy_cnns", model, params, batches, runs,
                        lanes, launches, steps)
        ref_norms = out[f"{name}_crb"]["norms0"]
        for lane, o in out.items():
            rel = ((o["norms0"] - ref_norms).abs() / ref_norms).max().item()
            check(rel <= 1e-4, f"{lane}: step-0 norms vs crb's, rel "
                               f"{rel:.3e}")
        log({"phase": "toy_cnn_setup", "model": name,
             "channels": list(cfg.cnn_channels), "kernel": k,
             "params": sum(v.numel() for layer in params.values()
                           for v in layer.values())})
        del params, batches
        torch.cuda.empty_cache()
    log({"phase": "toy_cnns_done", "seconds": time.perf_counter() - t0})


def calibrate_phase(torch):
    """Phase 4 (calibrate): ``calibrate.measure()`` on the card at full sizes
    (f32 matmul at n = 8192 with TF32 off, a 1 GiB stream, the
    ``pe_conv_grad_2d`` tile sweep, ``gram_norm_fused``'s time); every
    tile candidate at every swept shape, and the plain version, held to
    the f32 sum bound; the blob saved under ``build/`` and loaded back
    strictly.  The HBM reading must not exceed the data sheet's rate (a
    higher one would have come from the L2)."""
    from repro_torch import calibrate
    from repro_torch.calibrate import harness
    from repro_torch.core import costmodel
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    calib = calibrate.measure()
    measure_s = time.perf_counter() - t0
    check(calib.hbm_bytes_per_second <= PEAK_BYTES,
          f"HBM {calib.hbm_bytes_per_second:.4g} B/s exceeds the data "
          f"sheet's {PEAK_BYTES:.4g}: the stream read the L2")
    g = torch.Generator(device="cuda").manual_seed(5)
    held = {}
    for name, C, H, D, K in harness.PE_TILE_SHAPES:
        Bt, hp = harness.PE_TILE_BATCH, H - K + 1
        x = torch.randn(Bt, C, H, H, generator=g, device="cuda")
        dy = torch.randn(Bt, D, hp, hp, generator=g, device="cuda")
        want = ref.pe_conv_grad_2d_ref(x, dy, K, K)
        outs, mults = {}, {}
        for rows in ops.PE_TILE_ROWS:
            outs[rows] = ops.pe_conv_grad_2d(x, dy, KH=K, KW=K,
                                             tile_rows=rows)
            mults[str(rows)], p_mult, ok = sum_rule(
                outs[rows], want,
                lambda a, b_, K=K: ref.pe_conv_grad_2d_ref(a, b_, K, K),
                x, dy, hp * hp)
            check(ok, f"calibrate: tile_rows {rows} at {name}: "
                      f"{mults[str(rows)]:.3f}x (plain {p_mult:.3f}x) the "
                      f"f32 sum bound")
        held[name] = {"bound_multiple": mults, "plain_bound_multiple": p_mult,
                      "rule_rows": ops.pe_conv_tile_rule(D),
                      "tiles_bitwise_equal": all(
                          torch.equal(outs[0], o) for o in outs.values())}
        del x, dy, want, outs
    torch.cuda.empty_cache()
    CALIB_BLOB.parent.mkdir(parents=True, exist_ok=True)
    calibrate.save_calibration(str(CALIB_BLOB), calib)
    check(calibrate.load_calibration(str(CALIB_BLOB)) == calib,
          "the saved calibration did not load back equal")
    pe = calib.kernels["pe_conv_grad"]
    log({"phase": "calibrate", "card": nvidia_smi_line(),
         "hardware": calib.hardware,
         "flops_per_second": calib.flops_per_second,
         "hbm_bytes_per_second": calib.hbm_bytes_per_second,
         "hbm_flops_per_byte": calib.hbm_flops_per_byte(),
         "analytic": costmodel.ANALYTIC_FALLBACK,
         "pe_conv_grad_tile_rows": pe["tile_rows"], "sweep": pe["sweep"],
         "sweep_by_shape": pe["by_shape"], "sweep_batch": pe["batch"],
         "gram_norm_fused": calib.kernels["gram_norm_fused"],
         "digest": calib.digest(), "blob": str(CALIB_BLOB.relative_to(ROOT)),
         "tiles_held_to_sum_bound": held, "measure_s": measure_s,
         "seconds": time.perf_counter() - t0})
    return calib


def calibrated_plans(torch, calib, timings):
    """Phase 12 (calibrated_plans): full-width AlexNet and VGG16 (B = 32, by
    shape on the meta device) ``auto`` flat and stale, planned under the
    measured calibration beside the analytic plan: both fingerprints,
    every layer whose realization differs, and each plan's
    ``predicted_step_seconds`` against the step its lane measured (mean
    of steps 1-2; the ratio the mispredict loop reads)."""
    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.models.cnn import CNN
    t0 = time.perf_counter()
    out = []
    for arch, lane_of in (("alexnet", {"flat": "auto_flat",
                                       "stale": "auto_stale"}),
                          ("vgg16", {"flat": "vgg16_auto_flat",
                                     "stale": "vgg16_auto_stale"})):
        model = CNN(get_config(arch))
        params, _ = model.init(0, device="meta")
        batch = {"img": torch.empty(B, 3, IMG, IMG, device="meta"),
                 "label": torch.empty(B, dtype=torch.int64, device="meta")}
        for mode, lane in lane_of.items():
            ana = costmodel.get_plan(model.apply, params, batch,
                                     clip_mode=mode, calibration="analytic")
            cal = costmodel.get_plan(model.apply, params, batch,
                                     clip_mode=mode, calibration=calib)
            r_a, r_c = ana.realizations(), cal.realizations()
            measured_ms = sum(timings[arch][lane][1:]) / (
                len(timings[arch][lane]) - 1)
            pred_a = costmodel.predicted_step_seconds(ana, "analytic") * 1e3
            pred_c = costmodel.predicted_step_seconds(cal, calib) * 1e3
            out.append({"arch": arch, "mode": mode, "lane": lane,
                        "analytic_fingerprint": ana.fingerprint,
                        "calibrated_fingerprint": cal.fingerprint,
                        "differing_layers": {
                            n: {"analytic": r_a[n], "calibrated": r_c[n]}
                            for n in r_a if r_a[n] != r_c[n]},
                        "predicted_ms_analytic": pred_a,
                        "predicted_ms_calibrated": pred_c,
                        "measured_ms": measured_ms,
                        "ratio_measured_over_calibrated": measured_ms / pred_c,
                        "ratio_measured_over_analytic": measured_ms / pred_a})
            check(cal.calibration == calib.digest()
                  and ana.fingerprint != cal.fingerprint,
                  f"{arch} {mode}: the calibrated plan is not keyed by the "
                  f"calibration")
    log({"phase": "calibrated_plans", "calibration": calib.digest(),
         "hbm_flops_per_byte": calib.hbm_flops_per_byte(), "plans": out,
         "seconds": time.perf_counter() - t0})


def lm_inputs(torch, arch, widths):
    """Full-width ``arch`` with ``attn_impl="flash"``: (model, params from
    seed 0, four (B, T) synthetic batches on the card).  ``widths``:
    (layers, d_model, heads, KV heads, d_ff, vocab, head_dim), checked
    against the config."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths

    cfg = get_config(arch).replace(attn_impl="flash")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
           cfg.vocab, cfg.hd) == widths and cfg.tie_embeddings
          and cfg.dtype == "bfloat16", f"{arch} config")
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    params, _ = model.init(0, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(get_subtree(params, p).numel()
                   for p in leaf_paths(params))
    t0 = time.perf_counter()
    ds = SyntheticLMDataset(cfg.vocab, LM_T, n_examples=4096, seed=0)
    batches = []
    for s in range(4):
        b = ds.batch(range(s * LM_B, (s + 1) * LM_B))
        batches.append({k: torch.from_numpy(v).cuda() for k, v in b.items()})
    log({"phase": "lm_setup", "arch": cfg.name, "params": n_params,
         "batch": LM_B, "seq": LM_T, "init_s": init_s,
         "data_s": time.perf_counter() - t0})
    return model, params, batches


def flash_needs(steps, remat=False, passes=1, layers=LM_LAYERS):
    """Each flash kernel's launches a step of ``passes`` passes over the
    ``layers`` attention layers (the capture pass, and the ``dp_attn``
    recomputes, ``attn_passes``): once a layer each (the forward once
    more a layer under remat: the backward's recompute)."""
    return {"flash_fwd": [(passes + remat) * layers] * steps,
            "flash_dq": [passes * layers] * steps,
            "flash_dkv": [passes * layers] * steps}


def attn_passes(plan):
    """The passes over the attention layers a flat planned step runs,
    read off its plan: the capture pass; each ``"attn"`` layer's norm
    phase runs the block's forward and backward again once a layer of
    its stack, its sum phase once more unless the norm stashed the
    per-example grads; the shared weighted backward, where planned, is
    one more pass of the model."""
    n = 1 + int(plan.needs_backward)
    for g in plan.groups:
        if plan.layers[g.members[0]].kind == "attn":
            n += 1 + (g.sum_method == "contrib")
    return n


def lm_main_path(torch, launches, lanes, profiled, llm, phase, prefix):
    """Phases 9 and 9b: full-width LM DP-SGD steps through the engine, bk
    and ``auto`` flat; each step's capture pass must launch every flash
    kernel once a layer.  Adds each lane's flash kernels' device time in
    its profiled step to ``profiled``."""
    from repro_torch.core import NormCfg
    model, params, batches = llm
    steps = 3
    runs = [(f"{prefix}_bk", "bk", "flat", NormCfg(), flash_needs(steps)),
            (f"{prefix}_auto_flat", "auto", "flat", NormCfg(),
             flash_needs(steps))]
    out = run_lanes(torch, phase, model, params, batches, runs, lanes,
                    launches, steps, lr=1e-4, named=FLASH_NAMES)
    for lane, o in out.items():
        profiled[lane] = o["profiled"].get("named", {})
    return out


def lm_clip_modes(torch, launches, lanes, profiled, llm):
    """Phase 9c: full-width Llama-3.2-1B, ``auto`` under per_layer
    (uniform budgets) and stale clipping.  Each step launches what the
    plan says (``planned_needs``: ``gram_norm_fused`` once per fused
    layer of every stack, after the stale lane's flat bootstrap) and the
    flash kernels once a layer.  Names the layers the stale plan fuses,
    or prints its plan if it fuses none."""
    from repro_torch.core import ClipPolicy, NormCfg
    model, params, batches = llm
    steps = 3
    runs = [("llama_auto_per_layer", "auto", ClipPolicy(mode="per_layer"),
             NormCfg(), planned_needs),
            ("llama_auto_stale", "auto", ClipPolicy(mode="stale"), NormCfg(),
             planned_needs)]
    out = run_lanes(torch, "lm_clip_modes", model, params, batches, runs,
                    lanes, launches, steps, lr=1e-4,
                    named=FLASH_NAMES + ("direct_wgmma",),
                    also_needs=flash_needs(steps))
    fused = sorted(n for n, (_, how) in out["llama_auto_stale"]["plan"]
                   .items() if how == "fused")
    entry = {"phase": "lm_clip_modes", "stale_fused_layers": fused,
             "gram_norm_fused_launches_each_step":
                 lanes["llama_auto_stale"].get("gram_norm_fused")}
    if fused:
        named = out["llama_auto_stale"]["profiled"].get("named", {})
        entry["gram_norm_fused_profiled"] = named.get("direct_wgmma")
    else:
        entry["why_no_fused_layer"] = "the stale plan fuses no LM layer"
        entry["plan"] = out["llama_auto_stale"]["plan"]
    log(entry)
    for lane, o in out.items():
        profiled[lane] = o["profiled"].get("named", {})
    return fused


def lm_remat(torch, launches, lanes, llm):
    """Phase 9d: full-width Llama-3.2-1B under bk, flat, with
    ``remat=False`` and ``remat=True``: step ms and peak of each (a
    remat step launches the flash forward twice a layer: the forward and
    the backward's recompute), then the clipped, noise-free gradient sums
    of one batch under each.  The two orders of summation are the same,
    so they must be bitwise equal, or else within the bf16 lane's
    tolerance (rtol 1e-2, atol 1e-5 of the largest entry); the lane says
    which held."""
    from repro_torch.core import NormCfg, clipped_grad_sum
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths
    model, params, batches = llm
    steps = 3
    res, sums = {}, {}
    for remat in (False, True):
        m = TransformerLM(model.cfg.replace(remat=remat))
        lane = f"llama_bk_remat_{str(remat).lower()}"
        out = run_lanes(
            torch, "lm_remat", m, params, batches,
            [(lane, "bk", "flat", NormCfg(),
              flash_needs(steps, remat))],
            lanes, launches, steps, lr=1e-4)
        res[remat] = {"step_ms": out[lane]["step_ms"],
                      "peak_mem_gb": out[lane]["peak_mem_gb"]}
        torch.cuda.reset_peak_memory_stats()
        sums[remat] = clipped_grad_sum(m.apply, params, batches[0],
                                       l2_clip=1.0, strategy="bk")
        res[remat]["clipped_sum_peak_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    (_, g0, n0), (_, g1, n1) = sums[False], sums[True]
    paths = leaf_paths(g0)
    bitwise = torch.equal(n0, n1) and all(
        torch.equal(get_subtree(g0, q), get_subtree(g1, q)) for q in paths)
    held = "bitwise"
    if not bitwise:
        for q in paths:
            a, b = get_subtree(g1, q), get_subtree(g0, q)
            check(torch.allclose(a, b, rtol=1e-2,
                                 atol=1e-5 * b.abs().max().item()),
                  f"remat: clipped sum differs at {'/'.join(q)}")
        check(torch.allclose(n1, n0, rtol=1e-2), "remat: norms differ")
        held = "bf16 tolerance"
    log({"phase": "lm_remat", "lanes": {str(k): v for k, v in res.items()},
         "clipped_sums_equal": held, "ok": True})
    del sums, g0, g1
    torch.cuda.empty_cache()


def lm_dp_attn(torch, launches, lanes, profiled, llm):
    """Phase 9e: full-width Llama-3.2-1B with ``dp_attn=True`` (each
    block's attention tapped as one ``"attn"`` layer), ``auto`` flat as
    planned and with the block pinned to ``ghost`` and to ``pe``.  Prints
    each lane's plan (does the port pick pe, as the reference's record
    ``BENCH_strategies.json`` ``llama32_1b@dp_attn`` does?), step ms,
    peak, busy share and top device time; each step must launch each
    flash kernel once a layer for every pass its plan runs
    (``attn_passes``: the capture pass, the norm phase's recompute, and
    the contribution's unless the norm stashed)."""
    from repro_torch.core import NormCfg
    from repro_torch.models.lm import TransformerLM
    model, params, batches = llm
    model = TransformerLM(model.cfg.replace(dp_attn=True))
    steps = 3
    passes = {}

    def needs(lane):
        def f(eng, steps):
            passes[lane] = attn_passes(eng.plan())
            return dict(planned_needs(eng, steps),
                        **flash_needs(steps, passes=passes[lane]))
        return f

    runs = [(f"llama_dp_attn_{name}", "auto", "flat", NormCfg(),
             needs(f"llama_dp_attn_{name}"), ov)
            for name, ov in (("auto", ()),
                             ("ghost", {"blocks/attn": "ghost"}),
                             ("pe", {"blocks/attn": "pe"}))]
    out = run_lanes(torch, "lm_dp_attn", model, params, batches, runs,
                    lanes, launches, steps, lr=1e-4, named=FLASH_NAMES)
    summary = {}
    for lane, o in out.items():
        profiled[lane] = o["profiled"].get("named", {})
        summary[lane] = {
            "attn_realization": o["plan"]["blocks/attn"],
            "passes": passes[lane], "step_ms": o["step_ms"],
            "peak_mem_gb": o["peak_mem_gb"],
            "busy_share": o["profiled"].get("busy_share"),
            "top": o["profiled"].get("top", [])[:3],
            "flash_launches_each_step": {
                k: lanes[lane].get(k) for k in FLASH_NAMES}}
    log({"phase": "lm_dp_attn", "lanes": summary,
         "auto_picks": out["llama_dp_attn_auto"]["plan"]["blocks/attn"]})


# The static verifier's card lanes (phase dp_verify): (lane, arch, clip
# mode, dp_attn), all ``strategy="auto"`` at full width; the CNNs at
# B = 32, Llama-3.2-1B at B = 8, T = 1024 with flash.
DPV_LANES = [("alexnet_auto_flat", "alexnet", "flat", False),
             ("alexnet_auto_per_layer", "alexnet", "per_layer", False),
             ("alexnet_auto_stale", "alexnet", "stale", False),
             ("vgg16_auto_flat", "vgg16", "flat", False),
             ("llama_auto_stale", "llama3.2-1b", "stale", False),
             ("llama_dp_attn_auto_flat", "llama3.2-1b", "flat", True)]
DPCHECK_ARGS = ["--archs", "alexnet", "vgg16", "llama3.2-1b",
                "--clip-modes", "flat", "per_layer", "stale"]


def verify_lane(torch, lane, model, params, batches, clipping, launches,
                lanes, expect=None):
    """One verifier lane: ``engine.verify()`` on fake CUDA tensors (after
    the flat bootstrap step of a stale lane, so the steady state it
    proves is the step that runs next), then one real ``private_step``.
    The report must hold no error (with ``expect``, a function of the
    report's errors, exactly the errors it accepts), the rise of
    ``torch.cuda.max_memory_allocated`` during ``verify()`` must stay
    under 1 % of the step's peak, and each kernel's nodes in the
    verified graph must equal its launches in the step."""
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg, PrivacyEngine
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw_init
    dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy="auto",
                  norm=NormCfg(conv_impl="pallas"),
                  clipping=ClipPolicy(mode=clipping))
    eng = PrivacyEngine(model.apply, params, batches[0], dp,
                        optimizer="adamw", lr=1e-4, run_seed=0,
                        device="cuda")
    p, opt, step = params, adamw_init(params), 0
    if clipping == "stale":
        p, opt, _, _ = eng.private_step(p, opt, batches[0], step=0)
        step = 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(ops.LAUNCHES)
    t = time.perf_counter()
    report = eng.verify()
    verify_s = time.perf_counter() - t
    rise = torch.cuda.max_memory_allocated() - base
    check(ops.LAUNCHES == before, f"dp_verify {lane}: verify() launched")
    check(report.ok if expect is None else expect(report.errors),
          f"dp_verify {lane}:\n{report.summary()}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    p, opt, loss, _ = eng.private_step(p, opt, batches[step], step=step)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated()
    got = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(math.isfinite(float(loss)), f"dp_verify {lane}: loss {loss}")
    check(report.census["kernels"] == got,
          f"dp_verify {lane}: kernel nodes {report.census['kernels']} != "
          f"launches of the step {got}")
    check(got, f"dp_verify {lane}: the step launched no kernel")
    check(rise < 0.01 * peak, f"dp_verify {lane}: verify() raised the "
          f"peak by {rise} bytes, step peak {peak}")
    for k, v in got.items():
        launches[k] += v
    lanes[f"dp_verify_{lane}"] = {k: [v] for k, v in got.items()}
    log({"phase": "dp_verify", "lane": lane, "verify_s": verify_s,
         "nodes": report.census["nodes"],
         "kernel_nodes": report.census["kernels"], "step_launches": got,
         "verify_peak_rise_bytes": rise, "step_peak_bytes": peak,
         "verify_rise_share_of_step_peak": rise / peak, "step": step,
         "step_ms": step_ms, "checked": report.checked,
         "findings": [str(f) for f in report.findings]})
    del p, opt, eng
    return report


def dispatch_cost(torch):
    """Host microseconds a launch through the custom op's dispatcher adds
    over calling its CUDA implementation directly: ``gram_norm`` at a
    tiny shape (the device's work is negligible), 2000 calls a side,
    direct / op / op / direct, each ended by one synchronise."""
    from repro_torch.kernels import ops
    direct = ops.CUDA_IMPLS["gram_norm"]
    x = torch.randn(4, 2, 8, device="cuda")
    dy = torch.randn(4, 2, 8, device="cuda")
    op = torch.ops.repro_torch.gram_norm
    n, times = 2000, {"direct": [], "op": []}
    for name in ("direct", "op", "op", "direct"):
        fn = direct if name == "direct" else op
        for _ in range(50):
            fn(x, dy, False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn(x, dy, False)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t) * 1e6 / n)
    return {"direct_us_per_call": times["direct"],
            "op_us_per_call": times["op"],
            "dispatch_us_per_launch": (sum(times["op"])
                                       - sum(times["direct"])) / 2}


def dp_verify(torch, launches, lanes, llm):
    """Phase 9g (dp_verify): the static verifier on the card.  Each lane
    of ``DPV_LANES`` verifies clean at full width on fake CUDA tensors
    (``verify_lane``: seconds, nodes, kernel nodes, the peak's rise),
    and its graph's kernel nodes equal the launches of a real step.
    Then one mutant on the card (the clip dropped on AlexNet ``auto``
    flat) must report ``clip_missing`` and ``unclipped_batch_reduction``;
    the dispatcher's cost a launch is measured first (``dispatch_cost``,
    a host time: read before any other process of this phase starts);
    and ``python -m repro_torch.launch.dpcheck`` over the reduced
    AlexNet, VGG16 and Llama-3.2-1B under every clipping mode must exit
    0 (its own process, started next, so its wall time is read beside
    the verifies)."""
    import repro_torch.core.strategies as strategies
    from repro_torch.configs import get_config
    from repro_torch.models.cnn import CNN
    from repro_torch.models.lm import TransformerLM

    t0 = time.perf_counter()
    log(dict({"phase": "dp_verify", "what": "dispatch_cost"},
             **dispatch_cost(torch)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dpcheck",
         *DPCHECK_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # a failing check below exits the script: stop the process with it
    atexit.register(lambda: proc.poll() is None and proc.kill())
    lm_model, lm_params, lm_batches = llm
    cnn = {}
    for lane, arch, clipping, dp_attn in DPV_LANES:
        if arch == "llama3.2-1b":
            model = TransformerLM(lm_model.cfg.replace(dp_attn=dp_attn))
            verify_lane(torch, lane, model, lm_params, lm_batches, clipping,
                        launches, lanes)
            continue
        if arch not in cnn:
            cnn.clear()
            torch.cuda.empty_cache()
            model = CNN(get_config(arch))
            cnn[arch] = (model, model.init(0, device="cuda")[0],
                         image_batches(torch, IMG, 1000, B, 2))
        verify_lane(torch, lane, *cnn[arch], clipping, launches, lanes)
        if lane == "alexnet_auto_flat":
            from repro_torch.core import DPConfig, NormCfg, PrivacyEngine
            model, params, batches = cnn[arch]
            orig = strategies.clip_coefficients
            strategies.clip_coefficients = (
                lambda n, c, eps=1e-12, *, mode="flat": torch.ones_like(n))
            try:
                report = PrivacyEngine(
                    model.apply, params, batches[0],
                    DPConfig(l2_clip=1.0, noise_multiplier=1.0,
                             norm=NormCfg(conv_impl="pallas")),
                    run_seed=0, device="cuda").verify()
            finally:
                strategies.clip_coefficients = orig
            codes = sorted({f.code for f in report.errors})
            check({"clip_missing", "unclipped_batch_reduction"}
                  <= set(codes), f"dp_verify mutant: codes {codes}")
            log({"phase": "dp_verify", "mutant": "alexnet_auto_flat "
                 "clip dropped", "error_codes": codes})
    cnn.clear()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        out, err = proc.communicate(
            timeout=max(CLI_TIMEOUT_S - (t - t0), 1.0))
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"dpcheck: timed out after {CLI_TIMEOUT_S} s") \
            from e
    check(proc.returncode == 0, f"dpcheck: exit {proc.returncode}\n"
          f"{out[-2000:]}\n{err[-4000:]}")
    log({"phase": "dp_verify", "dpcheck": DPCHECK_ARGS,
         "waited_s": time.perf_counter() - t,
         "lines": out.splitlines()[-10:], "ok": True,
         "seconds": time.perf_counter() - t0})


# DeepSeek-V3's first layer at full width (arXiv:2412.19437; the widths
# of configs/deepseek_v3_671b.py): MLA with d_model 7168, 128 heads, q
# rank 1536, kv rank 512, nope 128, rope 64, v 128, and the dense SwiGLU
# the model keeps in its first three layers (hf deepseek-ai/DeepSeek-V3:
# intermediate_size 18432, first_k_dense_replace 3); vocab 129 280,
# untied, bf16.  Cut: one layer, family "dense" (no experts), no remat,
# no FSDP.
DS_D_FF = 18432
DS_B, DS_T = 4, 512


def deepseek_layer0(torch, launches, lanes):
    """Phase 9f: DeepSeek-V3's first layer (``DS_*``; weights drawn on
    the card from a seeded CUDA generator).  Train: ``auto`` flat with
    ``dp_attn=True, attn_impl="xla"`` (the flash kernels take one head
    dim, MLA's q/k are 192 wide and its v 128), B = 4, T = 512, σ = 1,
    3 steps: plan, step ms, peak; MLA runs no kernel of this repo, so
    the lane must launch none.  Serve: 4 prompts of 128 tokens, 32 tokens
    out, with ``mla_absorbed_decode`` off and on: prefill ms, decode ms a
    token, the latent cache's bytes a token, and decode-equals-forward
    (``serve_checks_f32_ref``)."""
    from repro_torch.configs.deepseek_v3_671b import CONFIG
    from repro_torch.core import NormCfg, clipped_grad_sum
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths
    t0 = time.perf_counter()
    cfg = CONFIG.replace(n_layers=1, family="dense", n_experts=0,
                         n_shared_experts=0, topk=0, d_ff=DS_D_FF,
                         remat=False, fsdp=False, attn_impl="xla")
    check((cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
           cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.vocab)
          == (7168, 128, 1536, 512, 128, 64, 128, 129280) and cfg.mla
          and not cfg.tie_embeddings and cfg.dtype == "bfloat16",
          "deepseek-v3 config")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, _ = TransformerLM(cfg).init(gen, device="cuda")
    n_params = sum(get_subtree(params, q).numel() for q in leaf_paths(params))
    ds = SyntheticLMDataset(cfg.vocab, DS_T, n_examples=4096, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                ds.batch(range(s * DS_B, (s + 1) * DS_B)).items()}
               for s in range(4)]
    model = TransformerLM(cfg.replace(dp_attn=True))
    steps = 3
    out = run_lanes(torch, "deepseek_layer0", model, params, batches,
                    [("deepseek_layer0_dp_attn_auto", "auto", "flat",
                      NormCfg(), {})], lanes, launches, steps, lr=1e-4,
                    no_kernel=True)
    train = out["deepseek_layer0_dp_attn_auto"]
    # the DP gradient's own peak, without the optimizer's moments
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clipped_grad_sum(model.apply, params, batches[0], l2_clip=1.0,
                     strategy="auto")
    train["clipped_sum_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del batches
    torch.cuda.empty_cache()

    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device="cuda")
    max_len = SERVE_PROMPT + SERVE_GEN
    serve = {}
    for absorbed in (False, True):
        m = TransformerLM(cfg.replace(mla_absorbed_decode=absorbed))
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        m.prefill(params, prompts, max_len=max_len)            # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = m.prefill(params, prompts, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        tok = torch.argmax(logits, -1)
        t = time.perf_counter()
        for _ in range(SERVE_GEN - 1):
            logits, cache = m.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3 / (SERVE_GEN - 1)
        cache_bytes = sum(v[:, 0, 0].numel() * v.element_size()
                          for v in cache["layers"].values())
        check(cache_bytes == cfg.n_layers * 1152,
              f"deepseek-v3 latent cache: {cache_bytes} B a token")
        peak = torch.cuda.max_memory_allocated() / 1e9
        del logits, cache
        checks = serve_checks_f32_ref(
            torch, f"deepseek-v3 layer 0 absorbed={absorbed}", m, params,
            prompts)
        check(not any(ops.LAUNCHES.values()),
              f"deepseek-v3 serving launched {dict(ops.LAUNCHES)}")
        serve[f"absorbed_{str(absorbed).lower()}"] = {
            "prefill_ms": prefill_ms, "decode_ms_a_token": decode_ms,
            "cache_bytes_a_token": cache_bytes, "peak_mem_gb": peak,
            "decode_equals_forward": checks}
    log({"phase": "deepseek_layer0", "params": n_params,
         "cuts": {"n_layers": 1, "family": "dense", "n_experts": 0,
                  "remat": False, "fsdp": False},
         "batch": DS_B, "seq": DS_T, "train_step_ms": train["step_ms"],
         "train_peak_mem_gb": train["peak_mem_gb"],
         "clipped_sum_peak_gb": train["clipped_sum_peak_gb"],
         "train_plan": train["plan"], "serve": serve,
         "seconds": time.perf_counter() - t0, "ok": True})
    del params
    torch.cuda.empty_cache()


# The serving lanes: (arch, widths as lm_inputs checks them).  8 requests
# in batches of 4, a 128-token prompt, 32 tokens out.
SERVE_ARCHS = [("llama3.2-1b", (16, 2048, 32, 8, 8192, 128256, 64)),
               ("glm4-9b", (40, 4096, 32, 2, 13696, 151552, 128))]
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 4, 128, 32
SERVE_CHECK_STEPS = 4


def decode_vs_forward(torch, model, params, prompts):
    """Prefill ``prompts`` and take SERVE_CHECK_STEPS greedy decode steps;
    returns ([each call's logits], one causal forward's logits over the
    same tokens (``TransformerLM.logits``, the training path), the same
    forward over the prompt and one more token)."""
    logits, cache = model.prefill(params, prompts,
                                  max_len=SERVE_PROMPT + SERVE_GEN)
    outs, toks = [logits], []
    for _ in range(SERVE_CHECK_STEPS):
        toks.append(torch.argmax(outs[-1], -1))
        logits, cache = model.decode_step(params, cache, toks[-1])
        outs.append(logits)
    tokens = torch.cat([prompts, torch.stack(toks, 1)], 1)
    with torch.no_grad():
        return (outs, model.logits(params, tokens),
                model.logits(params, tokens[:, :SERVE_PROMPT + 1]))


def serve_checks(torch, arch, model, params, prompts, rebuild=None,
                 moe_axes=None):
    """Decode-equals-forward at full width, twice.  In the config's bf16
    the serving path's logits must be as close to the full forward's as
    that forward is to itself over a different length (the prompt and one
    token, compared at the two positions both hold: bf16 GEMMs over
    another row count round otherwise): |serve - full| at most twice that
    spread plus one bf16 rounding (2^-8) of the largest logit.  Then on
    an f32 copy of the weights (TF32 off), where the full forward does not
    depend on the length, within the flash rows' f32 tolerance
    (``flash_close``: rtol 1e-4 a entry, 1e-5 of the largest).  Frees
    ``params``; returns the record of both.  ``rebuild(cfg)`` makes the
    f32 model (``TransformerLM`` by default).  For a MoE (``moe_axes``:
    its logical axes) the bf16 half is recorded and not enforced (a
    router's bf16 logits tie often enough that another row count picks
    another expert for some token: a discrete difference, not a rounding
    one), and the f32 half takes ``f32_decode_check``'s rule for another
    order of the sums."""
    moe = moe_axes is not None
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import tree_map
    rebuild = rebuild or TransformerLM
    P = SERVE_PROMPT - 1
    outs, full, short = decode_vs_forward(torch, model, params, prompts)
    err = max((o.float() - full[:, P + i].float()).abs().max().item()
              for i, o in enumerate(outs))
    spread = max((short[:, P + i].float() - full[:, P + i].float()).abs()
                 .max().item() for i in range(2))
    top = full[:, P:].float().abs().max().item()
    bound = 2 * spread + 2 ** -8 * top
    flash_rows = [flash_close(torch, o, full[:, P + i])[2]
                  for i, o in enumerate(outs)]
    check(err <= bound or moe,
          f"{arch} bf16: prefill + decode logits {err:.4g} "
          f"from the full forward's, more than {bound:.4g} (twice its own "
          f"spread over another length, {spread:.4g}, + 2^-8 of {top:.4g})")
    rec = {"bf16": {"max_abs_err": err, "forward_spread": spread,
                    "bound": bound, "largest_logit": top,
                    "within_bound": err <= bound, "enforced": not moe,
                    "within_flash_rows_bf16_tolerance": all(flash_rows)}}
    del outs, full, short
    p32 = tree_map(lambda a: a.float(), params)
    params.clear()
    torch.cuda.empty_cache()
    rec["f32"] = f32_decode_check(
        torch, arch, rebuild(model.cfg.replace(dtype="float32")), p32,
        prompts, order_axes=moe_axes)
    return rec


def embed_permuted(torch, params, axes, seed=0):
    """``params`` with the model width permuted alike along every axis
    labelled "embed" (``axes``: the logical axes ``init`` gives): the
    same function of the tokens, with every sum over the width taken in
    another order."""
    from repro_torch.tree import tree_map
    emb, emb_axes = params["tok_emb"]["emb"], axes["tok_emb"]["emb"]
    width = emb.shape[emb_axes.index("embed")]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    perm = torch.randperm(width, generator=gen, device="cuda")

    def f(a, ax):
        for i, lab in enumerate(ax):
            if lab == "embed":
                a = a.index_select(i, perm)
        return a
    return tree_map(f, params, axes)


def f32_decode_check(torch, arch, m32, p32, prompts, order_axes=None,
                     of_largest=None):
    """The f32 half of decode-equals-forward: prefill and decode of the
    f32 model ``m32`` against its own causal forward, within the flash
    rows' f32 tolerance (``flash_close``).  With ``order_axes`` (a MoE,
    whose f32 rounding runs several times a dense model's: its logical
    axes) the served logits may instead be within twice the distance
    between the f32 forward and the same forward over the width-permuted
    weights (``embed_permuted``: the same sums in another order) plus
    FLASH_ATOL of the largest logit.  With ``of_largest`` (the recurrent
    families) every served logit must be within that share of the
    forward's largest logit instead.  Frees ``p32``."""
    P = SERVE_PROMPT - 1
    outs, full, short = decode_vs_forward(torch, m32, p32, prompts)
    errs = [flash_close(torch, o, full[:, P + i])
            for i, o in enumerate(outs)]
    rec = {"max_abs_err": max(e[0] for e in errs),
           "max_rel_err": max(e[1] for e in errs),
           "rtol": FLASH_RTOL["float32"], "atol_of_largest": FLASH_ATOL,
           "within_flash_rows_tolerance": all(e[2] for e in errs)}
    ok = rec["within_flash_rows_tolerance"]
    if of_largest is not None:
        top = full[:, P:].abs().max().item()
        rec.update(largest_logit=top, of_largest=of_largest,
                   max_abs_err_of_largest=rec["max_abs_err"] / top)
        ok = rec["max_abs_err"] <= of_largest * top
    if order_axes is not None:
        toks = torch.cat([prompts] + [torch.argmax(o, -1)[:, None]
                                      for o in outs[:-1]], 1)
        with torch.no_grad():
            other = m32.logits(embed_permuted(torch, p32, order_axes), toks)
        noise = max((other[:, P + i] - full[:, P + i]).abs().max().item()
                    for i in range(len(outs)))
        del other
        top = full[:, P:].abs().max().item()
        rec.update(forward_order_spread=noise,
                   order_bound=2 * noise + FLASH_ATOL * top)
        ok = ok or rec["max_abs_err"] <= rec["order_bound"]
    check(ok, f"{arch} f32: prefill + decode logits differ from the full "
          f"forward's: {[e[:2] for e in errs]}, {rec}")
    p32.clear()
    del outs, full, short
    torch.cuda.empty_cache()
    return rec


def serve_checks_f32_ref(torch, arch, model, params, prompts,
                         of_largest=None):
    """Decode-equals-forward where ``serve_checks``'s bf16 bound (twice
    the forward's spread over another length plus 2^-8 of the largest
    logit) does not measure the forward's own bf16 error: a model of one
    layer (DeepSeek-V3's first), whose forward hardly depends on the
    length, so that the bound falls below one bf16 ulp of the largest
    logit; and the recurrent families, whose scans run the same
    elementwise steps at any length, so that only the GEMMs' rounding
    moves with it, while through their layers every bf16 rounding grows
    (the forward over another length moved xLSTM-125M's logits by a
    quarter of the largest).  Here the f32 forward (an f32 copy of the
    weights, TF32 off) over the bf16 path's tokens is the reference: the
    served bf16 logits must be within twice the bf16 forward's own
    distance from it plus 2^-8 of the largest logit, so that serving
    rounds no worse than the forward; ``serve_checks``'s bound is
    computed and reported beside it.  The f32 copy's own prefill and
    decode are held by ``f32_decode_check`` (the flash rows' f32
    tolerance, or ``of_largest`` of the largest logit)."""
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import tree_map
    P = SERVE_PROMPT - 1
    outs, full, short = decode_vs_forward(torch, model, params, prompts)
    tokens = torch.cat([prompts] + [torch.argmax(o, -1)[:, None]
                                    for o in outs[:-1]], 1)
    p32 = tree_map(lambda a: a.float(), params)
    m32 = TransformerLM(model.cfg.replace(dtype="float32"))
    with torch.no_grad():
        ref = m32.logits(p32, tokens)[:, P:].float()
    err = max((o.float() - ref[:, i]).abs().max().item()
              for i, o in enumerate(outs))
    fwd_err = (full[:, P:].float() - ref).abs().max().item()
    spread = max((short[:, P + i].float() - full[:, P + i].float()).abs()
                 .max().item() for i in range(2))
    top = ref.abs().max().item()
    bound = 2 * fwd_err + 2 ** -8 * top
    check(err <= bound, f"{arch} bf16: prefill + decode logits {err:.4g} "
          f"from the f32 forward's, more than {bound:.4g} (twice the bf16 "
          f"forward's {fwd_err:.4g} + 2^-8 of {top:.4g})")
    rec = {"bf16": {"max_abs_err_vs_f32_forward": err,
                    "bf16_forward_err_vs_f32_forward": fwd_err,
                    "bound": bound, "largest_logit": top,
                    "forward_spread": spread,
                    "max_abs_err_vs_bf16_forward": max(
                        (o.float() - full[:, P + i].float()).abs().max()
                        .item() for i, o in enumerate(outs)),
                    "serve_checks_bound": 2 * spread + 2 ** -8 * top}}
    del outs, full, short, ref
    rec["f32"] = f32_decode_check(torch, arch, m32, p32, prompts,
                                  of_largest=of_largest)
    return rec


def serve_lane(torch):
    """Phase 14: ``launch.serve.generate_batch`` at full width on
    Llama-3.2-1B and GLM-4-9B (bf16, weights drawn on the card from a
    seeded CUDA generator: no parity rests on them): prefill ms and
    decode ms a token on one batch (and one decode step profiled), the
    requests served in batches (tokens/s), the peak memory; then
    decode-equals-forward
    (``serve_checks``, SERVE_CHECK_STEPS decode steps).  Serving reaches
    no kernel of this repo (the cached attention is the plain softmax,
    as in the JAX package): the counts must stay 0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate_batch
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths
    for arch, widths in SERVE_ARCHS:
        cfg = get_config(arch)
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
               cfg.vocab, cfg.hd) == widths and cfg.dtype == "bfloat16",
              f"{arch} config")
        model = TransformerLM(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params, _ = model.init(gen, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        n_params = sum(get_subtree(params, q).numel()
                       for q in leaf_paths(params))
        prompts = torch.randint(0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT),
                                generator=gen, device="cuda")
        max_len = SERVE_PROMPT + SERVE_GEN
        p0 = prompts[:SERVE_BATCH]
        ops.reset_launches()
        generate_batch(model, params, p0, max_len=max_len, gen=2)  # warm

        # prefill ms, decode ms a token (one batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = model.prefill(params, p0, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        tok = torch.argmax(logits, -1)
        t = time.perf_counter()
        for _ in range(SERVE_GEN - 1):
            logits, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3 / (SERVE_GEN - 1)
        # where a decode step's time goes: the device's busy share
        decode_prof = profile_step(
            torch, lambda: model.decode_step(params, cache, tok), top=5)
        del logits, cache

        # the requests, served in batches
        t = time.perf_counter()
        outs = [generate_batch(model, params,
                               prompts[i:i + SERVE_BATCH], max_len=max_len,
                               gen=SERVE_GEN)
                for i in range(0, SERVE_REQUESTS, SERVE_BATCH)]
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(all(tuple(o.shape) == (SERVE_BATCH, SERVE_GEN) for o in outs)
              and all(bool(((o >= 0) & (o < cfg.padded_vocab)).all())
                      for o in outs), f"{arch}: generated tokens")
        checks = serve_checks(torch, arch, model, params, p0)
        check(not any(ops.LAUNCHES.values()),
              f"{arch}: serving launched {dict(ops.LAUNCHES)}")
        log({"phase": "serve_lane", "arch": arch, "params": n_params,
             "weights_gb": n_params * 2 / 1e9, "init_s": init_s,
             "kv_cache_bytes_a_token": 2 * cfg.n_layers * cfg.n_kv
             * cfg.hd * 2,
             "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
             "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN,
             "prefill_ms": prefill_ms, "decode_ms_a_token": decode_ms,
             "profiled_decode_step": decode_prof, "served_s": served_s,
             "tokens_per_s": SERVE_REQUESTS * SERVE_GEN / served_s,
             "peak_mem_gb": peak, "init_peak_mem_gb": init_peak,
             "decode_equals_forward": checks, "ok": True,
             "sample": outs[0][0, :8].tolist()})
        del params, outs, prompts, model
        torch.cuda.empty_cache()


SERVE_CLI = ["--arch", "glm4-9b", "--n-requests", "8", "--batch", "4",
             "--gen", "16"]


def serve_cli():
    """Phase 15: ``python -m repro_torch.launch.serve`` in a process of
    its own (the reduced GLM-4-9B, as the JAX package's CLI serves it):
    exit code 0 and its ``served`` line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    t = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_CLI],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"serve CLI: timed out after {CLI_TIMEOUT_S} s") \
            from e
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"serve CLI: exit {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    check(lines and lines[-1].startswith("served 8 requests in "),
          f"serve CLI: no served line: {lines[-3:]}")
    log({"phase": "serve_cli", "args": SERVE_CLI, "wall_s": wall,
         "batches": sum(ln.startswith("batch done") for ln in lines),
         "served": lines[-1], "ok": True})


def tokmask_path(torch, launches, lanes):
    """Phase 10: ``gram_norm_tokmask`` through its entry point,
    ``ops.gram_norm_tokmask`` (no model path calls it, as in the JAX
    package), on Llama-3.2-1B's embedding cotangent shape: the token ids
    of a synthetic batch (B = 8, T = 1024) and a bf16 δy (B, T, 2048) from
    a seed.  The norms must be finite, one per example, and equal the
    segment sum the model path runs (rtol 1e-4)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
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
         "segsum_max_rel_err": rel, "launches": counts,
         "seconds": time.perf_counter() - t0})


def conv1d_lane(torch, launches, lanes):
    """Phase 11: DP-SGD on the network of plain 1-D convs (C1_LAYERS),
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


def close_checkpoint(d1, d2, step):
    """The two runs' checkpoints of ``step``, every array within rtol 1e-4
    / atol 1e-6 (f32 sums in another order).  Returns (arrays compared,
    whether they were bitwise equal all the same)."""
    import numpy as np
    name = f"step_{step:09d}"
    with np.load(os.path.join(d1, name, "arrays.npz")) as za, \
            np.load(os.path.join(d2, name, "arrays.npz")) as zb:
        check(sorted(za.files) == sorted(zb.files), "different leaves")
        for k in za.files:
            check(np.allclose(za[k], zb[k], rtol=1e-4, atol=1e-6),
                  f"calibrated run differs from the uncalibrated one at {k}")
        return len(za.files), all(_bitwise_same(np, za[k], zb[k])
                                  for k in za.files)


def cli_lanes(calib, llama_after=None):
    """Phase 13: kill-and-resume through the training CLI, bitwise.  The
    calibrated lane must print its ``[calibrate]`` line and end, where the
    calibrated tile is the shape rule (0), bitwise equal to the
    uncalibrated lane; where it forces another tile, within f32
    tolerance of it.  Each lane's two processes (straight and killed)
    run at once, each with its own checkpoint directory: the AlexNet
    lanes' six together, then (once ``llama_after``, an event, is set)
    the Llama lane's two (all eight do not fit the card), while the
    AlexNet lanes' checkpoints are compared.  Their time is mostly the
    processes' start, the host batch and the checkpoints' writes, so a
    lane's step ms here is read under the others' load."""
    from concurrent.futures import ThreadPoolExecutor
    base = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    tile = calib.kernels["pe_conv_grad"]["tile_rows"]
    alexnet = [c for c in CLI_LANES if c[0].startswith("cli_alexnet")]
    rest = [c for c in CLI_LANES if c not in alexnet]

    def start(pool, wave):
        out = {}
        for lane, args, steps, _ in wave:
            common = args + ["--steps", str(steps), "--ckpt-every", "2"]
            out[lane] = (
                common,
                pool.submit(run_cli, common, str(base / lane / "straight")),
                pool.submit(run_cli, common + ["--fail-at", "3"],
                            str(base / lane / "killed")))
        return out

    with ThreadPoolExecutor(2 * len(alexnet)) as pool:
        first = start(pool, alexnet)
        results = {lane: (common, f1.result(), f2.result())
                   for lane, (common, f1, f2) in first.items()}
        if llama_after is not None:
            llama_after.wait()
        second = start(pool, rest)
        for lane, args, steps, ref_lane in alexnet:
            check_cli_lane(calib, tile, base, lane, steps, ref_lane,
                           results[lane])
        for lane, args, steps, ref_lane in rest:
            common, f1, f2 = second[lane]
            check_cli_lane(calib, tile, base, lane, steps, ref_lane,
                           (common, f1.result(), f2.result()))
    shutil.rmtree(base, ignore_errors=True)


def check_cli_lane(calib, tile, base, lane, steps, ref_lane, result):
    """One CLI lane's checks (``cli_lanes``) and its record."""
    common, (s1, out1, wall1), (s2, out2, wall2) = result
    d_straight, d_killed = str(base / lane / "straight"), \
        str(base / lane / "killed")
    check(s1["restarts"] == 0 and s2["restarts"] == 1,
          f"{lane}: restarts {s1['restarts']}, {s2['restarts']}")
    check("[restore] resuming from step 2" in out2,
          f"{lane}: the killed run did not resume from step 2")
    check(all(math.isfinite(v) for v in s1["losses_last_segment"]
              + s2["losses_last_segment"]), f"{lane}: non-finite loss")
    n = same_checkpoint(d_straight, d_killed, steps - 1,
                        "stale" in lane)
    entry = {"phase": "cli_lane", "lane": lane, "args": common,
             "bitwise_equal_arrays": n, "ok": True,
             "straight": {"wall_s": wall1, **s1},
             "killed_at_3": {"wall_s": wall2, **s2},
             "disk_free_gb": shutil.disk_usage(base).free / 1e9}
    if ref_lane:
        check(all(f"[calibrate] {calib.digest()} " in out
                  for out in (out1, out2)),
              f"{lane}: planned without the calibration")
        entry["calibrate_and_replan_lines"] = [
            ln for ln in (out1 + out2).splitlines()
            if ln.startswith(("[calibrate]", "[replan]"))]
        d_ref = str(base / ref_lane / "straight")
        if tile == 0:
            entry["vs_uncalibrated"] = {
                "tile_rows": 0, "bitwise_equal_arrays":
                    same_checkpoint(d_straight, d_ref, steps - 1, True)}
        else:
            m, bitwise = close_checkpoint(d_straight, d_ref, steps - 1)
            entry["vs_uncalibrated"] = {
                "tile_rows": tile, "arrays_within_f32_tolerance": m,
                "bitwise_equal_all_the_same": bitwise}
    log(entry)


def cli_lanes_beside_serving(torch, calib):
    """Phases 13 (``cli_lanes``), 14, 15 and ``ssm_serve`` at once, for
    the script's time: this thread serves (``serve_lane``: GLM-4-9B's
    weights, 34 GB while they are built), checks Zamba2's shared block
    over two applications (``hybrid_two_applications``, about 15 GB),
    then serves again (``ssm_serve``: Zamba2 cut to 18 layers and its f32
    copy, about 7 GB) beside the AlexNet CLI processes (six, about 4 GB
    each), and ``serve_cli`` runs its own process meanwhile; the Llama
    CLI pair (60 GB) starts once this thread has handed the memory of
    the first two back and the AlexNet processes are done, beside
    ``ssm_serve``.  The serving times are read beside the CLI processes'
    load."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    served = threading.Event()

    def timed_serve_cli():
        t = time.perf_counter()
        serve_cli()
        log({"phase": "serve_cli_done", "seconds": time.perf_counter() - t})

    with ThreadPoolExecutor(2) as pool:
        cli = pool.submit(cli_lanes, calib, served)
        scli = pool.submit(timed_serve_cli)
        try:
            t = time.perf_counter()
            serve_lane(torch)
            torch.cuda.empty_cache()
            log({"phase": "serve_lane_done",
                 "seconds": time.perf_counter() - t})
            t = time.perf_counter()
            hybrid_two_applications(torch)
            log({"phase": "hybrid_two_applications_done",
                 "seconds": time.perf_counter() - t})
        finally:
            served.set()
        ssm_serve(torch)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        scli.result()
        cli.result()
        log({"phase": "cli_lanes_done", "seconds": time.perf_counter() - t0,
             "waited_after_serving_s": time.perf_counter() - t})


# ---------------------------------------------------------------------------
# The MoE and enc-dec families: full-width Granite-3.0-1B-A400M (phase
# moe_main_path), the MoE dispatches on a reduced Granite (moe_dispatch),
# full-width SeamlessM4T-large-v2 (encdec_main_path), their serving and
# one full-width DeepSeek-V3 MoE layer (moe_encdec_serve).

# (layers, d_model, heads, KV heads, expert d_ff, vocab, head_dim,
# experts, top-k) of configs/granite_moe_1b_a400m.py
GR_WIDTHS = (GR_LAYERS, 1024, 16, 8, 512, 49155, 64, 32, 8)
# (encoder layers, decoder layers, d_model, heads, KV heads, d_ff, vocab,
# head_dim) of configs/seamless_m4t_large_v2.py
SM_WIDTHS = (SM_LAYERS, SM_LAYERS, 1024, 16, 16, 8192, 256206, 64)


def param_count(params):
    from repro_torch.tree import get_subtree, leaf_paths
    return sum(get_subtree(params, q).numel() for q in leaf_paths(params))


def lm_flash_needs(eng, steps, fwd_per_pass, bwd_per_pass):
    """Each flash kernel's launches a step of a planned LM lane, read off
    its plan: one pass over the attention layers, one more where the plan
    runs the shared weighted backward; a stale lane's step 0 is the flat
    bootstrap, under the flat plan."""
    from repro_torch.core import costmodel
    plans = [eng.plan()] * steps
    if eng.dp.clipping.mode == "stale":
        plans[0] = costmodel.get_plan(
            eng.apply_fn, eng._params_spec, eng._batch_spec,
            **dict(eng._planner_opts(), clip_mode="flat"))
    passes = [1 + int(p.needs_backward) for p in plans]
    return {"flash_fwd": [n * fwd_per_pass for n in passes],
            "flash_dq": [n * bwd_per_pass for n in passes],
            "flash_dkv": [n * bwd_per_pass for n in passes]}


def planned_lm_needs(fwd_per_pass, bwd_per_pass):
    """``planned_needs`` (gram_norm_fused once per fused layer) with the
    flash launches of ``lm_flash_needs``; a planned step never picks the
    ``gram_norm`` kernel (the planner's dense norms are its plain
    realizations)."""
    def needs(eng, steps):
        out = dict(planned_needs(eng, steps),
                   **lm_flash_needs(eng, steps, fwd_per_pass, bwd_per_pass))
        out["gram_norm"] = [0] * steps
        out.pop("pe_conv_grad_2d")
        return out
    return needs


def plan_summary(eng):
    """The realization of each segmented (expert) layer and the fused
    layers of an engine's plan."""
    plan = eng.plan()
    real = plan.realizations()
    return {"seg_dense": {n: real[n] for n, lp in plan.layers.items()
                          if lp.kind == "seg_dense"},
            "fused": sorted(n for n, lp in plan.layers.items() if lp.fused),
            "needs_backward": plan.needs_backward}


def recording_plan(plans, lane, needs):
    """``needs`` (a dict, or a function of the engine and the step count)
    for ``run_lanes``, recording a planned lane's ``plan_summary`` in
    ``plans``."""
    def f(eng, steps):
        if eng.dp.strategy == "auto":
            plans[lane] = plan_summary(eng)
        return needs(eng, steps) if callable(needs) else needs
    return f


def lane_record(out, lanes, lane):
    o = out[lane]
    return {"step_ms": o["step_ms"], "peak_mem_gb": o["peak_mem_gb"],
            "busy_share": o["profiled"].get("busy_share"),
            "device_ms": o["profiled"].get("device_ms"),
            "top": o["profiled"].get("top", [])[:5],
            "launches_each_step": lanes[lane]}


def rel_frobenius(torch, got, want):
    """Largest ‖got − want‖ / ‖want‖ over the leaves of two trees."""
    from repro_torch.tree import get_subtree, leaf_paths
    worst = 0.0
    for q in leaf_paths(want):
        a, b = get_subtree(got, q).float(), get_subtree(want, q).float()
        worst = max(worst, ((a - b).norm() / b.norm().clamp_min(1e-30))
                    .item())
    return worst


def moe_main_path(torch, launches, lanes):
    """Phase moe_main_path: full-width Granite-3.0-1B-A400M (cut from 24
    layers to GR_DEPTH, d_model 1024, 16/8 heads at head_dim 64, 32 experts top-8 of d_ff
    512, vocab 49 155; bf16, ``moe_impl="gather"``, ``attn_impl="flash"``;
    weights drawn on the card from seed 0), B = 8, T = 1024 (capacity
    4096 slots an expert), σ = 1: 3 steps each of ghost (its
    ``dp_strategy``; ``norm_method="pallas"``: ``gram_norm`` on every
    dense layer that is not an expert, 5 a layer and the head, and the
    flash kernels twice a layer, the capture pass and the weighted
    backward), ``auto`` flat and ``auto`` stale (the launches their plans
    say; no expert fuses).  Then, on one batch at σ = 0: the stale
    fused step against the unfused one on the same lagged norms
    (``gram_norm_fused`` swapped for its plain version; rtol 1e-3 / atol
    1e-5 of the largest entry, f32 arithmetic on both sides), the ghost
    norms with ``gram_norm`` against its plain version (the plain Gram;
    rtol 1e-3), those with the plain attention (``attn_impl="xla"``)
    recorded (bf16 attention rounds otherwise, and the router then picks
    other experts for some tokens), and two ghost steps' clipped sums
    bitwise equal under ``torch.use_deterministic_algorithms``."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, NormCfg, clipped_grad_sum
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import deterministic_step
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths
    t0 = time.perf_counter()
    cfg = get_config("granite-moe-1b-a400m").replace(attn_impl="flash")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
           cfg.vocab, cfg.hd, cfg.n_experts, cfg.topk) == GR_WIDTHS
          and cfg.moe_impl == "gather" and cfg.dtype == "bfloat16"
          and cfg.padded_vocab == 49280, "granite config")
    cfg = cfg.replace(n_layers=GR_DEPTH)
    model = TransformerLM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, _ = model.init(gen, device="cuda")
    ds = SyntheticLMDataset(cfg.vocab, GR_T, n_examples=4096, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                ds.batch(range(s * GR_B, (s + 1) * GR_B)).items()}
               for s in range(4)]
    cap = int(cfg.capacity_factor * GR_B * GR_T * cfg.topk / cfg.n_experts)
    log({"phase": "moe_setup", "arch": cfg.name, "params": param_count(params),
         "batch": GR_B, "seq": GR_T, "capacity_slots_an_expert": cap,
         "cuts": {"n_layers": [GR_LAYERS, GR_DEPTH]},
         "init_s": time.perf_counter() - t0})
    steps, L = 3, GR_DEPTH
    ghost_needs = dict(flash_needs(steps, passes=2, layers=L),
                       gram_norm=[5 * L + 1] * steps)
    runs = [("granite_ghost", "ghost", "flat", NormCfg(dense="pallas"),
             ghost_needs),
            ("granite_auto_flat", "auto", "flat", NormCfg(),
             planned_lm_needs(L, L)),
            ("granite_auto_stale", "auto", ClipPolicy(mode="stale"),
             NormCfg(), planned_lm_needs(L, L))]
    plans = {}
    runs = [(lane, st, cl, nm, recording_plan(plans, lane, nd))
            for lane, st, cl, nm, nd in runs]
    out = run_lanes(torch, "moe_main_path", model, params, batches, runs,
                    lanes, launches, steps, lr=1e-4,
                    named=FLASH_NAMES + ("gram_norm",))
    check(not any(n.startswith("blocks/moe/w_")
                  for n in plans["granite_auto_stale"]["fused"]),
          "granite stale plan fuses an expert")
    check(all(v[0] == "stream" for p in plans.values()
              for v in p["seg_dense"].values()),
          f"granite expert norms: {plans}")

    # fused vs unfused stale on the same lagged norms (σ = 0)
    b = batches[0]
    _, _, prev = clipped_grad_sum(model.apply, params, b, l2_clip=1.0,
                                  strategy="auto")
    sums = {}
    for fused in (True, False):
        torch.cuda.empty_cache()
        sums[fused] = clipped_grad_sum(
            model.apply, params, b, l2_clip=1.0, strategy="auto",
            clip_policy=ClipPolicy(mode="stale", fused=fused),
            prev_norms_sq=prev)
    (_, gf, nf), (_, gu, nu) = sums[True], sums[False]
    for q in leaf_paths(gu):
        a, w = get_subtree(gf, q), get_subtree(gu, q)
        check(torch.allclose(a, w, rtol=1e-3, atol=1e-5 * w.abs().max()
                             .item()), f"granite stale fused vs unfused "
              f"at {'/'.join(q)}")
    check(torch.allclose(nf, nu, rtol=1e-3), "granite stale fused vs "
          "unfused norms")
    fused_rel = rel_frobenius(torch, gf, gu)
    del sums, gf, gu
    torch.cuda.empty_cache()
    # the ghost norms with gram_norm against its plain version (the
    # same flash forward, so the same routing): f32 sums of the same
    # products in another order
    n_k = clipped_grad_sum(model.apply, params, b, l2_clip=1.0,
                           strategy="ghost", norm_method="pallas")[2]
    torch.cuda.empty_cache()
    n_p = clipped_grad_sum(model.apply, params, b, l2_clip=1.0,
                           strategy="ghost", norm_method="gram")[2]
    torch.cuda.empty_cache()
    norms_rel = ((n_k - n_p).abs() / n_p).max().item()
    check(norms_rel <= 1e-3, f"granite ghost norms, gram_norm vs plain: "
          f"{norms_rel:.3g}")
    # and with the plain attention (attn_impl="xla"): the bf16 attention
    # rounds otherwise, the router's bf16 logits then pick other experts
    # for some tokens, so this is recorded, not held to a bound
    n_x = clipped_grad_sum(
        TransformerLM(cfg.replace(attn_impl="xla")).apply, params, b,
        l2_clip=1.0, strategy="ghost")[2]
    torch.cuda.empty_cache()
    xla_rel = ((n_k - n_x).abs() / n_x).max().item()
    # two identical steps, bitwise
    with deterministic_step():
        r1 = clipped_grad_sum(model.apply, params, b, l2_clip=1.0,
                              strategy="ghost", norm_method="pallas")
        torch.cuda.empty_cache()
        r2 = clipped_grad_sum(model.apply, params, b, l2_clip=1.0,
                              strategy="ghost", norm_method="pallas")
    bitwise = torch.equal(r1[2], r2[2]) and all(
        torch.equal(get_subtree(r1[1], q), get_subtree(r2[1], q))
        for q in leaf_paths(r1[1]))
    check(bitwise, "granite: two deterministic ghost steps differ")
    del r1, r2
    torch.cuda.empty_cache()
    log({"phase": "moe_main_path",
         "lanes": {lane: lane_record(out, lanes, lane) for lane in out},
         "plans": plans, "stale_fused_vs_unfused_rel_frobenius": fused_rel,
         "ghost_norms_gram_norm_vs_plain_max_rel": norms_rel,
         "ghost_norms_flash_vs_xla_attention_max_rel": xla_rel,
         "deterministic_ghost_sums_bitwise": bitwise,
         "seconds": time.perf_counter() - t0, "ok": True})
    return model, params, batches


# The reduced MoE and enc-dec lanes of the dpcheck CLI, and the verdicts
# the JAX package's dpcheck gives on them: Granite's gather dispatch has
# global capacity (examples compete for one expert's slots) and fails in
# both packages; Seamless fails in the JAX package from its LayerNorm's
# variance under a nested jit (the same finding it reports for the dense
# OLMo-1B) and is clean in the port.
DPCHECK_MOE_ARCHS = ["granite-moe-1b-a400m", "seamless-m4t-large-v2"]
DPCHECK_MOE_MODES = ["flat"]
DPCHECK_MOE_ARGS = (["--archs"] + DPCHECK_MOE_ARCHS + ["--clip-modes"]
                    + DPCHECK_MOE_MODES)


def gather_capacity_finding(errors):
    """True for the errors of a Granite lane that the global-capacity
    dispatch gives: every one an unclipped batch reduction at the one-hot
    of all examples' expert ids (``eq``), and at least one."""
    return bool(errors) and all(
        f.code == "unclipped_batch_reduction" and "`eq`" in f.message
        for f in errors)


def moe_verify(torch, launches, lanes, granite):
    """Phase moe_verify: the static verifier on full-width Granite
    (``auto`` stale, after the flat bootstrap): its report holds exactly
    the global-capacity finding (``gather_capacity_finding``) and its
    kernel nodes equal one real step's launches (``verify_lane``).  Then
    ``python -m repro_torch.launch.dpcheck`` over reduced Granite and
    Seamless (flat; ``tests/test_torch_dpcheck.py`` runs every clipping
    mode on the CPU): exit 1, Granite
    FAILs with the same finding, Seamless PASSes."""
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    # the dpcheck CLI runs in its own process while this one verifies
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dpcheck", "-v",
         *DPCHECK_MOE_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    model, params, batches = granite
    report = verify_lane(torch, "granite_auto_stale", model, params,
                         batches, "stale", launches, lanes,
                         expect=gather_capacity_finding)
    t = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        proc.kill()
        raise SmokeFailure(f"dpcheck moe: timed out after "
                           f"{CLI_TIMEOUT_S} s") from e
    verdicts = {ln.split()[2] + " " + ln.split()[3]: ln.split()[1]
                for ln in out.splitlines()
                if ln.startswith("[dpcheck] ") and ln.split()[1] in
                ("PASS", "FAIL")}
    want = {f"{a} clip={m}": ("FAIL" if a.startswith("granite") else "PASS")
            for a in DPCHECK_MOE_ARCHS for m in DPCHECK_MOE_MODES}
    check(proc.returncode == 1 and verdicts == want
          and "batch-axis reduction in `eq`" in out,
          f"dpcheck moe: exit {proc.returncode}, verdicts {verdicts}\n"
          f"{out[-3000:]}\n{err[-2000:]}")
    log({"phase": "moe_verify", "granite_errors": sorted(
        {f.code for f in report.errors}), "dpcheck": DPCHECK_MOE_ARGS,
         "verdicts": verdicts, "dpcheck_waited_s": time.perf_counter() - t,
         "seconds": time.perf_counter() - t0, "ok": True})


def moe_dispatch(torch):
    """Phase moe_dispatch: reduced Granite (2 layers, d_model 64, 4
    experts top-2; f32, flash) on the card.  With capacity for every
    entry (``capacity_factor = E / k``: no token dropped) the einsum,
    gather and sort dispatches give the same outputs (rtol 1e-5) and
    per-example norms (rtol 1e-4); gather and sort bitwise.  At the
    config's capacity factor two identical ghost clipped sums are bitwise
    equal under ``torch.use_deterministic_algorithms``."""
    from repro_torch.configs import get_config
    from repro_torch.core import clipped_grad_sum
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import deterministic_step
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths
    t0 = time.perf_counter()
    base = get_config("granite-moe-1b-a400m").reduced().replace(
        attn_impl="flash")
    roomy = base.n_experts / base.topk
    params, _ = TransformerLM(base).init(0, device="cuda")
    b = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        base.vocab, 64, n_examples=64, seed=0).batch(range(4)).items()}
    res = {}
    for impl in ("einsum", "gather", "sort"):
        m = TransformerLM(base.replace(moe_impl=impl,
                                       capacity_factor=roomy))
        with torch.no_grad():
            logits = m.logits(params, b["tokens"])
        res[impl] = (logits, clipped_grad_sum(m.apply, params, b,
                                              l2_clip=1.0,
                                              strategy="ghost")[2])
    for impl in ("gather", "sort"):
        check(torch.allclose(res[impl][0], res["einsum"][0], rtol=1e-5,
                             atol=1e-5 * res["einsum"][0].abs().max()
                             .item()), f"moe {impl} vs einsum outputs")
        check(torch.allclose(res[impl][1], res["einsum"][1], rtol=1e-4),
              f"moe {impl} vs einsum norms")
    check(torch.equal(res["gather"][0], res["sort"][0])
          and torch.equal(res["gather"][1], res["sort"][1]),
          "moe gather vs sort not bitwise")
    m = TransformerLM(base)
    with deterministic_step():
        r1 = clipped_grad_sum(m.apply, params, b, l2_clip=1.0,
                              strategy="ghost")
        r2 = clipped_grad_sum(m.apply, params, b, l2_clip=1.0,
                              strategy="ghost")
    bitwise = torch.equal(r1[2], r2[2]) and all(
        torch.equal(get_subtree(r1[1], q), get_subtree(r2[1], q))
        for q in leaf_paths(r1[1]))
    check(bitwise, "moe: two deterministic ghost sums differ")
    log({"phase": "moe_dispatch", "capacity_factor_checked": roomy,
         "gather_vs_einsum_max_abs": (res["gather"][0] - res["einsum"][0])
         .abs().max().item(), "deterministic_bitwise": bitwise,
         "seconds": time.perf_counter() - t0, "ok": True})


def seamless_inputs(torch):
    """Full-width SeamlessM4T-large-v2 (flash), weights drawn on the card
    from seed 0, four ``make_batch_fn`` batches at seq 1024 (512 source
    frames, 512 target tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch_fn, to_device
    from repro_torch.models.encdec import EncDecLM
    cfg = get_config("seamless-m4t-large-v2").replace(attn_impl="flash")
    check((cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv, cfg.d_ff, cfg.vocab, cfg.hd) == SM_WIDTHS
          and cfg.padded_vocab == 256256 and cfg.remat
          and cfg.dtype == "bfloat16", "seamless config")
    model = EncDecLM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, _ = model.init(gen, device="cuda")
    fn = make_batch_fn(cfg, SM_B, 2 * SM_T)
    batches = [to_device(fn(s), "cuda") for s in range(4)]
    return model, params, batches


def encdec_main_path(torch, launches, lanes):
    """Phase encdec_main_path: full-width SeamlessM4T-large-v2's backbone
    (12 + 12 layers, d_model 1024, 16 heads at 64, GELU d_ff 8192,
    LayerNorm, vocab 256 206; bf16, remat, flash), B = 8, 512 source
    frames and 512 target tokens, σ = 1: 3 steps each of bk (its
    ``dp_strategy``; ``norm_method="pallas"``: ``gram_norm`` on every
    dense layer, 6 an encoder layer, 10 a decoder layer and the head) and
    ``auto`` flat.  A pass launches the flash forward 12 times full
    (encoder), 12 causal (decoder) and 12 full over the source (cross),
    24 more under remat (the decoder's recompute), dq and dk/dv 36."""
    from repro_torch.core import NormCfg
    t0 = time.perf_counter()
    model, params, batches = seamless_inputs(torch)
    log({"phase": "encdec_setup", "arch": model.cfg.name,
         "params": param_count(params), "batch": SM_B, "src": SM_T,
         "tgt": SM_T, "init_s": time.perf_counter() - t0})
    steps, L = 3, SM_LAYERS
    fwd, bwd = 3 * L + 2 * L, 3 * L          # remat: the decoder's again
    runs = [("seamless_bk", "bk", "flat", NormCfg(dense="pallas"),
             {"flash_fwd": [fwd] * steps, "flash_dq": [bwd] * steps,
              "flash_dkv": [bwd] * steps,
              "gram_norm": [6 * L + 10 * L + 1] * steps}),
            ("seamless_auto_flat", "auto", "flat", NormCfg(),
             planned_lm_needs(fwd, bwd))]
    plans = {}
    out = run_lanes(torch, "encdec_main_path", model, params, batches,
                    [(lane, st, cl, nm, recording_plan(plans, lane, nd))
                     for lane, st, cl, nm, nd in runs], lanes, launches,
                    steps, lr=1e-4, named=FLASH_NAMES + ("gram_norm",))
    log({"phase": "encdec_main_path",
         "lanes": {lane: lane_record(out, lanes, lane) for lane in out},
         "plans": plans, "seconds": time.perf_counter() - t0, "ok": True})
    del params, batches
    torch.cuda.empty_cache()


class _WithSource:
    """An enc-dec model with its source fixed, behind the decoder-only
    serving interface ``decode_vs_forward`` calls."""

    def __init__(self, model, src):
        self.model, self.src, self.cfg = model, src, model.cfg

    def prefill(self, params, prompts, max_len):
        return self.model.prefill(params, self.src, prompts, max_len=max_len)

    def decode_step(self, params, cache, tok):
        return self.model.decode_step(params, cache, tok)

    def logits(self, params, tokens):
        return self.model.logits(params, self.src, tokens)


def _timed_serve(torch, model, params, prompts, max_len):
    """One ``generate_batch`` pass over ``prompts`` (SERVE_BATCH rows)
    with ``model.prefill`` and ``model.decode_step`` timed between
    synchronizations: (tokens, prefill ms, decode ms a token, seconds)."""
    from repro_torch.launch.serve import generate_batch
    times = {"prefill": [], "decode_step": []}

    def timed(name):
        fn = getattr(model, name)

        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    model.prefill, model.decode_step = (timed("prefill"),
                                        timed("decode_step"))
    try:
        t = time.perf_counter()
        out = generate_batch(model, params, prompts, max_len=max_len,
                             gen=SERVE_GEN)
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t
    finally:
        del model.prefill, model.decode_step
    return (out, times["prefill"][0],
            sum(times["decode_step"]) / len(times["decode_step"]), served_s)


def serve_one(torch, arch, model, params, prompts, checks,
              phase="moe_encdec_serve", warm=True):
    """``launch.serve.generate_batch`` over ``prompts`` in batches of
    SERVE_BATCH (after one warm batch): prefill ms and decode ms a token
    on one batch, tokens/s over all, peak memory; ``checks()`` gives the
    decode-equals-forward record.  Unless ``warm`` (a recurrent model: its
    prefill is one decode step a token, warm after its first token), the
    one pass over ``prompts`` (a single batch) gives all three, its
    prefill and decode steps timed in place (``_timed_serve``).  Serving
    launches no kernel of this repo."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate_batch
    max_len = SERVE_PROMPT + SERVE_GEN
    p0 = prompts[:SERVE_BATCH]
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    if not warm:
        check(len(prompts) == SERVE_BATCH, f"{arch}: one batch of prompts")
        out, prefill_ms, decode_ms, served_s = _timed_serve(
            torch, model, params, p0, max_len)
        return _served(torch, arch, model, params, prompts, checks, phase,
                       [out], prefill_ms, decode_ms, served_s)
    generate_batch(model, params, p0, max_len=max_len, gen=2)
    enc = model.cfg.family == "encdec"
    src = (torch.zeros((SERVE_BATCH, SERVE_PROMPT, model.cfg.d_model),
                       device="cuda") if enc else None)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = (model.prefill(params, src, p0, max_len=max_len) if enc
                     else model.prefill(params, p0, max_len=max_len))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    tok = torch.argmax(logits, -1)
    t = time.perf_counter()
    for _ in range(SERVE_GEN - 1):
        logits, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / (SERVE_GEN - 1)
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    del logits, cache
    t = time.perf_counter()
    outs = [generate_batch(model, params, prompts[i:i + SERVE_BATCH],
                           max_len=max_len, gen=SERVE_GEN)
            for i in range(0, len(prompts), SERVE_BATCH)]
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t
    _served(torch, arch, model, params, prompts, checks, phase, outs,
            prefill_ms, decode_ms, served_s)


def _served(torch, arch, model, params, prompts, checks, phase, outs,
            prefill_ms, decode_ms, served_s):
    """``serve_one``'s checks of the served tokens and its record."""
    from repro_torch.kernels import ops
    check(all(tuple(o.shape) == (SERVE_BATCH, SERVE_GEN) for o in outs)
          and all(bool(((o >= 0) & (o < model.cfg.padded_vocab)).all())
                  for o in outs), f"{arch}: generated tokens")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"phase": phase, "arch": arch,
           "params": param_count(params), "requests": len(prompts),
           "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
           "gen": SERVE_GEN, "prefill_ms": prefill_ms,
           "decode_ms_a_token": decode_ms, "served_s": served_s,
           "tokens_per_s": len(prompts) * SERVE_GEN / served_s,
           "peak_mem_gb": peak, "sample": outs[0][0, :8].tolist()}
    check(not any(ops.LAUNCHES.values()),
          f"{arch}: serving launched {dict(ops.LAUNCHES)}")
    if checks is not None:
        rec["decode_equals_forward"] = checks()
    log(dict(rec, ok=True))


# DeepSeek-V3's MoE layer at full width (configs/deepseek_v3_671b.py):
# MLA as in deepseek_layer0, 256 routed experts top-8 and one shared
# expert of d_ff 2048, vocab 129 280; cut to one layer, no remat or FSDP.
DS_MOE_PARAMS_MIN = 1.3e10


def moe_encdec_serve(torch, granite):
    """Phase moe_encdec_serve: serving at full width through
    ``launch.serve.generate_batch``, 8 requests in batches of 4,
    128-token prompts, 32 tokens out (``serve_one``).  Granite (the
    params of phase moe_main_path) and SeamlessM4T-v2 (weights drawn on
    the card; zero source frames of the prompt's length, as the serving
    CLI gives them) are checked decode-equals-forward by
    ``serve_checks``' rule, with room for every entry in the experts
    (``capacity_factor = E / k``: the global capacity of a 4-token decode
    step is 2 slots an expert at the config's factor, and dropped tokens
    would make decode differ from the forward by design); Seamless's
    check runs on random source frames.  Then one full-width DeepSeek-V3
    MoE layer (MLA + 256 experts top-8 + 1 shared, about 1.34e10 params,
    26.7 GB in bf16, drawn on the card): serving only, finite logits and
    valid tokens.  Its DP step does not fit one card (the f32 clipped
    sum of the experts alone is 45 GB, AdamW's two f32 moments 90 GB
    more): it waits for sharding (ROADMAP.md item 14)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v3_671b import CONFIG
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.lm import TransformerLM
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model, params, _ = granite
    prompts = torch.randint(0, model.cfg.vocab,
                            (SERVE_REQUESTS, SERVE_PROMPT), generator=gen,
                            device="cuda")
    # the config's attention (the training lane's is flash): the
    # forward the served logits are held to is the config's own
    served = model.cfg.replace(attn_impl="auto")
    roomy = served.replace(
        capacity_factor=model.cfg.n_experts / model.cfg.topk)
    serve_one(torch, "granite-moe-1b-a400m", TransformerLM(served),
              params, prompts, lambda: serve_checks(
                  torch, "granite-moe-1b-a400m", TransformerLM(roomy),
                  params, prompts[:SERVE_BATCH],
                  moe_axes=TransformerLM(served.reduced()).init(
                      0, device="cpu")[1]))
    del params, granite, model
    torch.cuda.empty_cache()

    cfg = get_config("seamless-m4t-large-v2")
    sm = EncDecLM(cfg)
    params, _ = sm.init(gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT),
                            generator=gen, device="cuda")
    src = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.d_model),
                      generator=gen, device="cuda")
    serve_one(torch, "seamless-m4t-large-v2", sm, params, prompts,
              lambda: serve_checks(
                  torch, "seamless-m4t-large-v2", _WithSource(sm, src),
                  params, prompts[:SERVE_BATCH],
                  rebuild=lambda c: _WithSource(EncDecLM(c), src)))
    del params
    torch.cuda.empty_cache()

    dcfg = CONFIG.replace(n_layers=1, remat=False, fsdp=False)
    check((dcfg.d_model, dcfg.n_experts, dcfg.topk, dcfg.n_shared_experts,
           dcfg.d_ff, dcfg.vocab, dcfg.family, dcfg.moe_impl)
          == (7168, 256, 8, 1, 2048, 129280, "moe", "gather"),
          "deepseek-v3 moe config")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params, _ = TransformerLM(dcfg).init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n = param_count(params)
    check(n >= DS_MOE_PARAMS_MIN, f"deepseek-v3 moe layer: {n} params")
    prompts = torch.randint(0, dcfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT),
                            generator=gen, device="cuda")
    log({"phase": "moe_encdec_serve", "arch": "deepseek-v3-671b layer 0",
         "params": n, "weights_gb": n * 2 / 1e9, "init_s": init_s,
         "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "cuts": {"n_layers": 1, "remat": False, "fsdp": False}})
    serve_one(torch, "deepseek-v3-671b layer 0", TransformerLM(dcfg),
              params, prompts, None)
    del params
    torch.cuda.empty_cache()
    log({"phase": "moe_encdec_serve_done",
         "seconds": time.perf_counter() - t0})


def run_moe_encdec(torch, launches, lanes):
    """The phases of the MoE and enc-dec families, in order, each with
    its seconds."""
    t = time.perf_counter()
    granite = moe_main_path(torch, launches, lanes)
    log({"phase": "moe_main_path_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    moe_verify(torch, launches, lanes, granite)
    log({"phase": "moe_verify_done", "seconds": time.perf_counter() - t})
    granite[2].clear()
    torch.cuda.empty_cache()
    moe_encdec_serve(torch, granite)
    del granite
    torch.cuda.empty_cache()
    t = time.perf_counter()
    moe_dispatch(torch)
    log({"phase": "moe_dispatch_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    encdec_main_path(torch, launches, lanes)
    log({"phase": "encdec_main_path_done",
         "seconds": time.perf_counter() - t})


# The recurrent families' lanes: xLSTM-125M at full width cut from 12
# layers to XL_DEPTH = 4 (one super-block of 3 mLSTM and 1 sLSTM, to make
# room for phase moe_model_axis_path), B = 8, T = 128; Zamba2-2.7B at
# full width cut to ZB_LAYERS layers (1 super-block of 6 Mamba2 layers,
# the shared block applied once, to make room for the attention families'
# model-axis lanes), B = 4, T = 512; the shared block's fold over two
# applications and remat on ZB_FOLD_LAYERS (2 super-blocks) at EXACT_B x
# REMAT_T (hybrid_two_applications); Zamba2's exactness at 1 super-block
# on HY_EXACT_T of its ZB_T tokens (for the script's time).  Widths as
# the configs
# give them: (layers, d_model, heads, vocab, slstm_every) and (layers,
# d_model, heads, KV heads, d_ff, vocab, head_dim, ssm_state, attn_every,
# window).
XL_B, XL_T = 8, 128
XL_WIDTHS = (12, 768, 4, 50304, 4)
XL_DEPTH = 4
ZB_B, ZB_T, ZB_LAYERS = 4, 512, 6
HY_EXACT_T = 256
ZB_FOLD_LAYERS = 12
ZB_WIDTHS = (54, 2560, 32, 32, 10240, 32000, 80, 64, 6, 4096)
# bk's gram_norm launches a step (norm_method="pallas"): one a dense layer
# of every stacked layer, once for each folded shared dense, and the
# head.  xLSTM: 6 denses an mLSTM layer and 4 an sLSTM layer (3 and 1 a
# super-block of XL_WIDTHS[4] layers) + head; Zamba2: in_proj and out_proj
# x ZB_LAYERS + the shared block's 7 + head.
XL_GRAM = (6 * 3 + 4) * (XL_DEPTH // XL_WIDTHS[4]) + 1
ZB_GRAM = 2 * ZB_LAYERS + 7 + 1
# Exactness at full width in f32: EXACT_B examples of the lane's first
# batch at the lane's T; the remat check takes their first REMAT_T tokens.
EXACT_B, REMAT_T = 2, 128
# The recurrent families' f32 decode-equals-forward rule: every served
# logit within this share of the forward's largest, twice the most the
# card has read (xLSTM-125M 1.95e-4, Zamba2-2.7B 1.84e-4; PERF.md),
# where the dense rows hold 1e-5: through the recurrences f32 rounding
# grows.  A wrong gate or a state dropped moves a logit by a large share
# of the largest.
RECURRENT_F32_OF_LARGEST = 4e-4
# Zamba2's serving depth (phase ssm_serve): 3 super-blocks of 6.
SERVE_ZB_LAYERS = 18
# gram_norm at the recurrent lanes' shapes (contiguous (B, T, D) rows, as
# the dense taps hand them over): xLSTM's mLSTM wq, Zamba2's in_proj, and
# a shared dense folded over its two applications (T twice the lane's).
RECURRENT_GRAM_CASES = [
    ("xlstm_wq_bf16", XL_B, XL_T, 1536, 1536, "bfloat16"),
    ("zamba2_in_proj_bf16", ZB_B, ZB_T, 2560, 10448, "bfloat16"),
    ("zamba2_shared_wq_folded_bf16", ZB_B, 2 * ZB_T, 2560, 2560,
     "bfloat16")]


def recurrent_inputs(torch, cfg, B, T, phase):
    """``cfg``'s model, params drawn on the card from seed 0, and four
    (B, T) synthetic batches on the card."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.lm import TransformerLM
    t0 = time.perf_counter()
    model = TransformerLM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, _ = model.init(gen, device="cuda")
    ds = SyntheticLMDataset(cfg.vocab, T, n_examples=4096, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                ds.batch(range(s * B, (s + 1) * B)).items()}
               for s in range(4)]
    log({"phase": phase, "arch": cfg.name, "params": param_count(params),
         "n_layers": cfg.n_layers, "batch": B, "seq": T,
         "init_s": time.perf_counter() - t0})
    return model, params, batches


def _bk_group_norms(torch, model, params, batch):
    """bk's per-group squared norms ((G, B), ``gram_norm`` on the
    denses), the group keys, each group's param path and kind, and the
    kernels launched."""
    from repro_torch.core import capture_backward
    from repro_torch.core import strategies
    from repro_torch.kernels import ops
    ops.reset_launches()
    _, caps, dtaps, metas = capture_backward(model.apply, params, batch,
                                             with_metas=True)
    keys, norms = strategies.group_norms_from_captures(
        params, caps, dtaps, metas, norm_method="pallas")
    info = {strategies.group_key_of(m.path): (m.path, m.kind)
            for m in metas.values()}
    return keys, norms, info, {k: v for k, v in ops.LAUNCHES.items() if v}


def _sq_norms(tree, leaf_paths):
    """Per-example squared norm of a tree of (B, ...) grads."""
    from repro_torch.tree import get_subtree
    return sum(get_subtree(tree, q).float().square().flatten(1).sum(1)
               for q in leaf_paths(tree))


def _batched_plain_norms(torch, m32, p32, b, keys, info):
    """The per-group squared norms of each example's gradient taken from
    one plain f32 forward over all of ``b``'s rows (each example's loss
    differentiated alone, the graph kept between them): a per-example
    gradient with no kernel and no tap, whose GEMMs run over the batch's
    row count as bk's do."""
    from repro_torch.core.tapper import Tapper
    from repro_torch.tree import from_paths, get_subtree, leaf_paths
    from repro_torch.tree import tree_map
    p = tree_map(lambda a: a.detach().requires_grad_(True), p32)
    paths = leaf_paths(p)
    per = []
    with torch.enable_grad():
        losses = m32.apply(p, b, Tapper())
        for i in range(len(losses)):
            per.append(torch.autograd.grad(
                losses[i], [get_subtree(p, q) for q in paths],
                retain_graph=i < len(losses) - 1))
    del losses
    grads = from_paths(paths, [torch.stack([g[j] for g in per])
                               for j in range(len(paths))])
    del per
    return torch.stack([_sq_norms(get_subtree(grads, info[k][0]), leaf_paths)
                        for k in keys])


def _rel_by_group(got, want, keys):
    r = ((got - want).abs() / want.abs().clamp_min(1e-30)).max(1).values
    return {k: r[i].item() for i, k in enumerate(keys)}


def _max_by_kind(rel, info):
    out = {}
    for k, v in rel.items():
        out[info[k][1]] = max(out.get(info[k][1], 0.0), v)
    return out


def recurrent_exactness(torch, model, params, batch, lane):
    """At full width in f32 (an f32 copy of the weights, TF32 off), on
    EXACT_B examples of ``batch`` at the lane's T, against the squared
    norms of ``naive``'s per-example grads (one example a pass), group
    by group (the ``local_vjp`` groups and the shared block's folded
    groups included):

    * bk's group norms (``gram_norm`` on the denses) with each example
      taken alone, as ``naive`` takes it: within rtol 1e-4, the LM
      lanes' f32 rule;
    * bk's with the examples together, whose GEMMs run over another row
      count: within the larger of 1e-4 and twice the witness, how far a
      plain per-example gradient over the same rows moves from
      ``naive``'s (``_batched_plain_norms``), since through the
      recurrences f32 rounding grows (PERF.md)."""
    from repro_torch.core import strategies
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths, tree_map
    t0 = time.perf_counter()
    m32 = TransformerLM(model.cfg.replace(dtype="float32"))
    p32 = tree_map(lambda a: a.float(), params)
    b = {k: v[:EXACT_B] for k, v in batch.items()}
    parts = [_bk_group_norms(torch, m32, p32,
                             {k: v[i:i + 1] for k, v in b.items()})
             for i in range(EXACT_B)]
    keys, info, launched = parts[0][0], parts[0][2], parts[0][3]
    alone = torch.cat([p[1] for p in parts], 1)
    del parts
    torch.cuda.empty_cache()
    t_keys, together, _, launched_together = _bk_group_norms(torch, m32,
                                                             p32, b)
    check(t_keys == keys, f"{lane}: bk's groups differ with B")
    torch.cuda.empty_cache()
    witness = _batched_plain_norms(torch, m32, p32, b, keys, info)
    torch.cuda.empty_cache()
    _, pe = strategies.naive_per_example_grads(m32.apply, p32, b)
    want = torch.stack([_sq_norms(get_subtree(pe, info[k][0]), leaf_paths)
                        for k in keys])
    del pe, p32
    torch.cuda.empty_cache()
    rel = _rel_by_group(alone, want, keys)
    rel_t = _rel_by_group(together, want, keys)
    rel_w = _rel_by_group(witness, want, keys)
    limit = max(1e-4, 2 * max(rel_w.values()))

    def worst(r):
        return sorted(r.items(), key=lambda kv: -kv[1])[:5]
    check(all(v <= 1e-4 for v in rel.values()),
          f"{lane} f32 bk group norms (each example alone) vs naive: "
          f"{worst(rel)}")
    check(all(v <= limit for v in rel_t.values()),
          f"{lane} f32 bk group norms (examples together) vs naive: "
          f"{worst(rel_t)}, over {limit:.3g} (the plain batched "
          f"gradient's: {worst(rel_w)})")
    check(launched.get("gram_norm", 0) > 0
          and launched_together.get("gram_norm", 0) > 0,
          f"{lane}: the f32 bk norms launched {launched}, "
          f"{launched_together}")
    return {"examples": EXACT_B, "seq": b["tokens"].shape[1],
            "groups": len(keys),
            "max_rel_err_by_kind": _max_by_kind(rel, info),
            "together": {"max_rel_err_by_kind": _max_by_kind(rel_t, info),
                         "limit": limit,
                         "plain_batched_by_kind": _max_by_kind(rel_w,
                                                               info),
                         "worst": worst(rel_t),
                         "plain_batched_worst": worst(rel_w)},
            "shared_groups": {k: rel[k] for k in keys
                              if k.startswith("shared/")},
            "local_vjp_groups": {k: rel[k] for k in keys
                                 if info[k][1] == "local_vjp"},
            "launches_each_example": launched,
            "launches_together": launched_together,
            "seconds": time.perf_counter() - t0}


def recurrent_lanes(torch, phase, model, params, batches, launches, lanes,
                    bk_gram, flat_lane, stale_lane=None, profile_bk=True):
    """bk (``norm_method="pallas"``: ``gram_norm`` ``bk_gram`` times a
    step), ``auto`` stale where given (``gram_norm_fused`` once a fused
    layer of the stack a step, as its plan says) and ``auto`` flat (its
    plan realizes every norm with the plain versions: no kernel of the
    repo runs), σ = 1, for the script's time (a Zamba2 step takes
    seconds): bk one timed step and (``profile_bk``) a profiled second,
    flat one timed step, stale two (the flat bootstrap, then a stale
    step); only bk's step is profiled."""
    from repro_torch.core import ClipPolicy, NormCfg
    plans = {}
    named = ("gram_kernel", "direct_wgmma", "gemm", "elementwise")
    out = run_lanes(
        torch, phase, model, params, batches,
        [(f"{phase}_bk", "bk", "flat", NormCfg(dense="pallas"),
          {"gram_norm": [bk_gram], "gram_norm_fused": [0]})],
        lanes, launches, 1, lr=1e-4, named=named, profile=profile_bk)
    if stale_lane:
        out.update(run_lanes(
            torch, phase, model, params, batches,
            [(stale_lane, "auto", ClipPolicy(mode="stale"), NormCfg(),
              recording_plan(plans, stale_lane, planned_lm_needs(0, 0)))],
            lanes, launches, 2, lr=1e-4, profile=False))
    out.update(run_lanes(
        torch, phase, model, params, batches,
        [(flat_lane, "auto", "flat", NormCfg(),
          recording_plan(plans, flat_lane, planned_lm_needs(0, 0)))],
        lanes, launches, 1, lr=1e-4, no_kernel=True, profile=False))
    if stale_lane:
        check(plans[stale_lane]["fused"], f"{stale_lane}: nothing fused")
    return out, plans


def ssm_main_path(torch, launches, lanes):
    """Phase ssm_main_path: xLSTM-125M at full width cut to XL_DEPTH of
    its 12 layers (d_model 768, 4 heads, vocab 50 304, bf16; drawn on
    the card),
    B = 8, T = 128, σ = 1: bk, ``auto`` stale and ``auto`` flat
    (``recurrent_lanes``), then ``recurrent_exactness`` in f32."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config("xlstm-125m")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab,
           cfg.slstm_every) == XL_WIDTHS and cfg.family == "ssm"
          and cfg.dtype == "bfloat16" and not cfg.remat, "xlstm config")
    cfg = cfg.replace(n_layers=XL_DEPTH)
    model, params, batches = recurrent_inputs(torch, cfg, XL_B, XL_T,
                                              "ssm_setup")
    # No profiled bk step (PERF.md §5 keeps PR 24's profile): the
    # recurrent families' model-axis lanes needed the script's time.
    out, plans = recurrent_lanes(torch, "xlstm", model, params, batches,
                                 launches, lanes, XL_GRAM,
                                 "xlstm_auto_flat", "xlstm_auto_stale",
                                 profile_bk=False)
    exact = recurrent_exactness(torch, model, params, batches[0], "xlstm")
    log({"phase": "ssm_main_path",
         "lanes": {lane: lane_record(out, lanes, lane) for lane in out},
         "plans": plans, "exactness_f32": exact,
         "seconds": time.perf_counter() - t0, "ok": True})
    del params, batches
    torch.cuda.empty_cache()


def hybrid_main_path(torch, launches, lanes):
    """Phase hybrid_main_path: Zamba2-2.7B at full width (d_model 2560,
    32 heads at head_dim 80, SwiGLU d_ff 10 240, ssm_state 64, window
    4096, vocab 32 000, bf16, remat) cut to 1 super-block (6 Mamba2
    layers, the shared block applied once; drawn on the card), B = 4,
    T = 512, σ = 1: bk and ``auto`` flat (``recurrent_lanes``), then
    ``recurrent_exactness`` in f32 on the batch's first HY_EXACT_T
    tokens (512 before FSDP's lanes needed the script's time).  The
    shared block over two applications: ``hybrid_two_applications``."""
    t0 = time.perf_counter()
    cfg = zamba2_config(torch, ZB_LAYERS)
    model, params, batches = recurrent_inputs(torch, cfg, ZB_B, ZB_T,
                                              "hybrid_setup")
    # No profiled bk step: it took about 20 s, which phase
    # moe_model_axis_path needed (PERF.md §5 keeps an earlier profile).
    out, plans = recurrent_lanes(torch, "zamba2", model, params, batches,
                                 launches, lanes, ZB_GRAM,
                                 "zamba2_auto_flat", profile_bk=False)
    exact = recurrent_exactness(
        torch, model, params,
        {k: v[:, :HY_EXACT_T] for k, v in batches[0].items()}, "zamba2")
    log({"phase": "hybrid_main_path",
         "cuts": {"n_layers": ZB_LAYERS, "exactness_seq": [ZB_T, HY_EXACT_T]},
         "lanes": {lane: lane_record(out, lanes, lane) for lane in out},
         "plans": plans, "exactness_f32": exact,
         "seconds": time.perf_counter() - t0, "ok": True})
    del params, batches
    torch.cuda.empty_cache()


def zamba2_config(torch, n_layers):
    """Zamba2-2.7B's config, its widths checked, cut to ``n_layers``."""
    from repro_torch.configs import get_config
    full = get_config("zamba2-2.7b")
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv, full.d_ff,
           full.vocab, full.hd, full.ssm_state, full.attn_every,
           full.window) == ZB_WIDTHS and full.remat
          and full.dtype == "bfloat16", "zamba2 config")
    return full.replace(n_layers=n_layers)


def hybrid_two_applications(torch):
    """Zamba2-2.7B at full width cut to ZB_FOLD_LAYERS (2 super-blocks:
    the shared block applied twice, its gradient folded over both), on
    EXACT_B examples of a (ZB_B, ZB_T) batch cut to REMAT_T tokens:
    ``recurrent_exactness`` in f32 (bk's folded shared groups against
    ``naive``'s), and bk's clipped sums with ``remat=True`` bitwise equal
    to ``remat=False``'s (deterministic algorithms, in bf16).  Run
    beside the AlexNet CLI processes (``cli_lanes_beside_serving``)."""
    from repro_torch.core import clipped_grad_sum
    from repro_torch.launch.train import deterministic_step
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths
    t0 = time.perf_counter()
    cfg = zamba2_config(torch, ZB_FOLD_LAYERS)
    check(cfg.n_layers // cfg.attn_every == 2, "zamba2: the fold check "
          "needs the shared block applied twice")
    model, params, batches = recurrent_inputs(torch, cfg, ZB_B, ZB_T,
                                              "hybrid_fold_setup")
    b = {k: v[:EXACT_B, :REMAT_T] for k, v in batches[0].items()}
    del batches
    exact = recurrent_exactness(torch, model, params, b,
                                "zamba2_two_applications")
    check(exact["shared_groups"], "zamba2: no folded shared group")
    sums, peaks = {}, {}
    with deterministic_step():
        for remat in (True, False):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            m = TransformerLM(cfg.replace(remat=remat))
            sums[remat] = clipped_grad_sum(m.apply, params, b, l2_clip=1.0,
                                           strategy="bk",
                                           norm_method="pallas")
            peaks[remat] = torch.cuda.max_memory_allocated() / 1e9
    (_, g1, n1), (_, g2, n2) = sums[True], sums[False]
    bitwise = torch.equal(n1, n2) and all(
        torch.equal(get_subtree(g1, q), get_subtree(g2, q))
        for q in leaf_paths(g2))
    check(bitwise, "zamba2: bk clipped sums differ between remat=True and "
          "remat=False")
    del sums, g1, g2, params
    torch.cuda.empty_cache()
    log({"phase": "hybrid_two_applications",
         "cuts": {"n_layers": cfg.n_layers, "examples": EXACT_B,
                  "seq": REMAT_T},
         "shared_block_applications": cfg.n_layers // cfg.attn_every,
         "exactness_f32": exact, "remat_bk_sums_bitwise": bitwise,
         "bk_sum_peak_gb": {"remat": peaks[True], "no_remat": peaks[False]},
         "seconds": time.perf_counter() - t0, "ok": True})


def ssm_serve(torch):
    """Phase ssm_serve: xLSTM-125M not cut and Zamba2-2.7B at full width
    cut to SERVE_ZB_LAYERS (18 of its 54 Mamba2 layers: 3 applications of
    the shared block, to make room for the attention families' model-axis
    lanes), weights drawn on the card, through
    ``launch.serve.generate_batch`` as ``serve_one`` drives it: 4 requests in one batch, 128-token prompts
    prefilled one token at a time (the JAX package's recurrent prefill),
    32 out.  Decode-equals-forward (``serve_checks_f32_ref``): bf16
    within twice the bf16 forward's own distance from the f32 forward
    plus 2^-8 of the largest logit; f32 within RECURRENT_F32_OF_LARGEST
    of the largest logit (``f32_decode_check``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import TransformerLM
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for arch in ("xlstm-125m", "zamba2-2.7b"):
        cfg = get_config(arch)
        if arch == "zamba2-2.7b":
            cfg = cfg.replace(n_layers=SERVE_ZB_LAYERS)
        model = TransformerLM(cfg)
        params, _ = model.init(gen, device="cuda")
        prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                                generator=gen, device="cuda")
        serve_one(torch, arch, model, params, prompts,
                  lambda: serve_checks_f32_ref(
                      torch, arch, model, params, prompts[:SERVE_BATCH],
                      of_largest=RECURRENT_F32_OF_LARGEST),
                  phase="ssm_serve", warm=False)
        del params
        torch.cuda.empty_cache()
    log({"phase": "ssm_serve_done", "seconds": time.perf_counter() - t0})


def run_recurrent(torch, launches, lanes):
    """The training phases of the SSM and hybrid families, each with its
    seconds (their serving, ``ssm_serve``, runs beside the CLI lanes)."""
    for fn in (ssm_main_path, hybrid_main_path):
        t = time.perf_counter()
        fn(torch, launches, lanes)
        log({"phase": f"{fn.__name__}_done",
             "seconds": time.perf_counter() - t})


# ---------------------------------------------------------------------------
# Data parallelism on one card (ROADMAP item 14 part 1): phase
# sharded_main_path.  Two ranks of one process group share cuda:0 under
# ``torch.distributed.run``.  NCCL refuses two ranks on one device, so the
# ranks run gloo, which all-reduces a CUDA tensor by staging it through the
# host: the all-reduce times below are the host's, not NVLink's or NCCL's.

SH_RANKS = 2
SH_DIR = ROOT / "build" / "chip_smoke_shard"
SH_TIMEOUT_S = 300
SH_LR = 1e-3
SH_STEPS = 2
# Llama-3.2-1B at full width cut to 1 layer (2 before the recurrent
# families' model-axis lanes needed the script's time), B = 8, T = 1024:
# 2 steps (the stale bootstrap, then a stale step).
SH_LLAMA_LAYERS, SH_LLAMA_STEPS = 1, 2
SH_LLAMA_LANE = f"llama_depth{SH_LLAMA_LAYERS}_auto_stale"
# Phase model_axis_path's Llama lanes: cut to 1 layer (2 before the
# attention families' model-axis lanes needed the script's time).
MA_LLAMA_LAYERS = 1
SH_CLI = ["--arch", "alexnet", "--full", "--batch", "32", "--strategy",
          "auto", "--noise", "1.0", "--mesh", f"data:{SH_RANKS}",
          "--backend", "gloo", "--steps", "4", "--ckpt-every", "2"]
# The f32 unit roundoff of kernels/bounds.py.
U32 = 2.0 ** -24


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(cmd, timeout, env=None):
    """``cmd`` in a session of its own, every process of which is killed
    if it outlives ``timeout``: (exit code, stdout, stderr, seconds)."""
    import signal
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return None, out, err, time.perf_counter() - t
    return proc.returncode, out, err, time.perf_counter() - t


def torchrun(args, timeout, nproc=SH_RANKS):
    """``python -m torch.distributed.run`` with ``nproc`` ranks on this
    machine (a free localhost port) running ``args``."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")   # whole lines a write
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nproc), "--master_addr", "127.0.0.1", "--master_port",
           str(free_port()), *args]
    return run_group(cmd, timeout, env)


# Mesh worlds started ahead of their phase.  A torchrun world's ranks take
# about 20 s to start on an H100 host (entering 9.4 s after the launch,
# the mesh at 21.1 s; most of it the interpreter, torch and the port's
# imports; PERF.md).  Each mesh phase has its worlds started while the
# phase before runs: the ranks import, load the kernel libraries and join
# their gloo group, then wait for the gate file GATE in their directory
# (``await_gate``), which the parent writes once the card's memory is free
# for them; only then does a rank touch the card (its device, its mesh).
GATE = "go"
GATE_TIMEOUT_S = 900
WORLDS = []


class World:
    """A torchrun world of ``nproc`` ranks running ``args``, started now
    (its output read by a thread of its own), released by writing
    ``gate`` under ``gate_dir``; ``result()`` waits at most ``timeout`` s
    from the release and kills the world's session beyond it."""

    def __init__(self, args, nproc, timeout, gate_dir):
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                                   if env.get("PYTHONPATH") else []))
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
               "--master_port", str(free_port()), *args]
        self.gate = pathlib.Path(gate_dir) / GATE
        self.timeout = timeout
        self.started = time.perf_counter()
        self.released = None
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)
        self.out = ("", "")
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        WORLDS.append(self)

    def _read(self):
        self.out = self.proc.communicate()

    def release(self):
        if self.released is None:
            self.gate.touch()
            self.released = time.perf_counter()

    def stop(self):
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)

    def result(self):
        """(exit code or None if killed, stdout, stderr, seconds from the
        release, seconds it waited ready before it)."""
        self.release()
        self.reader.join(max(self.released + self.timeout
                             - time.perf_counter(), 0.1))
        rc = None
        if self.reader.is_alive():
            self.stop()
            self.reader.join()
        else:
            rc = self.proc.returncode
        return (rc, *self.out, time.perf_counter() - self.released,
                self.released - self.started)


def stop_worlds():
    for w in WORLDS:
        w.stop()


def await_gate(out_dir, wall=None):
    """What a rank does before its phase: load the built kernel
    libraries and join the gloo group (the default group, on the host:
    no card memory is taken while the phase before runs), then wait for
    the parent's ``gate`` under ``out_dir``; the caller then takes its
    device and builds its mesh.  ``wall`` gets the times."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import init_distributed
    for stem in build.ENTRY_POINTS:
        build.load(stem)
    init_distributed("gloo", device_type="cpu")
    if wall is not None:
        wall["ready"] = time.time()
    flag = pathlib.Path(out_dir) / GATE
    t = time.perf_counter()
    while not flag.exists():
        check(time.perf_counter() - t < GATE_TIMEOUT_S,
              f"no {GATE} from the parent in {GATE_TIMEOUT_S} s")
        time.sleep(0.05)
    if wall is not None:
        wall["released"] = time.time()


def tree_bytes(tree):
    """Bytes of every tensor leaf of a (nested) dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


def tree_digest(tree):
    """sha256 of every leaf's bytes in leaf-path order."""
    import hashlib
    from repro_torch.tree import get_subtree, leaf_paths
    h = hashlib.sha256()
    for p in leaf_paths(tree):
        t = get_subtree(tree, p).detach().contiguous()
        h.update(t.view(-1).view(__import__("torch").uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def shard_lane(torch, model, params, batches, dp, steps, mesh, needs,
               optimizer, lr, runs=2, axes=None, fsdp=False,
               donate_opt=False, whole=True):
    """One sharded lane, ``runs`` times from the same whole params (on a
    model axis or under ``fsdp``, ``axes`` the logical axes: this rank's
    slices of them):
    per step the rank's step ms, the all-reduce's ms
    (``clipping.sync_grads`` timed between synchronizations) and the
    leaves synced, the calls and MB of the model- and data-group
    collectives (FSDP's param gathers also on their own) and, in the
    second run, their ms (each synchronized and
    timed: ``sharding.COLL_STATS``), the launches (counts set to 0 before
    the step, read after); the slices' digest, the rank's peak and its
    persistent GB (params and optimizer state after the last step).
    ``donate_opt``: the moments updated in place.  Returns (record, the
    first run's whole params, or with ``whole=False`` its slices)."""
    from repro_torch.core import PrivacyEngine, clipping
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.optim import adamw_init, sgdm_init
    from repro_torch.tree import get_subtree, leaf_paths, tree_map
    real = clipping.sync_grads
    st = sharding.COLL_STATS
    sync = []

    def timed(gsum, shard):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(gsum, shard)
        torch.cuda.synchronize()
        sync.append(((time.perf_counter() - t) * 1e3, len(leaf_paths(gsum))))
        return out

    clipping.sync_grads = timed
    rec = {"runs": []}
    first = None
    try:
        for r in range(runs):
            eng = PrivacyEngine(model.apply, params, batches[0], dp,
                                optimizer=optimizer, lr=lr, run_seed=0,
                                sampling_rate=1 / 128, device="cuda",
                                mesh=mesh, param_axes=axes, fsdp=fsdp,
                                donate_opt=donate_opt)
            if callable(needs):
                needs = needs(eng, steps)
            init = sgdm_init if optimizer == "sgdm" else adamw_init
            # whole params may wait on the host: the slices go to the card
            p = tree_map(lambda t: t.to(eng.device), eng.shard_params(params))
            opt = init(p)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            del sync[:]
            st.timing = r == 1
            step_ms, per_step, coll, losses = [], [], [], []
            for s in range(steps):
                ops.reset_launches()
                st.reset()
                t = time.perf_counter()
                p, opt, loss, aux = eng.private_step(p, opt, batches[s],
                                                     step=s)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                per_step.append({k: v for k, v in ops.LAUNCHES.items()})
                coll.append({"calls": dict(st.calls),
                             "mb": {a: v / 2**20 for a, v in st.bytes.items()},
                             "ms": ({a: v * 1e3 for a, v in st.seconds.items()}
                                    if st.timing else "not timed"),
                             "fsdp_gather": {
                                 "calls": st.gather["calls"],
                                 "mb": st.gather["bytes"] / 2**20,
                                 "ms": (st.gather["seconds"] * 1e3
                                        if st.timing else "not timed")}})
                losses.append(float(loss))
            st.timing = False
            for k, want in needs.items():
                got = [c[k] for c in per_step]
                check(got == want, f"sharded lane: {k} launches per step "
                      f"{got}, the plan says {want}")
            check(all(math.isfinite(v) for v in losses),
                  f"sharded lane: loss {losses}")
            rec["runs"].append({
                "step_ms": step_ms, "all_reduce_ms": [m for m, _ in sync],
                "leaves_synced_a_step": [n for _, n in sync],
                "collectives_each_step": coll,
                "launches_each_step": per_step, "losses": losses,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "persistent_gb": {"params": tree_bytes(p) / 1e9,
                                  "opt": tree_bytes(opt) / 1e9},
                "clip_fraction": float(aux["clip_fraction"]),
                "digest": tree_digest(p)})
            if r == 0:
                plan = eng.plan()
                rec["plan"] = (plan.realizations()
                               if dp.strategy == "auto" else None)
                rec["plan_coll_mb_by_axis"] = {
                    a: v / 2**20 for a, v in plan.total_coll_bytes_by_axis}
                rec["n_param_leaves"] = len(leaf_paths(params))
                specs = eng.param_specs
                if specs is not None:
                    rec["leaves_sliced"] = sum(
                        sharding.is_sharded(get_subtree(specs, q))
                        for q in leaf_paths(specs))
                if fsdp:
                    rec["leaves_data_sliced"] = sum(
                        bool(sharding.data_dims(get_subtree(specs, q)))
                        for q in leaf_paths(specs))
                first = eng.gather_params(p) if whole else p
            del p, opt, eng
            torch.cuda.empty_cache()
    finally:
        clipping.sync_grads = real
        st.timing = False
    rec["runs_bitwise_equal"] = len({r["digest"] for r in rec["runs"]}) == 1
    return rec, first


def released_mean_bound(B, C):
    """How far two released noised means of one batch may lie apart, a
    coordinate, when their clipped sums add the same terms in another
    order (``shard_reference``): 2·u·√B·C plus one rounding of the noised
    sum."""
    return 2 * U32 * (math.sqrt(B) * C + 1.0)


# A parameter's unit in the last place, relative to the largest |param|:
# one rounding of an update to the param dtype.
PARAM_ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}


def released_param_bound(B, C, lr, steps, pmax, dtype, beta=0.9):
    """How far the released params of a sharded run and of one device's
    run of the same batches may lie apart, a coordinate: each step's
    noised means within ``released_mean_bound`` (the same clipped terms
    summed in another order, the same noise), carried by SGD with
    momentum β into the params by lr·Σ_s Σ_{j<s} β^j of them (over 2
    steps 2.9·lr), plus one rounding of each update to the param dtype
    (an ulp of the largest param: bf16 params land an ulp apart where
    the two f32 updates straddle a rounding boundary).  In bf16 the
    rounding term is about 2^-6 (the norm scales are near 1), larger than
    any update these rates make: there the comparison holds the sharded
    run to one device's, and an f32 gradient check (``ma_f32_check``)
    holds the gradient."""
    carry = sum(sum(beta ** j for j in range(s)) for s in range(1, steps + 1))
    return (carry * lr * released_mean_bound(B, C)
            + steps * PARAM_ULP[dtype] * pmax)


def shard_reference(torch, model, params, batches, dp, steps, got):
    """The single-device engine on the same global batches and run_seed
    (rank 0 alone, SGD with momentum, the state donated as in the
    sharded lanes' largest step): the largest |Δ param| against the
    sharded run's (``got``: whole params, on the card or the host), the
    bound it is held to and the run's peak.  The sharded clipped sum adds
    the same terms in another order: each sum within the f32 sum bound
    of kernels/bounds.py, u·√B·Σ_b|w_b g_b| ≤ u·√B·B·C a coordinate
    (every clipped gradient has norm ≤ C), so the released means differ
    by at most g_tol (``released_mean_bound``), which the optimizer
    carries into the params (``released_param_bound``, in the params'
    dtype)."""
    from repro_torch.core import PrivacyEngine
    from repro_torch.optim import sgdm_init
    from repro_torch.tree import get_subtree, leaf_paths
    B = int(next(iter(batches[0].values())).shape[0])
    eng = PrivacyEngine(model.apply, params, batches[0], dp, optimizer="sgdm",
                        donate_opt=True, lr=SH_LR, run_seed=0,
                        sampling_rate=1 / 128, device="cuda")
    p, opt = params, sgdm_init(params)
    torch.cuda.reset_peak_memory_stats()
    for s in range(steps):
        p, opt, _, _ = eng.private_step(p, opt, batches[s], step=s)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del opt, eng
    diff = max(float((get_subtree(p, q).float() - get_subtree(got, q).to(
        "cuda").float()).abs().max()) for q in leaf_paths(p))
    pmax = max(float(get_subtree(p, q).abs().max()) for q in leaf_paths(p))
    dtype = str(get_subtree(p, leaf_paths(p)[0]).dtype).split(".")[-1]
    bound = released_param_bound(B, dp.l2_clip, SH_LR, steps, pmax, dtype)
    check(diff <= bound, f"sharded vs single-device params: {diff:.3e} > "
          f"{bound:.3e}")
    del p
    torch.cuda.empty_cache()
    return {"max_abs_param_diff": diff, "bound": bound, "param_dtype": dtype,
            "g_tol": released_mean_bound(B, dp.l2_clip),
            "single_device_peak_gb": peak}


def shard_worker(out_dir):
    """One rank of phase sharded_main_path (under torch.distributed.run):
    the gloo group on cuda:0, then full-width AlexNet's lanes, the
    cut Llama lane and the collective calibration; this rank's
    record goes to ``out_dir/rank<r>.json``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.calibrate import harness
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.mesh import init_distributed, make_mesh_from_spec
    from repro_torch.launch.train import deterministic_step
    from repro_torch.models.cnn import CNN
    from repro_torch.models.lm import TransformerLM
    check(torch.cuda.is_available(), "a rank sees no card")
    wall = {}
    await_gate(out_dir, wall)
    dev = init_distributed("gloo")
    rank = dist.get_rank()
    mesh = make_mesh_from_spec(f"data:{SH_RANKS}", device_type="cuda")
    rec = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "world": dist.get_world_size(), "wall": wall}
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    rec["gloo_cuda_all_reduce"] = {
        "ok": bool((x == sum(range(1, SH_RANKS + 1))).all()),
        "result_device": str(x.device)}
    check(rec["gloo_cuda_all_reduce"]["ok"], "gloo all-reduce of a CUDA "
          "tensor gave a wrong sum")
    # Where gloo moves a CUDA tensor: the copies in a profiled all-reduce.
    y = torch.zeros(1 << 18, device=dev)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dist.all_reduce(y)
        torch.cuda.synchronize()
    copies = sorted({e.name for e in prof.events()
                     if "memcpy" in e.name.lower()})
    rec["gloo_cuda_all_reduce"]["copies_traced"] = copies
    rec["gloo_cuda_all_reduce"]["staged_through_host"] = (
        any("dtoh" in c.lower().replace(" ", "") for c in copies)
        and any("htod" in c.lower().replace(" ", "") for c in copies))
    with deterministic_step():
        cfg = get_config("alexnet")
        model = CNN(cfg)
        params, _ = model.init(0, device="cuda")
        batches = image_batches(torch, IMG, 1000, B, SH_STEPS)
        knobs = NormCfg(conv_impl="pallas")
        runs = [("crb", "crb", "flat",
                 {"pe_conv_grad_2d": [len(PE_CASES)] * SH_STEPS}),
                ("auto_flat", "auto", "flat", planned_needs),
                ("auto_stale", "auto", "stale", planned_needs)]
        rec["alexnet"] = {}
        for lane, strategy, clip, needs in runs:
            dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0,
                          strategy=strategy, norm=knobs,
                          clipping=ClipPolicy(mode=clip))
            r, p = shard_lane(torch, model, params, batches, dp, SH_STEPS,
                              mesh, needs, "sgdm", SH_LR)
            digests = [None] * SH_RANKS
            dist.all_gather_object(digests, r["runs"][0]["digest"])
            r["ranks_bitwise_equal"] = len(set(digests)) == 1
            check(r["ranks_bitwise_equal"], f"alexnet {lane}: the ranks' "
                  f"params differ")
            check(r["runs_bitwise_equal"], f"alexnet {lane}: two sharded "
                  f"runs differ")
            if rank == 0:
                r["vs_single_device"] = shard_reference(
                    torch, model, params, batches, dp, SH_STEPS, p)
            del p
            torch.cuda.empty_cache()
            dist.barrier()
            rec["alexnet"][lane] = r
        del params, batches, model
        torch.cuda.empty_cache()

        cfg = get_config("llama3.2-1b").replace(attn_impl="flash",
                                                n_layers=SH_LLAMA_LAYERS)
        model = TransformerLM(cfg)
        params, _ = model.init(0, device="cuda")
        ds = SyntheticLMDataset(cfg.vocab, LM_T, n_examples=4096, seed=0)
        batches = [{k: torch.from_numpy(v).cuda() for k, v in
                    ds.batch(range(s * LM_B, (s + 1) * LM_B)).items()}
                   for s in range(SH_LLAMA_STEPS)]
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy="auto",
                      clipping=ClipPolicy(mode="stale"))
        fused = 5 * SH_LLAMA_LAYERS
        needs = dict(flash_needs(SH_LLAMA_STEPS, layers=SH_LLAMA_LAYERS),
                     gram_norm_fused=[0] + [fused] * (SH_LLAMA_STEPS - 1))
        r, p = shard_lane(torch, model, params, batches, dp, SH_LLAMA_STEPS,
                          mesh, needs, "adamw", 1e-4, runs=1)
        digests = [None] * SH_RANKS
        dist.all_gather_object(digests, r["runs"][0]["digest"])
        r["ranks_bitwise_equal"] = len(set(digests)) == 1
        check(r["ranks_bitwise_equal"], "llama: the ranks' params differ")
        check(all(n == r["n_param_leaves"]
                  for n in r["runs"][0]["leaves_synced_a_step"]),
              "llama: leaves synced a step != param leaves (the tied "
              "embed/head group must sync once)")
        r["tied_group_synced_once"] = True
        r["cuts"] = {"n_layers": SH_LLAMA_LAYERS}
        rec[SH_LLAMA_LANE] = r
        del p, params, batches, model
        torch.cuda.empty_cache()

        # Phase fsdp_path's f32 gradient: Llama-3.2-1B at full width, cut
        # to FS_LLAMA_LAYERS, its params sliced over data (FSDP), σ = 0,
        # against one device's.
        t = time.perf_counter()
        cfg = get_config("llama3.2-1b").replace(
            attn_impl="flash", n_layers=FS_LLAMA_LAYERS, dtype="float32")
        (b,) = mx_lm_batches(torch, cfg, LM_B, LM_T, 1)
        rec["llama_f32_fsdp_check"] = ma_f32_check(
            torch, dist, mesh, cfg, b, "cuda",
            key=torch.Generator(device="cuda").manual_seed(0), sigma=0.0,
            fsdp=True)
        rec["llama_f32_fsdp_check"]["cuts"] = {"n_layers": FS_LLAMA_LAYERS}
        rec["llama_f32_fsdp_check_s"] = time.perf_counter() - t
        del b
        torch.cuda.empty_cache()

    rec["collective_bytes_per_second"] = {
        "data": harness.measure_collective_bytes_per_second(
            "data", SH_RANKS, device="cuda"),
        "what": "gloo, staged through the host, two ranks on one card; "
                "not an NVLink or NCCL figure"}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def nccl_probe(out_dir):
    """One rank of the NCCL probe: an NCCL group of two ranks on cuda:0
    and one all-reduce; the rank records whether NCCL refused."""
    import torch
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    rec = {"rank": rank}
    try:
        import datetime
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        rec.update(refused=False, sum=float(x[0]))
    except Exception as e:   # what NCCL says is the finding
        rec.update(refused=True, error=f"{type(e).__name__}: {e}"[:600])
    with open(os.path.join(out_dir, f"nccl_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    os._exit(0)


def shard_verify(torch):
    """``engine.verify()`` of full-width AlexNet ``auto`` stale on a
    ``data:2`` spec over fake CUDA tensors (two ranks of a fake group;
    after the flat bootstrap step): clean, the sharding pass's record,
    and its kernel nodes equal to the launches of the next real step
    under the same plan (run unsharded by this process)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg, PrivacyEngine
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import CNN
    from repro_torch.optim import adamw_init
    model = CNN(get_config("alexnet"))
    params, _ = model.init(0, device="cuda")
    batches = image_batches(torch, IMG, 1000, B, 2)
    dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy="auto",
                  norm=NormCfg(conv_impl="pallas"),
                  clipping=ClipPolicy(mode="stale"))
    eng = PrivacyEngine(model.apply, params, batches[0], dp,
                        optimizer="adamw", lr=1e-4, run_seed=0,
                        device="cuda", mesh=f"data:{SH_RANKS}")
    p, opt, _, _ = eng.private_step(params, adamw_init(params), batches[0],
                                    step=0)
    before = dict(ops.LAUNCHES)
    t = time.perf_counter()
    report = eng.verify(coll_bytes_warn=1 << 40)
    verify_s = time.perf_counter() - t
    check(ops.LAUNCHES == before, "sharded verify launched a kernel")
    check(report.ok and not report.warnings,
          f"sharded verify:\n{report.summary()}")
    ops.reset_launches()
    eng.private_step(p, opt, batches[1], step=1)
    torch.cuda.synchronize()
    got = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(report.census["kernels"] == got, f"sharded verify: kernel nodes "
          f"{report.census['kernels']} != the step's launches {got}")
    coll = eng.plan().total_coll_bytes
    del p, opt, eng, params, batches
    torch.cuda.empty_cache()
    return {"verify_s": verify_s, "target": report.target,
            "sharding": report.checked["sharding"],
            "kernel_nodes": report.census["kernels"],
            "nodes": report.census["nodes"],
            "plan_coll_mb_a_step_and_rank": coll / 2**20}


def sharded_cli(base):
    """The training CLI under torch.distributed.run on ``data:2`` with
    gloo, straight and with ``--fail-at 2`` at once: both end with the
    same step-3 checkpoint, bitwise, which records the mesh."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.checkpoint import Checkpointer
    d1, d2 = str(base / "cli_straight"), str(base / "cli_killed")

    def run(extra, d):
        return torchrun(["-m", "repro_torch.launch.train", *SH_CLI, *extra,
                         "--ckpt-dir", d], SH_TIMEOUT_S)

    with ThreadPoolExecutor(2) as pool:
        f1, f2 = pool.submit(run, [], d1), pool.submit(run, ["--fail-at",
                                                             "2"], d2)
        (rc1, out1, err1, w1), (rc2, out2, err2, w2) = f1.result(), \
            f2.result()
    for rc, out, err in ((rc1, out1, err1), (rc2, out2, err2)):
        check(rc == 0, f"sharded CLI: exit {rc}\n{out[-2000:]}\n"
              f"{err[-4000:]}")
    # the ranks share one stdout: their lines may run together
    dec, summaries = json.JSONDecoder(), []
    for out in (out1, out2):
        i = out.find('{"train_summary"')
        while i >= 0:
            obj, end = dec.raw_decode(out, i)
            summaries.append(obj["train_summary"])
            i = out.find('{"train_summary"', end)
    check(len(summaries) == 2 * SH_RANKS, "sharded CLI: summaries")
    check(out2.count("[restore] resuming from step 2") == SH_RANKS,
          "sharded CLI: the killed run did not resume from step 2 on "
          "every rank")
    n = same_checkpoint(d1, d2, 3, False)
    meta = Checkpointer(d1).read_meta(3)
    check(meta["mesh_axes"] == [["data", SH_RANKS]],
          f"sharded CLI: checkpoint mesh {meta['mesh_axes']}")
    return {"args": SH_CLI, "wall_s": [w1, w2],
            "bitwise_equal_arrays": n, "mesh_axes": meta["mesh_axes"],
            "per_rank": [{k: s[k] for k in ("rank", "mesh", "restarts",
                                            "step_ms", "losses_last_segment")}
                         for s in summaries]}


def sharded_worlds():
    """Phase sharded_main_path's ranks, started now (``World``)."""
    shutil.rmtree(SH_DIR, ignore_errors=True)
    SH_DIR.mkdir(parents=True)
    return {f"data:{SH_RANKS}": World([str(ROOT / "chip_smoke.py"),
                                       "--shard-worker", str(SH_DIR)],
                                      SH_RANKS, SH_TIMEOUT_S, SH_DIR)}


def sharded_main_path(torch, launches, lanes, worlds):
    """Phase sharded_main_path (module comment above): the ranks' lanes
    (``shard_worker``; ``worlds``: started ahead, released now), the
    NCCL probe and the sharded CLI lane, each in processes of their own
    and at once, and the verifier in this process meanwhile."""
    t0 = time.perf_counter()
    (world,) = worlds.values()
    torch.cuda.empty_cache()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        # The CLI lane's and the probe's processes run beside the ranks,
        # and this process verifies while the ranks start (so the ranks'
        # times below are read under that host load).
        ranks_run = pool.submit(world.result)
        probe = pool.submit(torchrun, [str(ROOT / "chip_smoke.py"),
                                       "--nccl-probe", str(SH_DIR)], 120)
        cli = pool.submit(sharded_cli, SH_DIR)
        t = time.perf_counter()
        verify_rec = shard_verify(torch)
        verify_rec["seconds"] = time.perf_counter() - t
        rc, out, err, wall, waited = ranks_run.result()
        check(rc == 0, f"sharded ranks: exit {rc}\n{out[-3000:]}\n"
              f"{err[-5000:]}")
        prc, pout, perr, pwall = probe.result()
        cli_rec = cli.result()
    ranks = [json.loads((SH_DIR / f"rank{r}.json").read_text())
             for r in range(SH_RANKS)]
    FSDP_RECORDS["llama_f32"] = dict(
        ranks[0]["llama_f32_fsdp_check"],
        seconds=ranks[0]["llama_f32_fsdp_check_s"])
    nccl = [json.loads(p.read_text())
            for p in sorted(SH_DIR.glob("nccl_rank*.json"))]
    found = ("killed after 120 s" if prc is None else
             "refused" if nccl and all(r["refused"] for r in nccl) else
             "accepted" if nccl else f"no record (exit {prc})")
    for r in ranks:
        for lane, rec in list(r["alexnet"].items()) + [
                (SH_LLAMA_LANE, r[SH_LLAMA_LANE])]:
            name = f"sharded_{lane}_rank{r['rank']}"
            lanes[name] = {k: [c[k] for c in
                               rec["runs"][0]["launches_each_step"]]
                           for k in launches
                           if any(c[k] for c in
                                  rec["runs"][0]["launches_each_step"])}
            if r["rank"] == 0:
                for k, v in lanes[name].items():
                    launches[k] += sum(v)
    log({"phase": "sharded_main_path", "ranks": SH_RANKS,
         "backend": "gloo",
         "why": f"NCCL {found} two ranks on one device (probe below); "
                f"gloo all-reduces CUDA tensors by staging them through "
                f"the host (the copies traced per rank below), so its "
                f"rates are the host's, not NVLink's or NCCL's",
         "nccl_probe": {"found": found, "exit": prc, "seconds": pwall,
                        "ranks": nccl, "stderr_tail": perr[-600:]},
         "gloo_cuda_all_reduce": [r["gloo_cuda_all_reduce"] for r in ranks],
         "ranks_wall_s": wall, "world_ready_ahead_s": waited,
         "ranks_wall": [r["wall"] for r in ranks],
         "alexnet": {r["rank"]: r["alexnet"] for r in ranks},
         SH_LLAMA_LANE: {r["rank"]: r[SH_LLAMA_LANE] for r in ranks},
         "collective_bytes_per_second": [r["collective_bytes_per_second"]
                                         for r in ranks],
         "verify": verify_rec, "cli_lane": cli_rec,
         "seconds": time.perf_counter() - t0, "ok": True})
    shutil.rmtree(SH_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# Model-axis sharding on one card (ROADMAP item 14 part 2): phase
# model_axis_path.  The ranks run gloo on cuda:0 as sharded_main_path's do;
# every layout move of the tensor-sharded step is a gloo all-reduce staged
# through the host, so the collective times below are the host's: the
# phase shows the kernels running on shards and the sharded step equal to
# the single-device step, and claims no speed.

MA_DIR = ROOT / "build" / "chip_smoke_model_axis"
MA_TIMEOUT_S = 420
MA_MESHES = {"model:2": 2, "data:2,model:2": 4}
MA_CLI = ["--arch", "alexnet", "--full", "--batch", "32", "--strategy",
          "auto", "--noise", "1.0", "--mesh", "data:2,model:2",
          "--backend", "gloo", "--steps", "4", "--ckpt-every", "2"]


def ma_agree(torch, dist, mesh, r, lane):
    """The ranks of one model slot hold bitwise-equal slices (across the
    data ranks), and the two runs are bitwise equal."""
    names = tuple(mesh.mesh_dim_names)
    slot = mesh.get_local_rank(names.index("model"))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (slot, r["runs"][0]["digest"]))
    by_slot = {}
    for s, dg in got:
        by_slot.setdefault(s, set()).add(dg)
    r["model_slots_bitwise_equal"] = all(len(v) == 1
                                         for v in by_slot.values())
    r["slots_differ"] = len({next(iter(v)) for v in by_slot.values()}) > 1
    check(r["model_slots_bitwise_equal"], f"{lane}: the ranks of one model "
          f"slot differ")
    check(r["slots_differ"], f"{lane}: the model slots hold the same "
          f"params (nothing sliced?)")
    check(r["runs_bitwise_equal"], f"{lane}: two runs differ")


# The model-axis Llama lanes run bf16 under AdamW at lr 1e-4, which moves
# no param by a bf16 ulp, so their params cannot show a wrong gradient.
# One f32 private gradient of the same full-width model is held instead
# (ma_f32_check): every per-example and per-layer norm within
# MA_NORM_RTOL of one device's (compare's rule), ten times the kernels'
# own rtol, since both sides' norms come from gram_norm; a sliced leaf's
# partial norm left unsummed over model is about 30 % off, and so is wk's
# from a partial cotangent.  The loss within MA_LOSS_RTOL (f32 logsumexp
# over the vocabulary, in halves or whole), the gathered noised mean within
# released_mean_bound a coordinate.
MA_NORM_RTOL = 1e-3
MA_LOSS_RTOL = 1e-5


def ma_gram_slices(torch, slices):
    """``gram_norm`` against its plain version (``compare``'s rule at
    RTOL) at every (x, dy) shape, stride and dtype the Llama lanes handed
    it on this rank's slices, on seeded random inputs."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for xs, xst, ds, dst, dt, hb in sorted(slices):
        tdt = getattr(torch, dt)

        def rnd(shape, stride):
            t = torch.empty_strided(shape, stride, dtype=tdt, device="cuda")
            return t.copy_(torch.randn(shape, generator=g, device="cuda"))

        x, dy = rnd(xs, xst), rnd(ds, dst)
        got = ops.gram_norm(x, dy, has_bias=hb)
        want = ref.gram_norm_ref(x, dy, has_bias=hb)
        abs_err, rel_err, ok = compare(torch, got, want, dt)
        rows.append({"x": list(xs), "dy": list(ds), "dtype": dt,
                     "has_bias": hb, "contiguous": x.is_contiguous()
                     and dy.is_contiguous(),
                     "route": ops.gram_route(xs[1], xs[2], ds[2]),
                     "max_abs_err": abs_err, "max_rel_err": rel_err,
                     "rtol": RTOL[dt], "ok": ok})
        check(ok, f"gram_norm on a model-axis slice, x {xs}, dy {ds}, {dt}: "
              f"{rel_err:.3e} from its plain version")
        del x, dy, got, want
    check(rows, "the Llama lanes handed gram_norm no slice")
    torch.cuda.empty_cache()
    return rows


def ma_f32_check(torch, dist, mesh, cfg, batch, device, key=0, sigma=1.0,
                 grad_rtol=0.0, fsdp=False):
    """One noised clipped mean gradient (``noisy_grad``) of ``cfg`` (f32)
    under bk with the kernel norms and per-layer clipping, on this rank's
    slices and then, on rank 0, on one device from the same whole params
    (``model.init(key)``: a seed, or a generator on the card, which every
    rank seeds alike), batch and key: the loss, every per-example and
    per-layer norm and the gathered gradient are held (bounds above; the
    gradient's bound grows by ``grad_rtol`` of one device's largest
    coordinate, where the model's per-example gradients themselves carry
    rounding: the recurrences, ``RX_GRAD_RTOL``).  ``sigma``: the noise
    multiplier; ``fsdp``: the params sliced over the data axes too (the
    collectives' bytes by axis then recorded).  Rank 0's readings, an
    empty record on the other ranks."""
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg, PrivacyEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.tree import get_subtree, leaf_paths
    model = build_model(cfg)
    params, axes = model.init(key, device=device)
    dp = DPConfig(l2_clip=1.0, noise_multiplier=sigma, strategy="bk",
                  norm=NormCfg(dense="pallas"),
                  clipping=ClipPolicy(mode="per_layer"))
    kw = dict(optimizer="sgdm", lr=SH_LR, run_seed=0, device=device)
    eng = PrivacyEngine(model.apply, params, batch, dp, mesh=mesh,
                        param_axes=axes, fsdp=fsdp, **kw)
    local = eng.shard_params(params)
    ops.reset_launches()
    sharding.COLL_STATS.reset()
    loss, grad, aux = eng.noisy_grad(local, batch, step=0)
    st = sharding.COLL_STATS
    coll = {"mb": {a: v / 2**20 for a, v in st.bytes.items()},
            "fsdp_gather_mb": st.gather["bytes"] / 2**20,
            "calls": dict(st.calls)}
    del local
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(launches.get("gram_norm", 0) > 0, f"f32 model-axis check: no "
          f"gram_norm launch ({launches})")
    grad = eng.gather_params(grad)
    del eng
    torch.cuda.empty_cache()
    rec = {}
    if dist.get_rank() == 0:
        one = PrivacyEngine(model.apply, params, batch, dp, **kw)
        l1, g1, a1 = one.noisy_grad(params, batch, step=0)
        B = int(next(iter(batch.values())).shape[0])
        rec = {"dtype": "float32", "strategy": "bk", "clip": "per_layer",
               "launches": launches, "loss": float(loss),
               "loss_one_device": float(l1),
               "loss_rel_diff": abs(float(loss) - float(l1))
               / abs(float(l1)), "loss_rtol": MA_LOSS_RTOL,
               "norm_rtol": MA_NORM_RTOL, "sigma": sigma,
               "grad_largest": max(float(get_subtree(g1, q).abs().max())
                                   for q in leaf_paths(g1)),
               "grad_rtol": grad_rtol, "fsdp": fsdp,
               "collectives": coll}
        rec["grad_bound"] = (released_mean_bound(B, dp.l2_clip)
                             + grad_rtol * rec["grad_largest"])
        for k in ("per_example_norms", "per_layer_norms"):
            abs_err, rel_err, ok = compare(torch, aux[k], a1[k], "float32",
                                           rtol=MA_NORM_RTOL)
            rec[k] = {"shape": list(a1[k].shape), "max_abs_err": abs_err,
                      "max_rel_err": rel_err}
            check(ok, f"f32 model-axis check: {k} {rel_err:.3e} from one "
                  f"device's (rtol {MA_NORM_RTOL})")
        check(rec["loss_rel_diff"] <= MA_LOSS_RTOL, f"f32 model-axis check: "
              f"loss {float(loss)!r} vs one device's {float(l1)!r}")
        rec["grad_max_abs_diff"] = max(
            float((get_subtree(grad, q) - get_subtree(g1, q)).abs().max())
            for q in leaf_paths(g1))
        check(rec["grad_max_abs_diff"] <= rec["grad_bound"], f"f32 model-axis "
              f"check: gradients {rec['grad_max_abs_diff']:.3e} apart > "
              f"{rec['grad_bound']:.3e}")
        if grad_rtol:
            # each leaf against its own largest coordinate too: a small
            # leaf's gradient is not hidden by a large one's scale
            rel = {"/".join(map(str, q)): float(
                (get_subtree(grad, q) - get_subtree(g1, q)).abs().max()
                / get_subtree(g1, q).abs().max().clamp_min(1e-30))
                for q in leaf_paths(g1)}
            worst = max(rel, key=rel.get)
            rec["grad_leaf_rel_diff"] = {"largest": rel[worst],
                                         "leaf": worst}
            for q in leaf_paths(g1):
                d = float((get_subtree(grad, q)
                           - get_subtree(g1, q)).abs().max())
                lim = released_mean_bound(B, dp.l2_clip) + grad_rtol * float(
                    get_subtree(g1, q).abs().max())
                check(d <= lim, f"f32 model-axis check: leaf "
                      f"{'/'.join(map(str, q))} {d:.3e} apart > {lim:.3e}")
        del one, g1, a1
    del params, grad, aux
    torch.cuda.empty_cache()
    dist.barrier()
    return rec


def model_axis_worker(spec, out_dir):
    """One rank of phase model_axis_path (under torch.distributed.run) on
    mesh ``spec``: full-width AlexNet's lanes and, on ``model:2``, the
    Llama lanes (MA_LLAMA_LAYERS deep) and the model group's collective
    calibration;
    this rank's record goes to ``out_dir/<spec>_rank<r>.json``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.calibrate import harness
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.mesh import init_distributed, make_mesh_from_spec
    from repro_torch.launch.train import deterministic_step
    from repro_torch.models.cnn import CNN
    from repro_torch.models.lm import TransformerLM
    check(torch.cuda.is_available(), "a rank sees no card")
    wall = {}
    await_gate(out_dir, wall)
    dev = init_distributed("gloo")
    rank = dist.get_rank()
    mesh = make_mesh_from_spec(spec, device_type="cuda")
    rec = {"rank": rank, "mesh": spec, "device": str(dev),
           "model_rank": mesh.get_local_rank(
               tuple(mesh.mesh_dim_names).index("model")), "wall": wall}
    with deterministic_step():
        cfg = get_config("alexnet")
        model = CNN(cfg)
        params, axes = model.init(0, device="cuda")
        batches = image_batches(torch, IMG, 1000, B, SH_STEPS)
        knobs = NormCfg(conv_impl="pallas")
        rec["alexnet"] = {}
        for lane, strategy, clip, needs in (
                ("crb", "crb", "flat",
                 {"pe_conv_grad_2d": [len(PE_CASES)] * SH_STEPS}),
                ("auto_flat", "auto", "flat", planned_needs),
                ("auto_stale", "auto", "stale", planned_needs)):
            dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0,
                          strategy=strategy, norm=knobs,
                          clipping=ClipPolicy(mode=clip))
            r, whole = shard_lane(torch, model, params, batches, dp,
                                  SH_STEPS, mesh, needs, "sgdm", SH_LR,
                                  axes=axes)
            ma_agree(torch, dist, mesh, r, f"alexnet {lane} on {spec}")
            if rank == 0:
                r["vs_single_device"] = shard_reference(
                    torch, model, params, batches, dp, SH_STEPS, whole)
            del whole
            torch.cuda.empty_cache()
            dist.barrier()
            rec["alexnet"][lane] = r
        del params, batches, model
        torch.cuda.empty_cache()
        if spec == "model:2":
            cfg = get_config("llama3.2-1b").replace(
                attn_impl="flash", n_layers=MA_LLAMA_LAYERS)
            model = TransformerLM(cfg)
            params, axes = model.init(0, device="cuda")
            ds = SyntheticLMDataset(cfg.vocab, LM_T, n_examples=4096, seed=0)
            batches = [{k: torch.from_numpy(v).cuda() for k, v in
                        ds.batch(range(s * LM_B, (s + 1) * LM_B)).items()}
                       for s in range(SH_LLAMA_STEPS)]
            flash = flash_needs(SH_LLAMA_STEPS, layers=MA_LLAMA_LAYERS)

            def stale_needs(eng, steps):
                # the model-axis plan's fused layers, read off it
                return dict(flash, **planned_needs(eng, steps))
            # bk with the kernel norms: gram_norm once a dense a layer
            # (wq, wk, wv, wo, w_gate, w_up, w_down) and once at the
            # tied head, on the rank's slices.
            bk_needs = dict(flash, gram_norm=[7 * MA_LLAMA_LAYERS + 1]
                            * SH_LLAMA_STEPS)
            from repro_torch.kernels import ops
            real_gram, slices = ops.gram_norm, set()

            def gram_spy(x, dy, *, has_bias=False):
                slices.add((tuple(x.shape), tuple(x.stride()),
                            tuple(dy.shape), tuple(dy.stride()),
                            str(x.dtype).split(".")[-1], bool(has_bias)))
                return real_gram(x, dy, has_bias=has_bias)

            for lane, strategy, clip, knobs, needs in (
                    ("auto_stale", "auto", "stale", NormCfg(), stale_needs),
                    ("bk", "bk", "flat", NormCfg(dense="pallas"),
                     bk_needs)):
                dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0,
                              strategy=strategy, norm=knobs,
                              clipping=ClipPolicy(mode=clip))
                ops.gram_norm = gram_spy
                try:
                    r, whole = shard_lane(torch, model, params, batches, dp,
                                          SH_LLAMA_STEPS, mesh, needs,
                                          "adamw", 1e-4, axes=axes)
                finally:
                    ops.gram_norm = real_gram
                ma_agree(torch, dist, mesh, r, f"llama {lane}")
                r["cuts"] = {"n_layers": MA_LLAMA_LAYERS}
                r["local_heads"] = cfg.n_heads // 2
                del whole
                torch.cuda.empty_cache()
                dist.barrier()
                rec[f"llama_depth{MA_LLAMA_LAYERS}_{lane}"] = r
            b0 = batches[0]
            del params, batches, model
            torch.cuda.empty_cache()
            if rank == 0:
                rec["gram_norm_on_slices"] = ma_gram_slices(torch, slices)
            rec["f32_check"] = ma_f32_check(
                torch, dist, mesh, cfg.replace(dtype="float32"), b0, "cuda")
            del b0
    names = tuple(mesh.mesh_dim_names)
    rec["collective_bytes_per_second"] = {
        a: harness.measure_collective_bytes_per_second(
            a, int(mesh.shape[names.index(a)]),
            group=mesh.get_group(names.index(a)), device="cuda")
        for a in names if int(mesh.shape[names.index(a)]) > 1}
    rec["collective_bytes_per_second"]["what"] = (
        "gloo, staged through the host, ranks sharing one card; not an "
        "NVLink or NCCL figure")
    tag = spec.replace(":", "").replace(",", "_")
    with open(os.path.join(out_dir, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def ma_verify(torch):
    """``engine.verify()`` of full-width AlexNet ``auto`` stale on a
    ``data:2,model:2`` spec over fake CUDA tensors: clean, partitioned
    over model, no launch; its kernel nodes (rank (0, 0)'s trace) are
    compared with a real rank's stale step by the caller."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg, PrivacyEngine
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import CNN
    model = CNN(get_config("alexnet"))
    params, axes = model.init(0, device="cuda")
    batches = image_batches(torch, IMG, 1000, B, 1)
    dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy="auto",
                  norm=NormCfg(conv_impl="pallas"),
                  clipping=ClipPolicy(mode="stale"))
    eng = PrivacyEngine(model.apply, params, batches[0], dp,
                        optimizer="sgdm", lr=SH_LR, run_seed=0,
                        device="cuda", mesh="data:2,model:2",
                        param_axes=axes)
    before = dict(ops.LAUNCHES)
    t = time.perf_counter()
    report = eng.verify()
    verify_s = time.perf_counter() - t
    check(ops.LAUNCHES == before, "model-axis verify launched a kernel")
    check(report.ok and not report.warnings,
          f"model-axis verify:\n{report.summary()}")
    check("partitioned over model" in report.checked["sharding"],
          f"model-axis verify: {report.checked['sharding']}")
    del eng, params, batches
    torch.cuda.empty_cache()
    return {"verify_s": verify_s, "target": report.target,
            "sharding": report.checked["sharding"],
            "kernel_nodes": report.census["kernels"],
            "nodes": report.census["nodes"],
            "warnings": [f.code for f in report.warnings]}


def ma_cli(base):
    """The training CLI under torch.distributed.run, 4 ranks on
    ``data:2,model:2`` with gloo, straight and with ``--fail-at 2`` at
    once: both end with the same step-3 checkpoint (whole arrays),
    bitwise, which records the mesh."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.checkpoint import Checkpointer
    d1, d2 = str(base / "cli_straight"), str(base / "cli_killed")

    def run(extra, d):
        return torchrun(["-m", "repro_torch.launch.train", *MA_CLI, *extra,
                         "--ckpt-dir", d], MA_TIMEOUT_S, nproc=4)

    with ThreadPoolExecutor(2) as pool:
        f1, f2 = pool.submit(run, [], d1), pool.submit(run, ["--fail-at",
                                                             "2"], d2)
        (rc1, out1, err1, w1), (rc2, out2, err2, w2) = f1.result(), \
            f2.result()
    for rc, out, err in ((rc1, out1, err1), (rc2, out2, err2)):
        check(rc == 0, f"model-axis CLI: exit {rc}\n{out[-2000:]}\n"
              f"{err[-4000:]}")
    check(out2.count("[restore] resuming from step 2") == 4,
          "model-axis CLI: the killed run did not resume from step 2 on "
          "every rank")
    n = same_checkpoint(d1, d2, 3, False)
    meta = Checkpointer(d1).read_meta(3)
    check(meta["mesh_axes"] == [["data", 2], ["model", 2]],
          f"model-axis CLI: checkpoint mesh {meta['mesh_axes']}")
    return {"args": MA_CLI, "wall_s": [w1, w2], "bitwise_equal_arrays": n,
            "mesh_axes": meta["mesh_axes"]}


def model_axis_worlds():
    """Phase model_axis_path's worlds, started now (``World``)."""
    shutil.rmtree(MA_DIR, ignore_errors=True)
    MA_DIR.mkdir(parents=True)
    return {spec: World([str(ROOT / "chip_smoke.py"), "--model-axis-worker",
                         spec, str(MA_DIR)], n, MA_TIMEOUT_S, MA_DIR)
            for spec, n in MA_MESHES.items()}


def model_axis_path(torch, launches, lanes, worlds):
    """Phase model_axis_path (module comment above): the ``model:2`` and
    ``data:2,model:2`` ranks at once (``worlds``: started ahead, released
    now), the verifier in this process meanwhile, then the CLI lane."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        # The CLI lane's processes run beside the ranks, and this process
        # verifies meanwhile (so the ranks' times are read under that
        # host load).
        runs = {spec: pool.submit(w.result) for spec, w in worlds.items()}
        cli = pool.submit(ma_cli, MA_DIR)
        t = time.perf_counter()
        verify_rec = ma_verify(torch)
        verify_rec["seconds"] = time.perf_counter() - t
        walls, waited = {}, {}
        for spec, fut in runs.items():
            rc, out, err, walls[spec], waited[spec] = fut.result()
            check(rc == 0, f"model-axis ranks ({spec}): exit {rc}\n"
                  f"{out[-3000:]}\n{err[-5000:]}")
        cli_rec = cli.result()
    ranks = {spec: [json.loads((MA_DIR / "{}_rank{}.json".format(
        spec.replace(":", "").replace(",", "_"), r)).read_text())
        for r in range(n)] for spec, n in MA_MESHES.items()}
    # The verifier's trace is rank (0, 0)'s: its kernel nodes are that
    # rank's launches in a stale step after the bootstrap.
    real = ranks["data:2,model:2"][0]["alexnet"]["auto_stale"]["runs"][0][
        "launches_each_step"][1]
    real = {k: v for k, v in real.items() if v}
    check(verify_rec["kernel_nodes"] == real, f"model-axis verify: kernel "
          f"nodes {verify_rec['kernel_nodes']} != rank 0's stale step's "
          f"launches {real}")
    for spec, rs in ranks.items():
        tag = spec.replace(":", "").replace(",", "_")
        for r in rs:
            recs = [(f"alexnet_{k}", v) for k, v in r["alexnet"].items()]
            recs += [(k, v) for k, v in r.items() if k.startswith("llama_")]
            for lane, rec in recs:
                steps = rec["runs"][0]["launches_each_step"]
                name = f"model_axis_{tag}_{lane}_rank{r['rank']}"
                lanes[name] = {k: [c[k] for c in steps] for k in launches
                               if any(c[k] for c in steps)}
                if r["rank"] == 0:
                    for k, v in lanes[name].items():
                        launches[k] += sum(v)
    log({"phase": "model_axis_path", "backend": "gloo",
         "why": "NCCL refuses two ranks on one device (sharded_main_path's "
                "probe); every layout move is a gloo all-reduce staged "
                "through the host, so the collective times are the host's",
         "ranks_wall_s": walls, "worlds_ready_ahead_s": waited,
         "ranks": ranks, "verify": verify_rec,
         "verify_kernel_nodes_equal_rank0_stale_step": True,
         "cli_lane": cli_rec, "seconds": time.perf_counter() - t0,
         "ok": True})
    shutil.rmtree(MA_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase moe_model_axis_path: the MoE family on a model axis (ROADMAP item
# 14 part 3).  Its own torchrun groups, after model_axis_path's ranks have
# finished: data:2,model:2 (4 ranks) and model:2 (2 ranks) at once, the
# model:2 ranks' DeepSeek-V3 layer, which needs most of the card, only
# after the 4-rank group has exited.  Gloo ranks share cuda:0, as
# in the earlier sharded phases.  SGD with momentum, σ = 1, C = 1; each
# lane runs twice (``shard_lane``).
#   * Granite-3.0-1B-A400M at full width, cut to depth 1 (MX_GR_LAYERS;
#     2 before the attention families' lanes needed the room),
#     bf16, flash, B = 8, T = 1024: on model:2 (8 of 16 query heads, 16 of
#     32 experts, 24 640 of 49 280 vocabulary rows a rank) under ``auto``
#     stale and ghost (``gram_norm`` on the sliced denses and the router's
#     16 columns); on data:2,model:2 ``auto`` flat.
#   * One DeepSeek-V3 MoE layer at full width (MLA at d_model 7168 with
#     128 heads, ranks 1536 / 512, expert d_ff 2048, top-8, capacity
#     factor 2.0, 1 shared expert, vocab 129 280), its routed experts cut
#     from 256 to MX_DS_EXPERTS = 64 (every rank shares the one card, so
#     sharding adds no memory: a rank holds 2.4e9 params, its bf16
#     params, f32 clipped sum and f32 momentum about 29 GB, the sum noised
#     and divided in place and the momentum updated in place, the state
#     donated), on model:2 (64 heads and 32 experts a rank), ``auto``
#     flat, ``attn_impl="xla"``, B = 4, T = 512.
# Held: the ranks of a model slot bitwise equal, the two runs bitwise
# equal, the released params within ``released_param_bound`` of one
# device's run of the same batches.  bf16 params at these rates cannot
# show a wrong gradient, so one f32 gradient on model:2 (bk with the
# kernel norms, per-layer clipping: ghost takes no per-layer clipping) is
# held against one device's (``ma_f32_check``'s rules) for each
# model: Granite at depth 1, and the DeepSeek-V3 layer with its routed
# experts cut to MX_DS_F32_EXPERTS (MLA's sliced heads and latent
# copies, the shared expert's partial output, the expert slices).  Each
# lane prints the entries dropped and the share of the expert slot rows
# its entries fill.  ``gram_norm``, ``gram_norm_fused`` and the flash
# kernels at the shapes the lanes handed them, against their plain
# versions.

MX_DIR = ROOT / "build" / "chip_smoke_moe_model_axis"
MX_SIDE_DONE = "data2_model2.done"
MX_TIMEOUT_S = 420
MX_MESHES = {"data:2,model:2": 4, "model:2": 2}
MX_GR_LAYERS = 1
MX_STEPS = 2
MX_DS_EXPERTS = 64
MX_DS_B, MX_DS_T = 4, 512
# The f32 DeepSeek-V3 gradient check's routed experts: 16 (8 a rank,
# top-8 of 16) keeps the whole f32 layer (2.7e9 params) on each rank
# beside one device's gradient.
MX_DS_F32_EXPERTS = 16


def mx_dropped_spy(record):
    """Wrap the MoE dispatch's positions so that each call appends to
    ``record`` the entries this rank drops (global position past the
    capacity) and keeps, as device tensors (no sync in the step), and
    the slot rows of all E experts (E·capacity); returns the undo."""
    from repro_torch.models import moe
    real = moe._global_positions

    def spy(e_flat, E, slots_fn, N, topk, capacity_factor):
        pos, gpos, cap = real(e_flat, E, slots_fn, N, topk, capacity_factor)
        if gpos.device.type != "meta":      # not the planner's probes
            over = gpos >= cap
            record.append((over.sum(), (~over).sum(), E * cap))
        return pos, gpos, cap
    moe._global_positions = spy
    return lambda: setattr(moe, "_global_positions", real)


def mx_dispatch_reading(record):
    """The spy's record of one run: the entries dropped at each dispatch
    and the share of the expert slot rows its kept entries fill (the
    rest are zero rows the expert GEMMs and norms still run over: on a
    data axis each rank's buffer holds the global capacity, fault F6's
    repair)."""
    return {"entries_dropped_each_call": [int(d) for d, _, _ in record],
            "slot_rows_filled_each_call": [int(k) / rows
                                           for _, k, rows in record]}


def mx_lm_batches(torch, cfg, B, T, steps):
    from repro_torch.data import SyntheticLMDataset
    ds = SyntheticLMDataset(cfg.vocab, T, n_examples=4096, seed=0)
    return [{k: torch.from_numpy(v).cuda() for k, v in
             ds.batch(range(s * B, (s + 1) * B)).items()}
            for s in range(steps)]


def mx_lane(torch, dist, mesh, lane, model, params, batches, dp, needs,
            axes, rank, store, moe=True):
    """One lane through ``shard_lane`` with (``moe``) the dropped-entry
    spy and the kernels' shape spies (``mx_spies`` into ``store``), the
    slot and run agreement, and (rank 0, the other ranks waiting) one
    device's run; the whole params go to the host first."""
    dropped = []
    undo = mx_dropped_spy(dropped) if moe else (lambda: None)
    undo_spies = mx_spies(store)
    try:
        r, whole = shard_lane(torch, model, params, batches, dp, MX_STEPS,
                              mesh, needs, "sgdm", SH_LR, axes=axes)
    finally:
        undo()
        undo_spies()
    if moe:
        # the spy saw every dispatch of both runs: each run's own share
        r.update(mx_dispatch_reading(dropped[:len(dropped) // 2]))
    ma_agree(torch, dist, mesh, r, lane)
    from repro_torch.tree import tree_map
    host = tree_map(lambda t: t.cpu(), whole)
    del whole
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        r["vs_single_device"] = shard_reference(torch, model, params,
                                                batches, dp, MX_STEPS, host)
    del host
    torch.cuda.empty_cache()
    dist.barrier()
    return r


def mx_spies(store):
    """Record the shapes, strides and dtypes ``gram_norm``,
    ``gram_norm_fused`` and ``flash_fwd`` are handed into ``store``;
    returns the undo."""
    from repro_torch.kernels import ops
    real = {k: getattr(ops, k) for k in ("gram_norm", "gram_norm_fused",
                                         "flash_fwd")}

    def sig(t):
        return (tuple(t.shape), tuple(t.stride()))

    def gram(x, dy, *, has_bias=False):
        store["gram_norm"].add((sig(x), sig(dy), str(x.dtype)[6:],
                                bool(has_bias)))
        return real["gram_norm"](x, dy, has_bias=has_bias)

    def fused(x, dy, w, *, has_bias=False):
        store["gram_norm_fused"].add((sig(x), sig(dy), str(x.dtype)[6:],
                                      bool(has_bias)))
        return real["gram_norm_fused"](x, dy, w, has_bias=has_bias)

    def flash(q, k, v, *, causal=True):
        store["flash"].add((tuple(q.shape), tuple(k.shape), str(q.dtype)[6:],
                            bool(causal)))
        return real["flash_fwd"](q, k, v, causal=causal)
    ops.gram_norm, ops.gram_norm_fused, ops.flash_fwd = gram, fused, flash
    return lambda: [setattr(ops, k, v) for k, v in real.items()]


def mx_slice_kernels(torch, store, flash=True):
    """``gram_norm_fused`` and (``flash``) the flash forward, dq and
    dk/dv at the shapes the model-axis lanes handed them (``gram_norm``'s
    go through ``ma_gram_slices``), on seeded random inputs, against
    their plain versions at the existing tolerances."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(shape, stride, dt):
        t = torch.empty_strided(shape, stride, dtype=getattr(torch, dt),
                                device="cuda")
        return t.copy_(torch.randn(shape, generator=g, device="cuda"))

    rows = []
    for (xs, xst), (ds, dst), dt, hb in sorted(store["gram_norm_fused"]):
        x, dy = rnd(xs, xst, dt), rnd(ds, dst, dt)
        w = torch.rand(xs[0], generator=g, device="cuda")
        got = ops.gram_norm_fused(x, dy, w, has_bias=hb)
        want = ref.gram_norm_fused_ref(x, dy, w, has_bias=hb)
        errs = [compare(torch, a, c, dt, floor=f)
                for a, c, f in zip(got, want, (1e-3, 1.0, 1.0))]
        ok = all(e[2] for e in errs)
        rows.append({"kernel": "gram_norm_fused", "x": list(xs),
                     "dy": list(ds), "dtype": dt, "has_bias": hb,
                     "max_rel_err": max(e[1] for e in errs), "ok": ok})
        check(ok, f"gram_norm_fused at a model-axis slice x {xs}, dy {ds}: "
              f"{errs}")
        del x, dy, w, got, want
    def dense(shape, dt):
        return rnd(shape, tuple(math.prod(shape[i + 1:])
                                for i in range(len(shape))), dt)

    for qs, ks, dt, causal in sorted(store["flash"]):
        q, do, k, v = dense(qs, dt), dense(qs, dt), dense(ks, dt), \
            dense(ks, dt)
        o, lse = ops.flash_fwd(q, k, v, causal=causal)
        bwd = (q, k, v, do, lse, ops.flash_delta(o, do))
        dq = ops.flash_dq(*bwd, causal=causal)
        dk, dv = ops.flash_dkv(*bwd, causal=causal)
        ro, rl = ref.flash_fwd_ref(q, k, v, causal=causal)
        rdq = ref.flash_dq_ref(*bwd, causal=causal)
        rdk, rdv = ref.flash_dkv_ref(*bwd, causal=causal)
        for name, pairs in (("flash_fwd", ((o, ro), (lse, rl))),
                            ("flash_dq", ((dq, rdq),)),
                            ("flash_dkv", ((dk, rdk), (dv, rdv)))):
            errs = [flash_close(torch, a, c) for a, c in pairs]
            ok = all(e[2] for e in errs)
            rows.append({"kernel": name, "q": list(qs), "k": list(ks),
                         "dtype": dt, "causal": causal,
                         "max_rel_err": max(e[1] for e in errs), "ok": ok})
            check(ok, f"{name} at model-axis heads q {qs}, k {ks}: {errs}")
        del q, k, v, do, o, lse, bwd, dq, dk, dv, ro, rl, rdq, rdk, rdv
    check((store["flash"] or not flash) and store["gram_norm_fused"],
          f"the model-axis lanes handed the flash kernels or "
          f"gram_norm_fused nothing: {store}")
    torch.cuda.empty_cache()
    return rows


def mx_granite(torch, dist, mesh, spec, rank, rec):
    """The Granite lanes of ``spec``; on model:2 also the kernels at the
    slice shapes and the f32 gradient check."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg
    from repro_torch.models.lm import TransformerLM
    cfg = get_config("granite-moe-1b-a400m").replace(
        attn_impl="flash", n_layers=MX_GR_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab, cfg.hd,
           cfg.n_experts, cfg.topk) == GR_WIDTHS[1:]
          and cfg.moe_impl == "gather" and cfg.dtype == "bfloat16",
          "granite config")
    model = TransformerLM(cfg)
    params, axes = model.init(0, device="cuda")
    batches = mx_lm_batches(torch, cfg, GR_B, GR_T, MX_STEPS)
    L = MX_GR_LAYERS
    if spec == "model:2":
        # ghost with the kernel norms: gram_norm once at each of wq, wk,
        # wv, wo and the router a layer and at the head; the flash
        # kernels in the capture pass and the weighted backward
        lanes = (("auto_stale", "auto", ClipPolicy(mode="stale"),
                  NormCfg(), planned_lm_needs(L, L)),
                 ("ghost", "ghost", ClipPolicy(), NormCfg(dense="pallas"),
                  dict(flash_needs(MX_STEPS, passes=2, layers=L),
                       gram_norm=[5 * L + 1] * MX_STEPS)))
    else:
        lanes = (("auto_flat", "auto", ClipPolicy(), NormCfg(),
                  planned_lm_needs(L, L)),)
    store = {"gram_norm": set(), "gram_norm_fused": set(), "flash": set()}
    for lane, strategy, clip, knobs, needs in lanes:
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy=strategy,
                      norm=knobs, clipping=clip)
        r = mx_lane(torch, dist, mesh, f"granite {lane} on {spec}", model,
                    params, batches, dp, needs, axes, rank, store)
        r["cuts"] = {"n_layers": MX_GR_LAYERS}
        r["local"] = {"query_heads": cfg.n_heads // 2,
                      "experts": cfg.n_experts // 2,
                      "vocab_rows": cfg.padded_vocab // 2}
        rec[f"granite_depth{L}_{lane}"] = r
    b0 = batches[0]
    del params, batches
    torch.cuda.empty_cache()
    if spec == "model:2":
        if rank == 0:
            slices = {(xs, xst, ds, dst, dt, hb) for (xs, xst), (ds, dst),
                      dt, hb in store["gram_norm"]}
            rec["gram_norm_on_slices"] = ma_gram_slices(torch, slices)
            rec["kernels_on_slices"] = mx_slice_kernels(torch, store)
        dist.barrier()
        rec["f32_check"] = ma_f32_check(
            torch, dist, mesh, cfg.replace(dtype="float32"), b0, "cuda")
    del b0
    torch.cuda.empty_cache()


def mx_deepseek(torch, dist, mesh, rank, rec):
    """The DeepSeek-V3 MoE layer on model:2: each run draws the whole
    layer on the card from one seed and keeps this rank's slices (the
    whole tree is dropped before a step), so a rank holds its half of
    the params, the f32 clipped sum and momentum; rank 0 then runs one
    device alone (the others' memory freed) on a fresh draw."""
    from repro_torch.configs.deepseek_v3_671b import CONFIG
    from repro_torch.core import DPConfig, PrivacyEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.models.lm import TransformerLM
    from repro_torch.optim import sgdm_init
    from repro_torch.tree import tree_map
    cfg = CONFIG.replace(n_layers=1, n_experts=MX_DS_EXPERTS, remat=False,
                         fsdp=False, attn_impl="xla")
    check((cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
           cfg.topk, cfg.n_shared_experts, cfg.d_ff, cfg.vocab,
           cfg.capacity_factor, cfg.moe_impl) == (7168, 128, 1536, 512, 8, 1,
                                                  2048, 129280, 2.0, "gather")
          and cfg.mla, "deepseek-v3 moe config")
    model = TransformerLM(cfg)

    def draw():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return model.init(gen, device="cuda")

    batches = mx_lm_batches(torch, cfg, MX_DS_B, MX_DS_T, MX_STEPS)
    dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy="auto")
    st = sharding.COLL_STATS
    runs, dropped, first = [], [], None
    n_params = None
    undo = mx_dropped_spy(dropped)
    try:
        for r in range(2):
            params, axes = draw()
            if n_params is None:
                n_params = param_count(params)
            eng = PrivacyEngine(model.apply, params, batches[0], dp,
                                optimizer="sgdm", donate_opt=True, lr=SH_LR,
                                run_seed=0, sampling_rate=1 / 128,
                                device="cuda", mesh=mesh, param_axes=axes)
            p = eng.shard_params(params)
            del params
            torch.cuda.empty_cache()
            opt = sgdm_init(p)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            st.timing = r == 1
            del dropped[:]
            step_ms, per_step, coll, losses = [], [], [], []
            for s in range(MX_STEPS):
                ops.reset_launches()
                st.reset()
                t = time.perf_counter()
                p, opt, loss, aux = eng.private_step(p, opt, batches[s],
                                                     step=s)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                per_step.append(dict(ops.LAUNCHES))
                coll.append({"calls": dict(st.calls),
                             "mb": {a: v / 2**20 for a, v in st.bytes.items()},
                             "ms": ({a: v * 1e3 for a, v in st.seconds.items()}
                                    if st.timing else "not timed")})
                losses.append(float(loss))
            st.timing = False
            check(all(not any(c.values()) for c in per_step),
                  f"deepseek moe layer: MLA and the planned step launch no "
                  f"kernel, got {per_step}")
            check(all(math.isfinite(v) for v in losses),
                  f"deepseek moe layer: loss {losses}")
            runs.append({"step_ms": step_ms, "collectives_each_step": coll,
                         "launches_each_step": per_step, "losses": losses,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9, **mx_dispatch_reading(dropped),
                         "digest": tree_digest(p)})
            del opt, aux
            torch.cuda.empty_cache()
            if r == 0:
                plan = eng.plan()
                rec_plan = {"realizations": plan.realizations(),
                            "coll_mb_by_axis": {
                                a: v / 2**20 for a, v in
                                plan.total_coll_bytes_by_axis}}
                whole = eng.gather_params(p)
                if rank == 0:
                    first = tree_map(lambda t: t.cpu(), whole)
                del whole
            del p, eng
            torch.cuda.empty_cache()
    finally:
        undo()
        st.timing = False
    r = {"runs": runs, "plan": rec_plan, "params": n_params,
         "runs_bitwise_equal": len({x["digest"] for x in runs}) == 1,
         "cuts": {"n_layers": 1, "n_experts": [256, MX_DS_EXPERTS],
                  "remat": False, "fsdp": False},
         "local": {"heads": cfg.n_heads // 2,
                   "experts": MX_DS_EXPERTS // 2}}
    ma_agree(torch, dist, mesh, r, "deepseek moe layer on model:2")
    dist.barrier()
    if rank == 0:
        params, _ = draw()
        r["vs_single_device"] = shard_reference(torch, model, params,
                                                batches, dp, MX_STEPS, first)
        del params
        torch.cuda.empty_cache()
    del first
    dist.barrier()
    rec["deepseek_moe_layer"] = r
    # the bf16 params above cannot show a wrong gradient (the rounding
    # term of released_param_bound): one f32 gradient of the same layer,
    # routed experts cut to MX_DS_F32_EXPERTS, against one device's
    f32 = cfg.replace(dtype="float32", n_experts=MX_DS_F32_EXPERTS)
    r["f32_check"] = ma_f32_check(
        torch, dist, mesh, f32, batches[0], "cuda",
        key=torch.Generator(device="cuda").manual_seed(0))
    r["f32_check"]["cuts"] = {"n_experts": [256, MX_DS_F32_EXPERTS]}
    del batches
    torch.cuda.empty_cache()


# The attention-only families on a model axis (ROADMAP item 14 part 3,
# second part) run in phase moe_model_axis_path's two worlds, with no
# bootstrap of their own: bf16, flash, remat on (their configs'), SGD with
# momentum, σ = 1, C = 1, each lane twice (``mx_lane``).
#   * SeamlessM4T-large-v2 at full width cut to 1 + 1 of its 12 + 12
#     layers (AX_SM_LAYERS; 2 + 2 before the recurrent families'
#     model-axis lanes needed the room; d_model 1024, 16 heads of 64: 8 a rank, GeLU
#     d_ff 8192: 4096 a rank, vocabulary 256 206 padded to 256 256: 128 128
#     rows a rank), B = 8, 512 source frames and 512 target tokens:
#     ``auto`` flat and bk (the kernel norms) on model:2 beside the 4-rank
#     world, ``auto`` stale on data:2,model:2 after its Granite lane; its
#     f32 gradient on model:2 against one device's (``ma_f32_check``).
#   * Chameleon-34B at full width cut to depth 1 of 48 (AX_CH_LAYERS;
#     2 before the recurrent families' model-axis lanes needed the room;
#     d_model 8192, 64 heads of 128 with qk-norm: 32 a rank, 8 KV heads
#     whole, SwiGLU d_ff 22 016: 11 008 a rank, vocabulary 65 536: 32 768
#     rows a rank, LayerNorm with a bias; about 1.6e9 params drawn on the
#     card), B = 4, T = 512, on model:2 only, ``auto`` stale and bk, after
#     the DeepSeek-V3 layer (it needs the card alone: a rank about 18 GB,
#     one device's run about 27 GB more); data:2,model:2 is left out (it
#     would all-reduce about 5 GB of f32 gradient a rank and step over
#     data, through the host).  Its f32 gradient at depth 1 (bk, the
#     kernel norms, per-layer clipping) against one device's.
# ``gram_norm``, ``gram_norm_fused`` and the flash kernels at the shapes
# these lanes handed them, against their plain versions.
AX_SM_LAYERS = 1
AX_CH_LAYERS = 1
AX_CH_B, AX_CH_T = 4, 512
AX_CH_WIDTHS = (48, 8192, 64, 8, 22016, 65536, 128)


def ax_seamless(torch, dist, mesh, spec, rank, rec, store):
    """The Seamless lanes of ``spec``; on model:2 also its f32 gradient
    check."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg
    from repro_torch.launch.train import make_batch_fn, to_device
    from repro_torch.models.encdec import EncDecLM
    cfg = get_config("seamless-m4t-large-v2").replace(attn_impl="flash")
    check((cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv, cfg.d_ff, cfg.vocab, cfg.hd) == SM_WIDTHS
          and cfg.padded_vocab == 256256 and cfg.remat
          and cfg.dtype == "bfloat16", "seamless config")
    L = AX_SM_LAYERS
    cfg = cfg.replace(n_enc_layers=L, n_dec_layers=L, n_layers=2 * L)
    model = EncDecLM(cfg)
    params, axes = model.init(torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")
    fn = make_batch_fn(cfg, SM_B, 2 * SM_T)
    batches = [to_device(fn(s), "cuda") for s in range(MX_STEPS)]
    # a pass: the flash forward L times full (encoder), L causal
    # (decoder), L full over the source (cross), 2L more under remat (the
    # decoder's recompute); dq and dk/dv 3L
    fwd, bwd = 3 * L + 2 * L, 3 * L
    if spec == "model:2":
        bk = {"flash_fwd": [fwd] * MX_STEPS, "flash_dq": [bwd] * MX_STEPS,
              "flash_dkv": [bwd] * MX_STEPS,
              "gram_norm": [6 * L + 10 * L + 1] * MX_STEPS}
        lanes = (("auto_flat", "auto", ClipPolicy(), NormCfg(),
                  planned_lm_needs(fwd, bwd)),
                 ("bk", "bk", ClipPolicy(), NormCfg(dense="pallas"), bk))
    else:
        lanes = (("auto_stale", "auto", ClipPolicy(mode="stale"), NormCfg(),
                  planned_lm_needs(fwd, bwd)),)
    for lane, strategy, clip, knobs, needs in lanes:
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy=strategy,
                      norm=knobs, clipping=clip)
        r = mx_lane(torch, dist, mesh, f"seamless {lane} on {spec}", model,
                    params, batches, dp, needs, axes, rank, store)
        r["cuts"] = {"n_enc_layers": [SM_LAYERS, L],
                     "n_dec_layers": [SM_LAYERS, L]}
        r["local"] = {"query_heads": cfg.n_heads // 2,
                      "d_ff": cfg.d_ff // 2,
                      "vocab_rows": cfg.padded_vocab // 2}
        rec[f"seamless_{L}x{L}_{lane}"] = r
    b0 = batches[0]
    del params, batches
    torch.cuda.empty_cache()
    if spec == "model:2":
        rec["seamless_f32_check"] = ma_f32_check(
            torch, dist, mesh, cfg.replace(dtype="float32"), b0, "cuda",
            key=torch.Generator(device="cuda").manual_seed(0))
    del b0
    torch.cuda.empty_cache()


def ax_seamless_kernels(torch, store):
    """(data:2,model:2, rank 0) ``gram_norm_fused``, which only Seamless's
    ``auto`` stale lane on that mesh launches, and the flash kernels at
    the shapes that lane handed them (B/2 rows a rank; the head's slice,
    1024 x 128 128, among them), against their plain versions;
    ``gram_norm``'s where the lane launched it."""
    heads = [ds for _, (ds, _), _, _ in store["gram_norm_fused"]
             if ds[-1] == 256256 // 2]
    check(heads, "seamless auto stale on data:2,model:2 handed "
          "gram_norm_fused no head slice: "
          f"{sorted(store['gram_norm_fused'])}")
    out = {"fused_and_flash": mx_slice_kernels(torch, store)}
    if store["gram_norm"]:
        out["gram_norm"] = ma_gram_slices(
            torch, {(xs, xst, ds, dst, dt, hb) for (xs, xst), (ds, dst),
                    dt, hb in store["gram_norm"]})
    return out


def ax_chameleon(torch, dist, mesh, rank, rec, store):
    """The Chameleon lanes on model:2, its f32 gradient check at depth 1,
    and (rank 0) the kernels at the attention lanes' slice shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg
    from repro_torch.models.lm import TransformerLM
    full = get_config("chameleon-34b")
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv, full.d_ff,
           full.vocab, full.hd) == AX_CH_WIDTHS and full.qk_norm
          and full.remat and full.norm == "layernorm"
          and full.dtype == "bfloat16", "chameleon config")
    L = AX_CH_LAYERS
    cfg = full.replace(attn_impl="flash", n_layers=L, fsdp=False)
    model = TransformerLM(cfg)
    params, axes = model.init(torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")
    n_params = param_count(params)
    batches = mx_lm_batches(torch, cfg, AX_CH_B, AX_CH_T, MX_STEPS)
    # remat: the flash forward once more a layer (the recompute); bk's
    # kernel norms once a dense a layer (wq, wk, wv, wo, w_gate, w_up,
    # w_down) and once at the head, on the rank's slices
    lanes = (("auto_stale", "auto", ClipPolicy(mode="stale"), NormCfg(),
              planned_lm_needs(2 * L, L)),
             ("bk", "bk", ClipPolicy(), NormCfg(dense="pallas"),
              dict(flash_needs(MX_STEPS, remat=True, layers=L),
                   gram_norm=[7 * L + 1] * MX_STEPS)))
    for lane, strategy, clip, knobs, needs in lanes:
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, strategy=strategy,
                      norm=knobs, clipping=clip)
        r = mx_lane(torch, dist, mesh, f"chameleon {lane} on model:2",
                    model, params, batches, dp, needs, axes, rank, store)
        r["params"] = n_params
        r["cuts"] = {"n_layers": [full.n_layers, L], "fsdp": False}
        r["local"] = {"query_heads": cfg.n_heads // 2, "kv_heads": cfg.n_kv,
                      "d_ff": cfg.d_ff // 2,
                      "vocab_rows": cfg.padded_vocab // 2}
        rec[f"chameleon_depth{L}_{lane}"] = r
    b0 = batches[0]
    del params, batches
    torch.cuda.empty_cache()
    rec["chameleon_f32_check"] = ma_f32_check(
        torch, dist, mesh, cfg.replace(dtype="float32", n_layers=1), b0,
        "cuda", key=torch.Generator(device="cuda").manual_seed(0))
    rec["chameleon_f32_check"]["cuts"] = {"n_layers": [full.n_layers, 1]}
    del b0
    torch.cuda.empty_cache()
    if rank == 0:
        slices = {(xs, xst, ds, dst, dt, hb) for (xs, xst), (ds, dst),
                  dt, hb in store["gram_norm"]}
        rec["attn_gram_norm_on_slices"] = ma_gram_slices(torch, slices)
        rec["attn_kernels_on_slices"] = mx_slice_kernels(torch, store)
    dist.barrier()


def moe_model_axis_worker(spec, out_dir):
    """One rank of phase moe_model_axis_path (under torch.distributed.run)
    on mesh ``spec``; this rank's record goes to
    ``out_dir/<spec>_rank<r>.json``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # two DeepSeek-V3 ranks fill most of the card: no stranded segments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh_from_spec
    from repro_torch.launch.train import deterministic_step
    check(torch.cuda.is_available(), "a rank sees no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall = {}
    await_gate(out_dir, wall)
    dev = init_distributed("gloo")
    rank = dist.get_rank()
    mesh = make_mesh_from_spec(spec, device_type="cuda")
    rec = {"rank": rank, "mesh": spec, "device": str(dev),
           "model_rank": mesh.get_local_rank(
               tuple(mesh.mesh_dim_names).index("model")), "wall": wall}
    t = time.perf_counter()
    attn_store = {"gram_norm": set(), "gram_norm_fused": set(),
                  "flash": set()}
    with deterministic_step():
        mx_granite(torch, dist, mesh, spec, rank, rec)
        rec["granite_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ax_seamless(torch, dist, mesh, spec, rank, rec, attn_store)
        rec["seamless_s"] = time.perf_counter() - t
        if spec == "data:2,model:2" and rank == 0:
            t = time.perf_counter()
            rec["seamless_kernels_on_slices"] = ax_seamless_kernels(
                torch, attn_store)
            rec["seamless_kernels_s"] = time.perf_counter() - t
        if spec == "model:2":
            # the data:2,model:2 ranks run beside the Granite lanes; the
            # DeepSeek layer needs the card to itself
            t = time.perf_counter()
            if rank == 0:
                flag = pathlib.Path(out_dir) / MX_SIDE_DONE
                while not flag.exists():
                    check(time.perf_counter() - t < MX_TIMEOUT_S,
                          "the data:2,model:2 ranks did not finish")
                    time.sleep(0.5)
            dist.barrier()
            rec["waited_for_data2_model2_s"] = time.perf_counter() - t
            t = time.perf_counter()
            mx_deepseek(torch, dist, mesh, rank, rec)
            rec["deepseek_s"] = time.perf_counter() - t
            t = time.perf_counter()
            ax_chameleon(torch, dist, mesh, rank, rec, attn_store)
            rec["chameleon_s"] = time.perf_counter() - t
    tag = spec.replace(":", "").replace(",", "_")
    with open(os.path.join(out_dir, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def moe_model_axis_worlds():
    """Phase moe_model_axis_path's worlds, started now (``World``)."""
    shutil.rmtree(MX_DIR, ignore_errors=True)
    MX_DIR.mkdir(parents=True)
    return {spec: World([str(ROOT / "chip_smoke.py"),
                         "--moe-model-axis-worker", spec, str(MX_DIR)], n,
                        MX_TIMEOUT_S, MX_DIR)
            for spec, n in MX_MESHES.items()}


def moe_model_axis_path(torch, launches, lanes, worlds):
    """Phase moe_model_axis_path (module comment above): the
    data:2,model:2 ranks and the model:2 ranks at once (``worlds``:
    started ahead, released now), the model:2 ranks' DeepSeek-V3 layer
    after the others have exited (so the Granite lanes' times are read
    under the other group's load)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    torch.cuda.empty_cache()

    def run(spec):
        try:
            return worlds[spec].result()
        finally:
            if spec == "data:2,model:2":
                (MX_DIR / MX_SIDE_DONE).touch()

    walls, waited = {}, {}
    with ThreadPoolExecutor(len(MX_MESHES)) as pool:
        futs = {spec: pool.submit(run, spec) for spec in MX_MESHES}
        results = {spec: f.result() for spec, f in futs.items()}
    for spec, n in MX_MESHES.items():
        rc, out, err, walls[spec], waited[spec] = results[spec]
        # the failing rank's own message, which the others' tracebacks
        # (a peer closed) would push out of the tail
        why = [ln for ln in err.splitlines()
               if "chip_smoke: FAILED" in ln or ln.startswith(
                   tuple(f"[rank{r}]: {e}" for r in range(n)
                         for e in ("RuntimeError", "ValueError",
                                   "TypeError", "KeyError",
                                   "AttributeError", "torch.OutOfMemory",
                                   "NotImplementedError", "AssertionError",
                                   "IndexError", "NameError")))]
        check(rc == 0, f"moe model-axis ranks ({spec}): exit {rc}\n"
              f"{why[:12]}\n{out[-3000:]}\n{err[-5000:]}")
    ranks = {spec: [json.loads((MX_DIR / "{}_rank{}.json".format(
        spec.replace(":", "").replace(",", "_"), r)).read_text())
        for r in range(n)] for spec, n in MX_MESHES.items()}
    check("seamless_kernels_on_slices" in ranks["data:2,model:2"][0]
          and "attn_kernels_on_slices" in ranks["model:2"][0],
          "the attention families' kernels were not held at their slices")
    for spec, rs in ranks.items():
        tag = spec.replace(":", "").replace(",", "_")
        for r in rs:
            for lane, rec in r.items():
                if not (isinstance(rec, dict) and "runs" in rec):
                    continue
                steps = rec["runs"][0]["launches_each_step"]
                name = f"moe_model_axis_{tag}_{lane}_rank{r['rank']}"
                lanes[name] = {k: [c.get(k, 0) for c in steps]
                               for k in launches
                               if any(c.get(k, 0) for c in steps)}
                if r["rank"] == 0:
                    for k, v in lanes[name].items():
                        launches[k] += sum(v)
                print(json.dumps({
                    "moe_model_axis_lane": name,
                    "model_rank": r["model_rank"],
                    "digests": [x["digest"] for x in rec["runs"]],
                    "step_ms": [x["step_ms"] for x in rec["runs"]],
                    "peak_mem_gb": [x["peak_mem_gb"] for x in rec["runs"]],
                    "collectives": rec["runs"][1]["collectives_each_step"],
                    "launches": lanes[name],
                    "entries_dropped": rec.get(
                        "entries_dropped_each_call",
                        rec["runs"][0].get("entries_dropped_each_call")),
                    "slot_rows_filled": rec.get(
                        "slot_rows_filled_each_call",
                        rec["runs"][0].get("slot_rows_filled_each_call")),
                    "vs_single_device": rec.get("vs_single_device")}),
                    flush=True)
    log({"phase": "moe_model_axis_path", "backend": "gloo",
         "ranks_wall_s": walls, "worlds_ready_ahead_s": waited,
         "ranks": ranks,
         "seconds": time.perf_counter() - t0, "ok": True})
    shutil.rmtree(MX_DIR, ignore_errors=True)


# Phase recurrent_model_axis_path: the recurrent families on a model axis
# (ROADMAP item 14 part 3, third part), each recurrence on the rank's
# heads, gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card),
# a model:2 world and a data:2,model:2 world at once (the script
# re-entering itself with --recurrent-model-axis-worker):
#   * xLSTM-125M at full width (d_model 768, 4 heads, vocab 50 304,
#     bf16) cut to XL_DEPTH layers (one super-block: 3 mLSTM, 1 sLSTM),
#     B = XL_B and T = RX_XL_T, not XL_T (a cut of the traffic, for the
#     script's time): bk (``gram_norm`` on every sliced dense) and
#     ``auto`` stale on model:2, ``auto`` flat on data:2,model:2;
#   * Zamba2-2.7B at full width (80 SSD heads of 64, 32 attention heads
#     of 80, d_ff 10 240, bf16, remat) cut to ZB_LAYERS (one super-block:
#     6 Mamba2 layers, the shared block once), B = ZB_B and T = RX_ZB_T,
#     not ZB_T (a cut of the traffic, for the phase's time): bk on
#     model:2, ``auto`` flat on data:2,model:2.
# The data:2,model:2 world then waits for the model:2 world to exit
# (RX_M2_DONE, written by the parent) before phase fsdp_path's GLM-4-9B
# lanes, which need most of the card.
# Held: the ranks of a model slot and the two runs bitwise equal, the
# released params within ``released_param_bound`` of one device's run;
# a bk step's model-group all-reduces as ``rx_bk_calls`` reckons them
# from the layers, the same at T = RX_CENSUS_T (no collective in a
# scan's time loop); an f32 gradient of each model against one device's
# (``ma_f32_check`` at σ = 0, each leaf also within RX_GRAD_RTOL of its
# largest coordinate), on data:2,model:2, whose lanes end first;
# ``gram_norm`` and ``gram_norm_fused`` at the slice shapes the model:2
# lanes handed them.
RX_DIR = ROOT / "build" / "chip_smoke_recurrent_model_axis"
RX_TIMEOUT_S = 420
RX_MESHES = {"data:2,model:2": 4, "model:2": 2}
RX_XL_T, RX_ZB_T = 64, 64
RX_CENSUS_T = 16
RX_M2_DONE = "model2.done"
# The recurrences carry the forward's rounding (a row-sharded product's
# partial sums added in another order) through T steps into the
# per-example gradients themselves, which the sum bound of
# ``released_mean_bound`` does not cover (the CPU's reduced lanes: up to
# 1.5e-5 of a leaf's largest entry at T = 8): each f32 leaf is held
# within this share of its largest coordinate, the share its norms are
# held to (MA_NORM_RTOL).  A partial cotangent or an unsummed partial
# gradient misses by tens of percent.
RX_GRAD_RTOL = MA_NORM_RTOL


def rx_bk_calls(cfg):
    """The model group's all-reduces in one bk step of ``cfg`` on a model
    axis, reckoned from its layers; T appears nowhere (every collective
    sits outside the scans).  An mLSTM layer 14: forward ``up``'s gather,
    the four reduce-scatters (``wq``, ``wk``, ``wv``, ``wif``), the
    norm's sum of squares, ``down``'s sum; backward ``x``'s copy, ``up``'s
    gather, the four reduce-scatters' gathers, the norm's sum.  An sLSTM
    layer 8: forward ``wx``'s and ``h``'s gathers and the FFN's sum;
    backward ``x``'s copy, ``wx``'s gather and the FFN's copy; the kind's
    two sums of the gate bias's per-example gradient (norm, contribution).
    A Mamba2 layer 10: forward ``in_proj``'s and the conv's gathers, the
    norm's sum of squares, ``out_proj``'s sum; backward ``x``'s copy, the
    two gathers, the norm's sum; the two sums of the ``ssd`` per-example
    gradient.  The shared block 6 an application: forward ``wo``'s and
    ``w_down``'s sums; backward the copies into ``wq``, of ``k`` and ``v``,
    into the MLP; under remat its recompute re-issues a super-block's
    forward moves but the last (``w_down``'s sum feeds the residual
    alone).  Once a step: the embedding's sum, the head's copy, the
    cross entropy's three sums, the norms' one sum."""
    if cfg.family == "ssm":
        n_s = cfg.n_layers // cfg.slstm_every
        return 14 * (cfg.n_layers - n_s) + 8 * n_s + 6
    n_app = cfg.n_layers // cfg.attn_every
    return (10 * cfg.n_layers + 6 * n_app + 6
            + cfg.remat * (4 * cfg.attn_every + 1) * n_app)


def rx_census(torch, model, params, axes, mesh, dp, B):
    """One bk step at T = RX_CENSUS_T from this rank's slices: the model
    group's calls (``COLL_STATS``)."""
    from repro_torch.core import PrivacyEngine
    from repro_torch.launch import sharding
    from repro_torch.optim import sgdm_init
    (b,) = mx_lm_batches(torch, model.cfg, B, RX_CENSUS_T, 1)
    eng = PrivacyEngine(model.apply, params, b, dp, optimizer="sgdm",
                        lr=SH_LR, run_seed=0, sampling_rate=1 / 128,
                        device="cuda", mesh=mesh, param_axes=axes)
    p = eng.shard_params(params)
    sharding.COLL_STATS.reset()
    eng.private_step(p, sgdm_init(p), b, step=0)
    torch.cuda.synchronize()
    calls = sharding.COLL_STATS.calls["model"]
    del eng, p
    torch.cuda.empty_cache()
    return calls


def rx_config(torch, arch):
    """(full config, the lanes' config) of ``arch``, its widths checked."""
    from repro_torch.configs import get_config
    if arch == "zamba2-2.7b":
        return get_config(arch), zamba2_config(torch, ZB_LAYERS)
    full = get_config(arch)
    check((full.n_layers, full.d_model, full.n_heads, full.vocab,
           full.slstm_every) == XL_WIDTHS and full.family == "ssm"
          and full.dtype == "bfloat16", "xlstm config")
    return full, full.replace(n_layers=XL_DEPTH)


def rx_shape(arch):
    return (XL_B, RX_XL_T) if arch == "xlstm-125m" else (ZB_B, RX_ZB_T)


def rx_lanes(torch, dist, mesh, spec, rank, rec, store):
    """The lanes of ``spec`` (module comment above), each through
    ``mx_lane``; on model:2 each bk lane's census."""
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg
    from repro_torch.models.lm import TransformerLM
    bk = ("bk", "bk", ClipPolicy(), NormCfg(dense="pallas"))
    stale = ("auto_stale", "auto", ClipPolicy(mode="stale"), NormCfg())
    flat = ("auto_flat", "auto", ClipPolicy(), NormCfg())
    todo = {"model:2": {"xlstm-125m": (bk, stale), "zamba2-2.7b": (bk,)},
            "data:2,model:2": {"xlstm-125m": (flat,),
                               "zamba2-2.7b": (flat,)}}[spec]
    for arch, lanes in todo.items():
        t = time.perf_counter()
        full, cfg = rx_config(torch, arch)
        model = TransformerLM(cfg)
        params, axes = model.init(
            torch.Generator(device="cuda").manual_seed(0), device="cuda")
        B, T = rx_shape(arch)
        batches = mx_lm_batches(torch, cfg, B, T, MX_STEPS)
        short = arch.split("-")[0]
        for lane, strategy, clip, knobs in lanes:
            dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0,
                          strategy=strategy, norm=knobs, clipping=clip)
            gram = XL_GRAM if arch == "xlstm-125m" else ZB_GRAM
            needs = ({"gram_norm": [gram] * MX_STEPS,
                      "gram_norm_fused": [0] * MX_STEPS}
                     if strategy == "bk" else planned_lm_needs(0, 0))
            r = mx_lane(torch, dist, mesh, f"{short} {lane} on {spec}",
                        model, params, batches, dp, needs, axes, rank,
                        store, moe=False)
            r["params"] = param_count(params)
            r["cuts"] = {"n_layers": [full.n_layers, cfg.n_layers],
                         "seq": [XL_T, RX_XL_T] if arch == "xlstm-125m"
                         else [ZB_T, RX_ZB_T]}
            if strategy == "bk":
                want = rx_bk_calls(cfg)
                got = [c["calls"]["model"] for run in r["runs"]
                       for c in run["collectives_each_step"]]
                short_t = rx_census(torch, model, params, axes, mesh, dp, B)
                r["model_calls"] = {"reckoned": want, f"T={T}": got,
                                    f"T={RX_CENSUS_T}": short_t}
                check(set(got) == {want} and short_t == want,
                      f"{short} bk on {spec}: the model group's calls a "
                      f"step {got} (T = {T}) and {short_t} (T = "
                      f"{RX_CENSUS_T}), reckoned {want}")
            rec[f"{short}_{lane}"] = r
        del params, batches
        torch.cuda.empty_cache()
        rec[f"{short}_s"] = time.perf_counter() - t


def rx_f32_checks(torch, dist, mesh, rec):
    """An f32 gradient of each model against one device's (Zamba2's,
    the smaller, first: the model:2 ranks may still run xLSTM's lanes)."""
    for arch in ("zamba2-2.7b", "xlstm-125m"):
        t = time.perf_counter()
        _, cfg = rx_config(torch, arch)
        (b,) = mx_lm_batches(torch, cfg, *rx_shape(arch), 1)
        short = arch.split("-")[0]
        rec[f"{short}_f32_check"] = ma_f32_check(
            torch, dist, mesh, cfg.replace(dtype="float32"), b, "cuda",
            key=torch.Generator(device="cuda").manual_seed(0), sigma=0.0,
            grad_rtol=RX_GRAD_RTOL)
        rec[f"{short}_f32_check_s"] = time.perf_counter() - t
        del b
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase fsdp_path: FSDP on a live mesh (ROADMAP item 14 part 3, fourth
# part; ``PrivacyEngine(fsdp=True)``: params and moments sliced over the
# data axes too, gathered at the step's start, each clipped sum summed over
# data keeping the rank's slice).  Its lanes run in worlds the smoke starts
# anyway: GLM-4-9B's in the recurrent phase's data:2,model:2 world after
# that world's own lanes and the model:2 world's exit, the Llama f32
# gradient in sharded_main_path's data:2 world; the parent logs them as a
# phase of their own.
#   * GLM-4-9B at full width (d_model 4096, 32 heads of 128, 2 KV heads,
#     d_ff 13 696, vocab 151 552, untied; bf16, flash, remat as
#     configured) cut to FS_GLM_LAYERS of its 40 layers, B = FS_B,
#     T = FS_T, σ = 1, C = 1, SGD with momentum, on data:2,model:2 with
#     fsdp=True: ``auto`` stale (the flat bootstrap, then a stale step)
#     run twice; bk with the kernels' norms once with FSDP and once
#     without it.
#   * Llama-3.2-1B at full width cut to FS_LLAMA_LAYERS, f32, bk with the
#     kernels' norms, per-layer clipping, σ = 0, on data:2 with fsdp=True,
#     against one device (``ma_f32_check``).
# Held: each rank's persistent params at most FS_PERSIST_MAX of the lane
# without FSDP; the two stale runs bitwise equal; bk under FSDP bitwise
# equal to bk without it (the gathered params); every rank's gathered
# params equal; the data group's gather and gradient bytes a step within
# FS_BYTES_RTOL of the reckoning from the specs (``fs_reckoning``); each
# rank launches what the plan says; ``gram_norm``, ``gram_norm_fused``
# and the flash kernels at the shapes the GLM lanes handed them, against
# their plain versions.
FS_GLM_LAYERS = 1
FS_GLM_WIDTHS = (40, 4096, 32, 2, 13696, 151552, 128)
FS_B, FS_T = 4, 512
FS_STEPS = 2
FS_LLAMA_LAYERS = 1
FS_PERSIST_MAX = 0.55
FS_BYTES_RTOL = 0.10
FSDP_RECORDS = {}


def fs_reckoning(eng, whole):
    """The data group's MB a step under FSDP, reckoned from the specs:
    each data-sliced leaf's model slice gathered in its dtype, and every
    leaf's model slice of the clipped sum summed in f32, each a sum
    all-reduce of the whole model slice."""
    from repro_torch.core import costmodel
    from repro_torch.launch import sharding
    from repro_torch.tree import get_subtree, leaf_paths
    specs = eng.param_specs
    m = costmodel.mesh_model_size(eng.mesh_axes)
    gather = grad = 0
    for q in leaf_paths(specs):
        t, spec = get_subtree(whole, q), get_subtree(specs, q)
        n = math.prod(sharding.local_shape(tuple(t.shape), spec, m))
        grad += n * 4
        if sharding.data_dims(spec):
            gather += n * t.element_size()
    return {"gather_mb": gather / 2**20, "grad_mb": grad / 2**20}


def fs_glm(torch, dist, mesh, rank):
    """Phase fsdp_path's GLM-4-9B lanes on this data:2,model:2 rank (the
    comment above); this rank's record."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClipPolicy, DPConfig, NormCfg, PrivacyEngine
    from repro_torch.core.clipping import DataShard
    from repro_torch.launch import sharding
    from repro_torch.models.lm import TransformerLM
    from repro_torch.tree import get_subtree, leaf_paths, tree_map
    full = get_config("glm4-9b")
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv, full.d_ff,
           full.vocab, full.hd) == FS_GLM_WIDTHS and full.fsdp
          and full.remat and full.dtype == "bfloat16", "glm4-9b config")
    L = FS_GLM_LAYERS
    cfg = full.replace(attn_impl="flash", n_layers=L)
    model = TransformerLM(cfg)
    params, axes = model.init(torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")
    # the whole params wait on the host (shard_lane moves each rank's
    # slices to the card): 2.9 GB less a rank
    params = tree_map(lambda t: t.cpu(), params)
    batches = mx_lm_batches(torch, cfg, FS_B, FS_T, FS_STEPS)
    bk_needs = dict(flash_needs(FS_STEPS, remat=True, layers=L),
                    gram_norm=[7 * L + 1] * FS_STEPS)
    lanes = (("bk_replicated", "bk", ClipPolicy(), NormCfg(dense="pallas"),
              bk_needs, False, 1),
             ("bk", "bk", ClipPolicy(), NormCfg(dense="pallas"), bk_needs,
              True, 1),
             ("auto_stale", "auto", ClipPolicy(mode="stale"), NormCfg(),
              planned_lm_needs(2 * L, L), True, 2))
    rec = {"params": param_count(params),
           "cuts": {"n_layers": [full.n_layers, L]}, "B": FS_B, "T": FS_T}
    eng = PrivacyEngine(model.apply, params, batches[0], mesh=mesh,
                        param_axes=axes, fsdp=True, device="cuda")
    rec["reckoned"] = fs_reckoning(eng, params)
    data = DataShard(mesh.get_group("data"), mesh.get_local_rank("data"),
                     2, eng.param_specs)
    store = {"gram_norm": set(), "gram_norm_fused": set(), "flash": set()}
    undo = mx_spies(store)
    local = {}
    try:
        for lane, strategy, clip, knobs, needs, fsdp, runs in lanes:
            dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0,
                          strategy=strategy, norm=knobs, clipping=clip)
            t = time.perf_counter()
            r, p = shard_lane(torch, model, params, batches, dp, FS_STEPS,
                              mesh, needs, "sgdm", SH_LR, runs=runs,
                              axes=axes, fsdp=fsdp, donate_opt=True,
                              whole=False)
            r["seconds"] = time.perf_counter() - t
            local[lane] = tree_map(lambda x: x.cpu(), p)
            del p
            check(r["runs_bitwise_equal"], f"glm fsdp {lane}: two runs "
                  f"differ")
            torch.cuda.empty_cache()
            rec[lane] = r
    finally:
        undo()
    del eng, params, batches
    # bk under FSDP against bk without it: each rank's data slices of its
    # model slice, bitwise
    want = sharding.shard_params(local["bk_replicated"], data.specs, None,
                                 data=data)
    same = all(torch.equal(get_subtree(local["bk"], q), get_subtree(want, q))
               for q in leaf_paths(want))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, same)
    rec["bk_equals_bk_replicated_on_every_rank"] = all(got)
    check(all(got), f"glm: bk under FSDP differs from bk without it "
          f"(ranks {got})")
    del local, want
    torch.cuda.empty_cache()
    bk, rep = rec["bk"], rec["bk_replicated"]
    mine, theirs = (bk["runs"][0]["persistent_gb"],
                    rep["runs"][0]["persistent_gb"])
    rec["persistent_ratio"] = {k: mine[k] / theirs[k] for k in mine}
    check(rec["persistent_ratio"]["params"] <= FS_PERSIST_MAX,
          f"glm: a rank's persistent params {mine} against {theirs} "
          f"without FSDP")
    rec["data_mb_a_step"] = []
    for lane in ("bk", "auto_stale"):
        for c in rec[lane]["runs"][-1]["collectives_each_step"]:
            g = c["fsdp_gather"]["mb"]
            rec["data_mb_a_step"].append(
                {"lane": lane, "gather_mb": g,
                 "grad_and_stats_mb": c["mb"]["data"] - g,
                 "gather_ms": c["fsdp_gather"]["ms"],
                 "data_ms": c["ms"] if c["ms"] == "not timed"
                 else c["ms"]["data"]})
            for k, want in (("gather_mb", rec["reckoned"]["gather_mb"]),
                            ("grad_and_stats_mb",
                             rec["reckoned"]["grad_mb"])):
                got = rec["data_mb_a_step"][-1][k]
                check(abs(got - want) <= FS_BYTES_RTOL * want,
                      f"glm {lane}: {k} {got:.1f} against the reckoned "
                      f"{want:.1f}")
    if rank == 0:
        slices = {(xs, xst, ds, dst, dt, hb) for (xs, xst), (ds, dst),
                  dt, hb in store["gram_norm"]}
        rec["gram_norm_on_slices"] = ma_gram_slices(torch, slices)
        rec["kernels_on_slices"] = mx_slice_kernels(torch, store)
    dist.barrier()
    return rec


def fsdp_path(torch, launches, lanes):
    """Phase fsdp_path (its comment above): what the GLM-4-9B lanes and
    the Llama f32 check recorded in their worlds, each rank's launches
    against the plan (held in the worlds), logged as a phase."""
    glm, llama = FSDP_RECORDS.get("glm"), FSDP_RECORDS.get("llama_f32")
    check(glm and llama, "phase fsdp_path: a world recorded no FSDP lane")
    check(glm[0].get("gram_norm_on_slices")
          and glm[0].get("kernels_on_slices"), "phase fsdp_path: the "
          "kernels were not held at the GLM slices")
    for r, rec in enumerate(glm):
        for lane in ("auto_stale", "bk", "bk_replicated"):
            steps = rec[lane]["runs"][0]["launches_each_step"]
            name = f"fsdp_glm_{lane}_rank{r}"
            lanes[name] = {k: [c.get(k, 0) for c in steps] for k in launches
                           if any(c.get(k, 0) for c in steps)}
            if r == 0:
                for k, v in lanes[name].items():
                    launches[k] += sum(v)
    summary = {
        lane: {"step_ms": [x["step_ms"] for x in glm[0][lane]["runs"]],
               "peak_mem_gb": [[x["peak_mem_gb"] for x in rec[lane]["runs"]]
                               for rec in glm],
               "persistent_gb": [rec[lane]["runs"][0]["persistent_gb"]
                                 for rec in glm],
               "launches": lanes[f"fsdp_glm_{lane}_rank0"],
               "seconds": glm[0][lane]["seconds"]}
        for lane in ("auto_stale", "bk", "bk_replicated")}
    log({"phase": "fsdp_path", "glm_mesh": "data:2,model:2",
         "glm_params": glm[0]["params"], "glm_cuts": glm[0]["cuts"],
         "glm": summary,
         "persistent_ratio": [rec["persistent_ratio"] for rec in glm],
         "data_mb_a_step": glm[0]["data_mb_a_step"],
         "reckoned": glm[0]["reckoned"],
         "glm_ranks": glm, "llama_f32_fsdp_check": llama,
         "seconds": {"glm_lanes": max(rec["seconds"] for rec in glm),
                     "llama_f32_check": llama["seconds"]}, "ok": True})


def recurrent_model_axis_worker(spec, out_dir):
    """One rank of phase recurrent_model_axis_path (under
    torch.distributed.run) on mesh ``spec``; this rank's record, with the
    wall-clock times it entered, had its mesh and was done, goes to
    ``out_dir/<spec>_rank<r>.json``."""
    wall = {"entered": time.time()}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh_from_spec
    from repro_torch.launch.train import deterministic_step
    check(torch.cuda.is_available(), "a rank sees no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    await_gate(out_dir, wall)
    dev = init_distributed("gloo")
    rank = dist.get_rank()
    mesh = make_mesh_from_spec(spec, device_type="cuda")
    rec = {"rank": rank, "mesh": spec, "device": str(dev),
           "model_rank": mesh.get_local_rank(
               tuple(mesh.mesh_dim_names).index("model")), "wall": wall}
    store = {"gram_norm": set(), "gram_norm_fused": set(), "flash": set()}
    with deterministic_step():
        rx_lanes(torch, dist, mesh, spec, rank, rec, store)
        if spec == "model:2":
            if rank == 0:
                slices = {(xs, xst, ds, dst, dt, hb) for (xs, xst),
                          (ds, dst), dt, hb in store["gram_norm"]}
                rec["gram_norm_on_slices"] = ma_gram_slices(torch, slices)
                rec["gram_norm_fused_on_slices"] = mx_slice_kernels(
                    torch, store, flash=False)
        else:
            rx_f32_checks(torch, dist, mesh, rec)
            # GLM-4-9B's lanes need most of the card: after the model:2
            # world has exited
            t = time.perf_counter()
            if rank == 0:
                flag = pathlib.Path(out_dir) / RX_M2_DONE
                while not flag.exists():
                    check(time.perf_counter() - t < RX_TIMEOUT_S,
                          "the model:2 ranks did not finish")
                    time.sleep(0.5)
            dist.barrier()
            rec["waited_for_model2_s"] = time.perf_counter() - t
            t = time.perf_counter()
            rec["fsdp"] = fs_glm(torch, dist, mesh, rank)
            rec["fsdp"]["seconds"] = time.perf_counter() - t
        dist.barrier()
    wall["done"] = time.time()
    tag = spec.replace(":", "").replace(",", "_")
    with open(os.path.join(out_dir, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def recurrent_model_axis_worlds():
    """Phase recurrent_model_axis_path's worlds, started now (``World``)."""
    shutil.rmtree(RX_DIR, ignore_errors=True)
    RX_DIR.mkdir(parents=True)
    return {spec: World([str(ROOT / "chip_smoke.py"),
                         "--recurrent-model-axis-worker", spec, str(RX_DIR)],
                        n, RX_TIMEOUT_S, RX_DIR)
            for spec, n in RX_MESHES.items()}


def recurrent_model_axis_path(torch, launches, lanes, worlds):
    """Phase recurrent_model_axis_path (module comment above): the
    data:2,model:2 ranks and the model:2 ranks at once (``worlds``:
    started ahead, released now); each world's start-up, lanes and exit read off its ranks'
    wall-clock times (from this phase's start).  The data:2,model:2
    ranks' FSDP lanes go to ``FSDP_RECORDS`` for phase fsdp_path."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    wall0 = time.time()
    walls, waited = {}, {}

    def run(spec):
        try:
            return worlds[spec].result()
        finally:
            if spec == "model:2":
                (RX_DIR / RX_M2_DONE).touch()

    with ThreadPoolExecutor(len(RX_MESHES)) as pool:
        futs = {spec: pool.submit(run, spec) for spec in worlds}
        results = {spec: f.result() for spec, f in futs.items()}
    for spec, n in RX_MESHES.items():
        rc, out, err, walls[spec], waited[spec] = results[spec]
        why = [ln for ln in err.splitlines()
               if "chip_smoke: FAILED" in ln or ln.startswith(
                   tuple(f"[rank{r}]: {e}" for r in range(n)
                         for e in ("RuntimeError", "ValueError",
                                   "TypeError", "KeyError",
                                   "AttributeError", "torch.OutOfMemory",
                                   "NotImplementedError", "AssertionError",
                                   "IndexError", "NameError")))]
        check(rc == 0, f"recurrent model-axis ranks ({spec}): exit {rc}\n"
              f"{why[:12]}\n{out[-3000:]}\n{err[-5000:]}")
    ranks = {spec: [json.loads((RX_DIR / "{}_rank{}.json".format(
        spec.replace(":", "").replace(",", "_"), r)).read_text())
        for r in range(n)] for spec, n in RX_MESHES.items()}
    FSDP_RECORDS["glm"] = [r.pop("fsdp") for r in ranks["data:2,model:2"]]
    r0 = ranks["model:2"][0]
    check(r0.get("gram_norm_on_slices") and r0.get(
        "gram_norm_fused_on_slices"), "the recurrent lanes' kernels were "
          "not held at their slices")
    check(all(f"{a}_f32_check" in ranks["data:2,model:2"][0]
              for a in ("xlstm", "zamba2")), "an f32 check is missing")
    timeline = {spec: {k: max(r["wall"][k] for r in rs) - wall0
                       for k in ("entered", "ready", "released", "done")}
                for spec, rs in ranks.items()}
    for spec, rs in ranks.items():
        tag = spec.replace(":", "").replace(",", "_")
        for r in rs:
            for lane, rec in r.items():
                if not (isinstance(rec, dict) and "runs" in rec):
                    continue
                steps = rec["runs"][0]["launches_each_step"]
                name = f"recurrent_model_axis_{tag}_{lane}_rank{r['rank']}"
                lanes[name] = {k: [c.get(k, 0) for c in steps]
                               for k in launches
                               if any(c.get(k, 0) for c in steps)}
                if r["rank"] == 0:
                    for k, v in lanes[name].items():
                        launches[k] += sum(v)
                print(json.dumps({
                    "recurrent_model_axis_lane": name,
                    "model_rank": r["model_rank"],
                    "digests": [x["digest"] for x in rec["runs"]],
                    "step_ms": [x["step_ms"] for x in rec["runs"]],
                    "peak_mem_gb": [x["peak_mem_gb"] for x in rec["runs"]],
                    "collectives": rec["runs"][1]["collectives_each_step"],
                    "launches": lanes[name],
                    "model_calls": rec.get("model_calls"),
                    "vs_single_device": rec.get("vs_single_device")}),
                    flush=True)
    log({"phase": "recurrent_model_axis_path", "backend": "gloo",
         "ranks_wall_s": walls, "worlds_ready_ahead_s": waited,
         "timeline_s": timeline, "ranks": ranks,
         "seconds": time.perf_counter() - t0, "ok": True})
    shutil.rmtree(RX_DIR, ignore_errors=True)


def profile_step(torch, fn, top=8, named=()):
    """One step under ``torch.profiler``: wall ms, summed CUDA kernel ms,
    the device's busy share (kernel ms / wall ms, one stream), the
    kernels that took the most device time and, for each string in
    ``named``, the device time and launches of the kernels whose names
    hold it.  It traces the device alone (no host op events: a step of
    10^5 small launches records half a million of them), and sums the
    device events straight from the trace (``key_averages`` takes tens
    of seconds over such a step)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            ms, n = by_name.get(ev.name(), (0.0, 0))
            by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, n + 1)
    kernels = [(k, ms, n) for k, (ms, n) in by_name.items()]
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
        side = [r for r in mine if r.get("lane")]
        if side:
            # One step's calls of the kernel on an LM lane beside the
            # main path's (gram_norm_fused: a stale Llama step).
            entry[side[0]["lane"]] = {
                "ms": per_step("kernel_ms", side),
                "bound_ms": per_step("bound_ms", side),
                "plain_ms": per_step("plain_ms", side),
                "library_ms": per_step("library_ms", side),
                "calls": sum(r["calls_per_step"] for r in side),
                "cases": [r["case"] for r in side]}
        if name in FLASH_NAMES:
            olmo = next(r for r in mine if r["case"] == "olmo_bf16")
            entry["olmo_hd128_per_call"] = {
                k: olmo[k] for k in ("design", "kernel_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")}
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


def mesh_phases(torch, launches, lanes, sharded):
    """The mesh phases in order.  Each phase's worlds start (``World``)
    while the phase before runs and are released when it ends; the first
    phase's, ``sharded``, the caller started."""
    phases = ((sharded_main_path, model_axis_worlds),
              (model_axis_path, moe_model_axis_worlds),
              (moe_model_axis_path, recurrent_model_axis_worlds),
              (recurrent_model_axis_path, None))
    worlds = sharded
    for phase, next_worlds in phases:
        t = time.perf_counter()
        ahead = next_worlds() if next_worlds else None
        phase(torch, launches, lanes, worlds)
        log({"phase": f"{phase.__name__}_done",
             "seconds": time.perf_counter() - t})
        worlds = ahead
    fsdp_path(torch, launches, lanes)


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

    from repro_torch.kernels import ops
    t = time.perf_counter()
    rows = kernel_cases(torch)
    log({"phase": "kernels_done", "seconds": time.perf_counter() - t})
    calib = calibrate_phase(torch)
    t = time.perf_counter()
    small_parity(torch)
    small_lm_parity(torch)
    dp_attn_parity(torch)
    log({"phase": "small_parity_done", "seconds": time.perf_counter() - t})
    lanes, timings = {}, {}
    launches = {k: 0 for k in ops.LAUNCHES}
    t = time.perf_counter()
    main_path(torch, lanes, launches, timings)
    log({"phase": "main_path_done", "seconds": time.perf_counter() - t})
    vgg16_main_path(torch, lanes, launches, timings)
    toy_cnns(torch, lanes, launches)
    profiled = {}
    t = time.perf_counter()
    llama = lm_inputs(torch, "llama3.2-1b",
                      (LM_LAYERS, 2048, 32, 8, 8192, 128256, 64))
    lm_main_path(torch, launches, lanes, profiled, llama, "lm_main_path",
                 "llama")
    log({"phase": "lm_main_path_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    lm_clip_modes(torch, launches, lanes, profiled, llama)
    log({"phase": "lm_clip_modes_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    lm_remat(torch, launches, lanes, llama)
    log({"phase": "lm_remat_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    lm_dp_attn(torch, launches, lanes, profiled, llama)
    log({"phase": "lm_dp_attn_done", "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    dp_verify(torch, launches, lanes, llama)
    log({"phase": "dp_verify_done", "seconds": time.perf_counter() - t})
    del llama
    torch.cuda.empty_cache()
    t = time.perf_counter()
    olmo = lm_inputs(torch, "olmo-1b",
                     (LM_LAYERS, 2048, 16, 16, 8192, 50304, 128))
    lm_main_path(torch, launches, lanes, profiled, olmo, "olmo_main_path",
                 "olmo")
    del olmo
    torch.cuda.empty_cache()
    log({"phase": "olmo_main_path_done", "seconds": time.perf_counter() - t})
    deepseek_layer0(torch, launches, lanes)
    run_moe_encdec(torch, launches, lanes)
    run_recurrent(torch, launches, lanes)
    tokmask_path(torch, launches, lanes)
    t = time.perf_counter()
    conv1d_lane(torch, launches, lanes)
    log({"phase": "conv1d_lane_done", "seconds": time.perf_counter() - t})
    torch.cuda.empty_cache()
    calibrated_plans(torch, calib, timings)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    # the first mesh phase's ranks start up beside the CLI lanes
    ahead = sharded_worlds()
    cli_lanes_beside_serving(torch, calib)
    log({"phase": "cli_and_serving_done",
         "seconds": time.perf_counter() - t})
    mesh_phases(torch, launches, lanes, ahead)

    log(nvidia_smi_line())
    log({"kernels": summarize(rows, launches, lanes, profiled)})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--shard-worker"]:
            shard_worker(sys.argv[2])
        elif sys.argv[1:2] == ["--model-axis-worker"]:
            model_axis_worker(sys.argv[2], sys.argv[3])
        elif sys.argv[1:2] == ["--moe-model-axis-worker"]:
            moe_model_axis_worker(sys.argv[2], sys.argv[3])
        elif sys.argv[1:2] == ["--recurrent-model-axis-worker"]:
            recurrent_model_axis_worker(sys.argv[2], sys.argv[3])
        elif sys.argv[1:2] == ["--nccl-probe"]:
            nccl_probe(sys.argv[2])
        else:
            main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    finally:
        stop_worlds()
