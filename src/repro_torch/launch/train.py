"""End-to-end DP training CLI with checkpoint/restart fault tolerance
(the JAX package's ``repro.launch.train``).

The loop is plan -> step -> account: one ``PrivacyEngine`` owns the
ExecPlan, the private step and the accountant; checkpointing, the
straggler monitor and chaos-monkey fault injection wrap around it.

Preemption safety: step n's noise comes from a generator on the run's
device seeded from ``(--run-seed, n)`` alone, and checkpoints persist the
full :class:`~repro_torch.checkpoint.DPTrainState` (params, optimizer,
cross-step clip state, the accountant ledger, the plan fingerprint, the
monitor, the noise seed and the noise generator's device), so a killed
run resumes bit-identically.  That needs a deterministic step, which the
CLI sets up before CUDA starts: ``torch.use_deterministic_algorithms``,
``CUBLAS_WORKSPACE_CONFIG`` and TF32 off for matmuls and cuDNN.  The
port's own kernels sum in a fixed order (no atomics).

    PYTHONPATH=src python -m repro_torch.launch.train --arch alexnet \\
        --full --batch 32 --strategy auto --steps 6 --ckpt-dir ckpt \\
        --ckpt-every 2 --fail-at 3

The flags are the JAX CLI's, plus ``--device`` (``cuda`` unless the
caller asks for ``cpu``) and ``--attn-impl`` (the attention
implementation of an LM config, e.g. ``flash``).  ``--calibration``
takes ``analytic``, a saved calibration blob (``calibrate.
save_calibration``; an unusable one falls back to the analytic constants
with a warning) or ``measure`` (the harness on the run's device); the
planned step (``--strategy auto``) then feeds each step's wall time —
the whole step, making the batch on the host included, as the JAX CLI
observes it — to the mispredict loop (``--mispredict-threshold``), and
prints ``[calibrate]`` and ``[replan]`` lines.  The first step of each
segment and the first after a re-plan are not observed: they hold the
kernels' build and the plan's probe.  A checkpoint pins the plan
fingerprint under the analytic constants, which names the mechanism: a
re-plan re-prices, so a run resumes across one.

Data parallelism: ``--mesh data:N`` runs N ranks, one a device, under
``torch.distributed.run`` (rank r on ``cuda:(r % device_count)``)::

    python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --arch alexnet --mesh data:2 \
        --backend gloo --steps 4 --ckpt-dir ckpt

``--backend`` is ``nccl`` (default) or ``gloo`` (NCCL refuses two ranks
on one card; gloo stages CUDA tensors through the host).  Every rank
makes the global batch and steps on its slice (``PrivacyEngine(mesh=)``);
rank 0 writes the checkpoints, behind a barrier, with the mesh recorded.
Resume follows the JAX CLI: an explicit ``--mesh`` wins; otherwise the
checkpoint's mesh is collapsed onto the live world size
(``runtime.elastic_mesh_axes``) and re-planned, and a fingerprint that
differs only by the mesh is accepted (re-keyed under the checkpoint's
mesh); the ledger and the ``(run_seed, step)`` noise stream continue.  On
a mesh with a model axis (``--mesh data:2,model:2``) the step runs
tensor-sharded, the params sliced by their logical axes; what the axis
leaves out (block taps beside sliced heads, FSDP) raises
``NotImplementedError`` naming ROADMAP.md item 14 part 3.
The last line printed is a JSON summary (losses, per-step ms, the part
of it spent making the batch on the host and copying it over,
checkpoint save ms and bytes, re-plans).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer, DPTrainState
from repro_torch.configs import get_config
from repro_torch.core import (ClipPolicy, DPConfig, PrivacyAccountant,
                              PrivacyEngine, costmodel)
from repro_torch.data import SyntheticImageDataset, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.runtime import (ChaosMonkey, StepMonitor,
                                 elastic_mesh_axes, run_with_restarts)


def make_batch_fn(cfg, batch: int, seq: int):
    """``fn(step) -> numpy batch``: the JAX CLI's data order (examples
    ``step·batch ..`` modulo the dataset), so both CLIs see the same
    batches."""
    if cfg.family == "cnn":
        ds = SyntheticImageDataset(cfg.img_size, cfg.n_classes)
    else:
        ds = SyntheticLMDataset(cfg.vocab, seq)

    def fn(step):
        idx = (np.arange(batch) + step * batch) % len(ds)
        b = ds.batch(idx)
        if cfg.family != "encdec":
            return b
        # half the length of source frames (numpy RandomState(step)) and
        # half of target tokens
        g = np.random.RandomState(step)
        return {"src_frames": g.randn(batch, seq // 2, cfg.d_model)
                .astype(np.float32),
                "tokens": b["tokens"][:, : seq // 2],
                "labels": b["labels"][:, : seq // 2]}
    return fn


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


@contextlib.contextmanager
def deterministic_step():
    """Deterministic algorithms, cuBLAS's fixed workspace, no TF32 and no
    reduced-precision reductions in bf16 GEMMs for the duration of a run;
    the previous settings come back after it (the tests call :func:`main`
    in-process)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    mm = torch.backends.cuda.matmul
    prev = (torch.are_deterministic_algorithms_enabled(), mm.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = prev[1:]


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--strategy", default=None,
                    choices=[None, "naive", "multi", "crb", "ghost", "bk",
                             "auto"])
    ap.add_argument("--clip-mode", default="flat",
                    choices=["flat", "per_layer", "stale"],
                    help="clipping policy: flat (exact, default), "
                         "per_layer (per-layer budgets with sum C_l^2 = "
                         "C^2), or stale (lagged coefficients; fused "
                         "single-pass plan, 1 fwd + 1 bwd steady state)")
    ap.add_argument("--clip-budgets", default="uniform",
                    choices=["uniform", "auto"],
                    help="per_layer budget split: uniform, or auto "
                         "(tracked per-layer norm quantiles)")
    ap.add_argument("--microbatches", default=1,
                    type=lambda v: v if v == "auto" else int(v),
                    help="int, or 'auto' to derive from the plan's "
                         "peak-memory estimates")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec, e.g. data:2 or data:2,model:2 (run "
                         "the ranks under torch.distributed.run)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="torch.distributed backend of a --mesh run")
    ap.add_argument("--explain", action="store_true",
                    help="print the per-layer execution plan and exit")
    ap.add_argument("--plan-json", default=None,
                    help="plan store file: loaded if present (skips the "
                         "probe), written after planning otherwise")
    ap.add_argument("--calibration", default=None,
                    help="'analytic' plans from the analytic constants; a "
                         "calibration JSON path loads measured ones "
                         "(unusable blobs fall back to the analytic "
                         "constants with a named warning); 'measure' runs "
                         "the harness on the run's device")
    ap.add_argument("--mispredict-threshold", type=float, default=0.5,
                    help="relative measured-vs-predicted step time "
                         "divergence that triggers a re-plan (needs a "
                         "calibration and --strategy auto); <= 0 "
                         "disables")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--run-seed", type=int, default=0,
                    help="seed of the deterministic noise stream: step n's "
                         "generator is seeded from (run_seed, n), so a "
                         "resumed run replays exactly the noise an "
                         "uninterrupted run would draw")
    ap.add_argument("--chaos", type=float, default=0.0,
                    help="chaos drill: per-step failure probability "
                         "(seeded via --chaos-seed, so drills replay)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--restart-backoff", type=float, default=0.0,
                    help="base seconds of the jittered exponential "
                         "restart backoff")
    ap.add_argument("--restart-window", type=float, default=None,
                    help="budget --max-restarts over a sliding window of "
                         "this many seconds instead of the whole run")
    ap.add_argument("--delta", type=float, default=1e-5)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override reduced d_model (e.g. ~100M scale)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the run executes: cuda (default) or cpu")
    ap.add_argument("--attn-impl", default=None,
                    choices=[None, "auto", "xla", "chunked", "flash"],
                    help="attention implementation of an LM config "
                         "(default: the config's)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with deterministic_step():
        return _run(args)


def _live_mesh(args, device, stored_meta):
    """(mesh, device, owned): the mesh this run steps on — ``--mesh``, or
    the checkpoint's collapsed onto the live world size — initializing
    the process group for it unless one is (``owned``: this call did);
    ``(None, device, False)`` for one device."""
    spec = args.mesh
    if not spec and stored_meta and stored_meta.get("mesh_axes"):
        stored = tuple((n, int(s)) for n, s in stored_meta["mesh_axes"])
        world = int(os.environ.get("WORLD_SIZE", "1"))
        try:
            live = elastic_mesh_axes(stored, world, args.batch)
        except ValueError:
            # Too few ranks for the checkpoint's model degree: the
            # checkpoint holds whole arrays, so drop the model axis.
            live = elastic_mesh_axes(costmodel.mesh_data_axes(stored),
                                     world, args.batch)
        if live != stored:
            print(f"[elastic] checkpoint mesh {costmodel.format_mesh(stored)}"
                  f" -> {costmodel.format_mesh(live)} on {world} rank(s) "
                  f"(re-planning; ledger and noise stream continue)")
        spec = ",".join(f"{n}:{s}" for n, s in live)
    if not costmodel.mesh_axes(spec):
        return None, device, False
    from repro_torch.launch.mesh import init_distributed, make_mesh_from_spec
    owned = not dist.is_initialized()
    device = init_distributed(args.backend, device_type=device.type)
    mesh = make_mesh_from_spec(spec, device_type=device.type)
    d = costmodel.mesh_data_size(costmodel.mesh_axes(mesh))
    if args.batch % d:
        raise SystemExit(f"--batch {args.batch} not divisible by the "
                         f"mesh's data-parallel degree {d}")
    print(f"[mesh] {costmodel.format_mesh(costmodel.mesh_axes(mesh))} "
          f"rank {dist.get_rank()}/{dist.get_world_size()} on {device} "
          f"backend {dist.get_backend()}")
    return mesh, device, owned


def _run(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model,
                          d_ff=(args.d_model * 4 if cfg.d_ff else 0),
                          head_dim=max(args.d_model // max(cfg.n_heads, 1),
                                       8))
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    model = build_model(cfg)
    # Non-flat clip modes need a per-group coefficient flow: respect an
    # explicit --strategy (DPConfig validates the combination), but only
    # override the model's configured default when it would be invalid.
    strategy = args.strategy or cfg.dp_strategy
    if args.clip_mode != "flat" and args.strategy is None \
            and strategy not in ("auto", "bk"):
        strategy = "auto"
    dpc = DPConfig(l2_clip=args.clip, noise_multiplier=args.noise,
                   strategy=strategy, microbatches=args.microbatches,
                   delta=args.delta,
                   clipping=ClipPolicy(mode=args.clip_mode,
                                       budgets=args.clip_budgets))
    batch_fn = make_batch_fn(cfg, args.batch, args.seq)
    n_data = 1 << 16
    acct = PrivacyAccountant(sampling_rate=args.batch / n_data,
                             noise_multiplier=args.noise)
    chaos = ChaosMonkey(fail_at_steps=args.fail_at, p=args.chaos,
                        seed=args.chaos_seed)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.plan_json and os.path.exists(args.plan_json):
        n = costmodel.load_plan_store(args.plan_json)
        print(f"[plan] loaded {n} plan(s) from {args.plan_json}")
    stored_meta = (ckpt.read_meta() if ckpt and ckpt.latest_step()
                   is not None else None)
    mesh, device, owned = _live_mesh(args, device, stored_meta)
    try:
        return _train(args, cfg, model, dpc, batch_fn, acct, chaos, ckpt,
                      mesh, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, cfg, model, dpc, batch_fn, acct, chaos, ckpt, mesh,
           device):
    rank = 0 if mesh is None else dist.get_rank()
    writer = rank == 0

    def barrier():
        if mesh is not None:
            dist.barrier()

    params0, axes = model.init(0, device=device)
    mon = StepMonitor()
    engine = PrivacyEngine(
        model.apply, params0, to_device(batch_fn(0), device), dp=dpc,
        optimizer="adamw",
        lr=lambda step: cosine_schedule(step, warmup=10, total=args.steps,
                                        peak=args.lr),
        weight_decay=0.01, accountant=acct, run_seed=args.run_seed,
        device=device, mesh=mesh, param_axes=axes,
        calibration=args.calibration,
        mispredict_threshold=(args.mispredict_threshold
                              if args.mispredict_threshold > 0 else None),
        monitor=mon)
    if engine.calibration is not None:
        c = engine.calibration
        print(f"[calibrate] {c.digest()} (source={c.source}, "
              f"flops/s={c.flops_per_second:.4g}, hbm B/s="
              f"{c.hbm_bytes_per_second:.4g}, pe_conv_grad tile_rows="
              f"{c.kernels.get('pe_conv_grad', {}).get('tile_rows', 0)})")
    # Fixed strategies bypass the planner; don't pay an advisory probe for
    # them unless the user asks.
    if args.explain or dpc.strategy == "auto":
        print(engine.explain())
    if args.explain:
        return []
    if args.plan_json and not os.path.exists(args.plan_json) and writer:
        engine.save_plan(args.plan_json)
        print(f"[plan] wrote {args.plan_json}")

    def train_state(params, opt):
        # Every rank calls: the stale norms are gathered over the mesh,
        # the sliced leaves over the model group.
        return DPTrainState(
            params=engine.gather_params(params), opt=engine.gather_opt(opt),
            clip_state=engine.clip_state_dict(),
            ledger=acct.state_dict(),
            plan_fingerprint=engine.fingerprint(calibration="analytic"),
            monitor=mon.state_dict(), run_seed=args.run_seed,
            noise_device=device.type, mesh_axes=engine.mesh_axes,
            fsdp=engine.fsdp)

    timing = {"step_ms": {}, "data_ms": {}, "ckpt_snapshot_ms": [],
              "ckpt_final_ms": None, "ckpt_bytes": None}

    def segment(restart_count):
        params = engine.shard_params(params0)
        opt = adamw_init(params)
        start = 0
        if ckpt:
            # A restart in this process sees the save its previous life
            # had in flight (a killed process would have lost it); on a
            # mesh, every rank waits for rank 0's.
            ckpt.wait()
            barrier()
        if ckpt and ckpt.latest_step() is not None:
            st, at = ckpt.restore_state(params0, adamw_init(params0),
                                        fallback=True)
            if st.run_seed is not None and st.run_seed != args.run_seed:
                raise SystemExit(
                    f"checkpoint noise stream run_seed={st.run_seed} != "
                    f"--run-seed {args.run_seed}: resuming would draw a "
                    f"different noise sequence than the run being resumed")
            if st.noise_device is not None \
                    and st.noise_device != device.type:
                raise SystemExit(
                    f"checkpoint drew its noise on {st.noise_device}, this "
                    f"run is on {device.type}: the generators of the two "
                    f"devices draw different numbers from one seed")
            if st.plan_fingerprint and st.plan_fingerprint \
                    != engine.fingerprint(calibration="analytic"):
                # A mesh change is the one legitimate drift: re-key the
                # fingerprint under the checkpoint's mesh.
                if st.plan_fingerprint != engine.fingerprint(
                        calibration="analytic", mesh=st.mesh_axes):
                    raise SystemExit(
                        "checkpoint plan fingerprint mismatch beyond the "
                        "mesh: model code, shapes, or DP config changed; "
                        "refusing to resume onto a different mechanism")
            params = engine.shard_params(st.params)
            opt = engine.shard_opt(st.opt)
            engine.load_clip_state(st.clip_state)
            if st.ledger is not None:
                acct.load_state_dict(st.ledger)
            if st.monitor is not None:
                mon.load_state_dict(st.monitor)
            start = at + 1
            print(f"[restore] resuming from step {start}")
        else:
            # From-scratch (re)start: params go back to params0, so the
            # ledger and cross-step clip state must go back too.
            engine.reset_clip_state()
            acct.reset()
        losses = []
        skip_observe = True
        for step in range(start, args.steps):
            chaos.maybe_fail(step)
            mon.start()
            t = time.perf_counter()
            batch = to_device(batch_fn(step), device)
            timing["data_ms"][step] = (time.perf_counter() - t) * 1e3
            params, opt, loss, aux = engine.private_step(
                params, opt, batch, step=step)
            losses.append(float(loss))     # waits for the step
            dt = mon.stop(step)
            timing["step_ms"][step] = dt * 1e3
            if skip_observe:
                skip_observe = False
            else:
                ev = engine.observe_step_time(dt, step=step)
                if ev is not None:
                    skip_observe = True
                    print(f"[replan] step {step}: measured/predicted "
                          f"{ev.ratio:.2f}x ({ev.measured_s * 1e3:.1f} ms "
                          f"vs {ev.predicted_s * 1e3:.1f} ms) — "
                          f"calibration {ev.old_calibration} -> "
                          f"{ev.new_calibration}, plan "
                          f"{'changed' if ev.plan_changed else 'kept'}")
            if step % 10 == 0 or step == args.steps - 1:
                if "clip_fraction_lagged" in aux:
                    clip_msg = (f"clip_frac(lagged) "
                                f"{float(aux['clip_fraction_lagged']):.2f}")
                else:
                    clip_msg = f"clip_frac {float(aux['clip_fraction']):.2f}"
                print(f"step {step:4d} loss {losses[-1]:.4f} "
                      f"{clip_msg} {dt*1e3:.0f}ms"
                      + (f" [{engine.report()}]" if args.noise else ""))
            if ckpt and (step + 1) % args.ckpt_every == 0:
                t = time.perf_counter()
                state = train_state(params, opt)
                if writer:
                    ckpt.save_state_async(step, state)
                timing["ckpt_snapshot_ms"].append(
                    (time.perf_counter() - t) * 1e3)
        if ckpt:
            ckpt.wait()
            t = time.perf_counter()
            state = train_state(params, opt)
            if writer:
                path = ckpt.save_state(args.steps - 1, state)
                timing["ckpt_final_ms"] = (time.perf_counter() - t) * 1e3
                timing["ckpt_bytes"] = _dir_bytes(path)
            barrier()
        return losses

    losses, restarts = run_with_restarts(
        segment, max_restarts=args.max_restarts,
        backoff_s=args.restart_backoff,
        restart_window_s=args.restart_window)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}), "
          f"restarts={restarts}, stragglers={len(mon.stragglers)}, "
          f"replans={len(mon.replans)}")
    if args.noise:
        print(engine.report())
    print(json.dumps({"train_summary": {
        "arch": cfg.name, "device": str(device), "steps": args.steps,
        "mesh": costmodel.format_mesh(engine.mesh_axes), "rank": rank,
        "restarts": restarts, "losses_last_segment": losses,
        "step_ms": [timing["step_ms"][s] for s in sorted(timing["step_ms"])],
        "data_ms": [timing["data_ms"][s] for s in sorted(timing["data_ms"])],
        "ckpt_snapshot_ms": timing["ckpt_snapshot_ms"],
        "ckpt_final_ms": timing["ckpt_final_ms"],
        "ckpt_bytes": timing["ckpt_bytes"],
        "replans": [dataclasses.asdict(ev)
                    for ev in engine.replan_events]}}))
    return losses


if __name__ == "__main__":
    main()
