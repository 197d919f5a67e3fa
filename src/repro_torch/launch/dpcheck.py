"""Static DP-invariant checker: trace the private step, prove it, exit.

``dpcheck`` is the CI face of :mod:`repro_torch.analysis` (the JAX
package's ``repro.launch.dpcheck``, its flags and exit status, over the
port's registry).  For every ``arch x clip-mode`` lane it builds the
model reduced, constructs a :class:`~repro_torch.core.PrivacyEngine` on
``--device`` and calls ``engine.verify()``, which traces the private step
on fake tensors and abstractly interprets the graph, *without executing
a single step*:

  * per-example taint: every released gradient is clipped before any
    cross-example reduction (all clip modes, the fused kernel included);
  * noise discipline: one fresh f32 Gaussian per released leaf at
    ``sigma = noise_multiplier * l2_clip``, every draw from the step's
    generator stream, no stream consumed twice;
  * plan/graph consistency: the ExecPlan's realizations appear in the
    traced graph, the STATS census matches, the fingerprint is live;
  * sharding (``--mesh data:N`` lanes): the step traced as ranks of an
    in-process fake group of N (``launch.mesh.fake_world``: no
    processes, the JAX package's forced host devices) holds the batch
    slice, one gradient all-reduce a leaf, the noise after it from one
    seed, the global divisor and statistics; on ``data:N,model:M`` the
    params are tensor-sharded (the logical axes ``model.init`` returns),
    and the model half checks each sliced group's one model sum of its
    partial norms, none of a replicated group's, local contributions,
    and the noise as slices of one draw.

Exit status is 1 if any lane reports an error (or, with
``--fail-on-warn``, a warning), so a CI job wired to this module is a
hard gate.  On a model axis block taps (``--dp-attn``) raise
``NotImplementedError`` (ROADMAP.md item 14 part 3); every other family,
the enc-dec and recurrent ones included, runs tensor-sharded.  Every arch of
``configs.PAPER_IDS`` and ``configs.SERVED_LM`` runs, reduced.  The MoE
archs' gather dispatch has global capacity (the
examples' tokens compete for one expert's slots), and their lanes fail
on it, as the JAX package's do, on one device and on a mesh alike.

    PYTHONPATH=src python -m repro_torch.launch.dpcheck \\
        --archs alexnet vgg16 llama3.2-1b \\
        --clip-modes flat per_layer stale --mesh none data:8 data:4,model:2 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config
from repro_torch.core import ClipPolicy, DPConfig, PrivacyEngine, costmodel
from repro_torch.launch.train import make_batch_fn, to_device
from repro_torch.models.registry import build_model


def _build_engine(arch: str, clip_mode: str, *, batch: int, seq: int,
                  noise: float, clip: float, run_seed: int, strategy: str,
                  device: str, dp_attn: bool = False,
                  mesh: str | None = None) -> PrivacyEngine:
    cfg = get_config(arch).reduced()
    if dp_attn:
        cfg = cfg.replace(dp_attn=True)
    model = build_model(cfg)
    if clip_mode != "flat" and strategy not in ("auto", "bk"):
        strategy = "auto"
    dpc = DPConfig(l2_clip=clip, noise_multiplier=noise, strategy=strategy,
                   clipping=ClipPolicy(mode=clip_mode))
    params0, axes = model.init(0, device=device)
    return PrivacyEngine(model.apply, params0,
                         to_device(make_batch_fn(cfg, batch, seq)(0), device),
                         dp=dpc, optimizer="adamw", lr=1e-3,
                         weight_decay=0.01, run_seed=run_seed,
                         calibration="analytic", device=device, mesh=mesh,
                         param_axes=axes)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="statically verify DP invariants of the private step")
    ap.add_argument("--archs", nargs="+", default=["alexnet"])
    ap.add_argument("--clip-modes", nargs="+", default=["flat"],
                    choices=["flat", "per_layer", "stale"])
    ap.add_argument("--mesh", nargs="+", default=["none"],
                    help="mesh specs per lane; 'none' = one device, "
                         "'data:N' traces the sharded step on a fake "
                         "group of N ranks, 'data:N,model:M' the "
                         "tensor-sharded step on a fake N x M world")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--noise", type=float, default=0.8)
    ap.add_argument("--run-seed", type=int, default=0)
    ap.add_argument("--dp-attn", action="store_true",
                    help="enable the block-level attention realization "
                         "(dp_attn=True) so attention lanes exercise the "
                         "attn ghost-norm path")
    ap.add_argument("--strategy", default="auto",
                    help="per-example gradient strategy; 'auto' (default) "
                         "exercises the planner so the plan/graph "
                         "consistency pass has a plan to check")
    ap.add_argument("--coll-bytes-warn", type=int, default=None,
                    help="per-device collective-bytes warning threshold")
    ap.add_argument("--fail-on-warn", action="store_true",
                    help="treat warnings as failures too")
    ap.add_argument("--device", default="cuda",
                    help="where the traced step would run (cuda unless "
                         "the caller asks for cpu)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every finding, not just failures")
    args = ap.parse_args(argv)

    for spec in args.mesh:
        axes = () if spec == "none" else costmodel.mesh_axes(spec)
        if args.batch % costmodel.mesh_data_size(axes):
            raise SystemExit(f"--batch {args.batch} not divisible by the "
                             f"data degree of mesh {spec}")
    lanes = [(a, m, s) for a in args.archs for m in args.clip_modes
             for s in args.mesh]
    failed = []
    for arch, mode, spec in lanes:
        name = f"{arch} clip={mode} mesh={spec}"
        if args.dp_attn:
            name += " dp_attn"
        costmodel.clear_plan_cache()
        engine = _build_engine(arch, mode, batch=args.batch, seq=args.seq,
                               noise=args.noise, clip=args.clip,
                               run_seed=args.run_seed,
                               strategy=args.strategy, device=args.device,
                               dp_attn=args.dp_attn,
                               mesh=None if spec == "none" else spec)
        report = engine.verify(coll_bytes_warn=args.coll_bytes_warn)
        bad = bool(report.errors) or (args.fail_on_warn
                                      and bool(report.warnings))
        status = "FAIL" if bad else "PASS"
        extra = ""
        if report.warnings and not bad:
            extra = f"  ({len(report.warnings)} warning(s))"
        print(f"[dpcheck] {status}  {name}{extra}")
        shown = report.findings if args.verbose else (
            report.errors + report.warnings if bad else report.warnings)
        for f in shown:
            print(f"    {f.severity:7s} {f.code:28s} {f.message}")
        if bad:
            failed.append(name)
    print(f"[dpcheck] {len(lanes) - len(failed)}/{len(lanes)} lanes clean")
    if failed:
        for name in failed:
            print(f"[dpcheck]   failed: {name}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
