"""Trace a PrivacyEngine's private step and verify DP invariants.

:func:`verify_engine` is what ``engine.verify()`` and the ``dpcheck``
CLI call.  It traces the engine's step closure (``engine._step_fn()``:
``dp_gradient`` and the optimizer update, what ``private_step`` runs)
with ``make_fx`` on fake tensors of the engine's own device
(:mod:`repro_torch.analysis.graph`): nothing executes, no device memory
is taken, and on the card the graph holds each hand-written kernel as
one node.  Three passes read it:

  * taint  (:mod:`repro_torch.analysis.taint`)  — clip before any batch
    reduction on every path to the released params and optimizer state;
  * noise  (:mod:`repro_torch.analysis.noise`)  — one fresh f32 Gaussian
    per released leaf at sigma·C, every draw from the step's generator
    stream, no stream consumed twice;
  * plan   (:mod:`repro_torch.analysis.plancheck`) — the ExecPlan's
    declared realizations executed (marker + STATS census), live
    fingerprint, the predicted collective bytes against
    ``coll_bytes_warn``;
  * sharding (:mod:`repro_torch.analysis.shardcheck`) — on a mesh: the
    step is traced as rank 0 and as the last rank of a fake group of the
    data degree (:func:`repro_torch.launch.mesh.fake_world`; an engine
    on a live mesh traces its own rank over its own group), and the
    pass checks the batch slice, the one gradient all-reduce a leaf, the
    noise after it from one seed, the global divisor and statistics.
    With a tensor-sharded model axis the step is traced on the rank's
    slices over a fake ``data x model`` world
    (:func:`repro_torch.launch.mesh.fake_mesh`) as (data 0, model 0),
    (data 0, the last model rank) and (the last data rank, model 0),
    and the model half reads it: one model sum of each sliced group's
    partial norm², none of a replicated one's, no model sum of a
    clipped contribution, the noise as slices of one full draw.
    Under FSDP each traced rank holds its data slices too, and the
    data-slice half reads every traced data rank: the param gathers are
    layout moves, each summed leaf keeps the rank's own slice, and its
    noise is the rank's slice of the one draw.

Violations that only feed the *monitoring* outputs (the mean
loss, clip fractions, the stale norms) are filtered by a backward slice
from the params and optimizer outputs.

Verifying leaves the engine as it found it: its cross-step clip state,
its plan cache, ``tapper.STATS`` (the trace's own ticks are what the
plan pass reads, then they are taken back) and ``ops.LAUNCHES`` (a fake
trace launches nothing).  Stale mode is verified in its steady state,
with a (B,) f32 ``prev_norms_sq`` (its bootstrap step is the flat
pipeline, which the flat lane covers).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from repro_torch.analysis import graph as graphlib
from repro_torch.analysis import noise as noiselib
from repro_torch.analysis import plancheck, shardcheck
from repro_torch.analysis import taint as taintlib
from repro_torch.analysis.report import Finding, VerifyReport

_STAT_FIELDS = ("forwards", "backwards", "probes", "fused", "recomputes")


def _fake(fm: FakeTensorMode, spec, device):
    with fm:
        return torch.empty(tuple(spec.shape), dtype=spec.dtype,
                           device=device)


def _opt_state(engine, opt, fm, params):
    if opt is not None:
        return pytree.tree_map(
            lambda t: fm.from_tensor(t) if isinstance(t, torch.Tensor)
            else t, opt)
    from repro_torch.optim import adamw_init, sgdm_init
    table = {"adamw": adamw_init, "sgdm": sgdm_init}
    if engine._optimizer_name not in table:
        raise ValueError(
            "engine uses a custom optimizer callable; pass opt= (a live "
            "optimizer state) to verify()")
    with fm:
        return table[engine._optimizer_name](params)


@contextlib.contextmanager
def _engine_state_kept(engine):
    """Restore the engine's cross-step clip state, the plan caches and
    ``STATS`` on the way out."""
    from repro_torch.core import costmodel
    from repro_torch.core.tapper import STATS
    kept = (engine._prev_norms_sq, engine._budgets, engine._budget_q,
            engine._plan)
    cache = list(costmodel._PLAN_CACHE.items())
    stats = {k: getattr(STATS, k) for k in _STAT_FIELDS}
    try:
        yield
    finally:
        (engine._prev_norms_sq, engine._budgets, engine._budget_q,
         engine._plan) = kept
        costmodel._PLAN_CACHE.clear()
        costmodel._PLAN_CACHE.update(cache)
        for k, v in stats.items():
            setattr(STATS, k, v)


def verify_engine(engine, *, opt=None,
                  coll_bytes_warn: Optional[float] = None) -> VerifyReport:
    """Statically verify one engine's private step.  Returns a
    :class:`~repro_torch.analysis.report.VerifyReport`; never executes the
    step.  ``coll_bytes_warn`` (bytes a step and device) warns when the
    plan predicts more collective traffic."""
    with _engine_state_kept(engine):
        return _verify(engine, opt, coll_bytes_warn)


def _trace_step(engine, shard, key, params, opt_state, batch, clip_state):
    step = engine._step_fn(shard)
    return graphlib.capture(
        lambda p, o, b, c: step(p, o, b, key, c),
        params, opt_state, batch, clip_state)


def _verify(engine, opt, coll_bytes_warn) -> VerifyReport:
    from repro_torch.core import costmodel
    from repro_torch.core.clipping import DataShard
    from repro_torch.core.engine import noise_seed
    from repro_torch.core.tapper import STATS, TensorSpec
    from repro_torch.launch.sharding import data_dims, is_sharded
    from repro_torch.tree import get_subtree, leaf_paths, tree_map

    findings: List[Finding] = []
    checked = {}
    mode = engine.dp.clipping.mode
    sigma_mult = engine.dp.noise_multiplier
    l2_clip = engine.dp.l2_clip
    dev = engine.device
    B = next(iter(engine._batch_spec.values())).shape[0]
    stale_steady = mode == "stale"
    axes = engine.mesh_axes
    specs = engine.param_specs
    msize = (costmodel.mesh_model_size(axes)
             if costmodel.mesh_model_axes(axes) and specs is not None else 1)
    d = costmodel.mesh_data_size(axes)
    fsdp = specs if engine.fsdp and d > 1 else None
    if B % d:
        raise ValueError(f"global batch {B} is not divisible by the mesh's "
                         f"data-parallel degree {d}")

    # Planning (and any probes) happen before the STATS snapshot, so the
    # traced step's census below sees only the step's own phases.
    plan = engine._exec_plan()
    m = engine.microbatches()

    # The step's generator: the stream's, through the engine's own
    # provenance check, or (no stream) one seeded as step 0 of run 0.
    step_seed = None
    if sigma_mult > 0:
        if engine.run_seed is not None:
            key = engine._check_key(engine.noise_key(0), step=0)
            step_seed = noise_seed(engine.run_seed, 0)
        else:
            step_seed = noise_seed(0, 0)
            key = torch.Generator(device=dev)
            key.manual_seed(step_seed)
    else:
        key = None

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    params = engine._params_spec
    if msize > 1 or fsdp is not None:
        from repro_torch.launch.sharding import local_shape
        dl = 1 if fsdp is None else d
        params = tree_map(lambda s, sp: TensorSpec(
            local_shape(s.shape, sp, msize, dl), s.dtype), params, specs)
    params = tree_map(lambda s: _fake(fm, s, dev), params)
    batch = tree_map(lambda s: _fake(fm, s, dev), engine._batch_spec)
    opt_state = _opt_state(engine, opt, fm, params)
    if stale_steady:
        clip_state = {"prev_norms_sq": _fake(
            fm, TensorSpec((B // d,), torch.float32), dev)}
    else:
        clip_state = {k: fm.from_tensor(v)
                      for k, v in engine._clip_state().items()}

    # The traces: one, or on a mesh rank 0 and the last rank (each over
    # a fake group of the data degree; a live engine's own rank and
    # group).  The first is the one every pass reads.
    traces = []
    before = {k: getattr(STATS, k) for k in ("forwards", "backwards",
                                             "probes", "fused")}
    stats_delta = None
    model_traces = []    # (model rank, model group name, graph)
    if msize > 1:
        from repro_torch.core.clipping import MeshShard
        from repro_torch.launch.mesh import fake_mesh
        from repro_torch.launch.sharding import ModelShard
        sh = engine._shard
        if sh is not None:
            ms = sh.model
            ranks = [(sh.rank, ms.rank, sh, ms)]
        else:
            ranks = [(0, 0), (0, msize - 1)] + ([(d - 1, 0)] if d > 1
                                                else [])
        for entry in ranks:
            if sh is not None:
                dr, mr, shard, ms = entry
                gname = "" if shard.group is None else shard.group.group_name
                g = _trace_step(engine, shard, key, params, opt_state,
                                batch, clip_state)
            else:
                dr, mr = entry
                with fake_mesh(d, msize, rank=dr * msize + mr) as (dg, mg):
                    ms = ModelShard(mg, mr, msize, specs)
                    shard = MeshShard(dg, dr, d, fsdp, model=ms)
                    gname = "" if dg is None else dg.group_name
                    g = _trace_step(engine, shard, key, params, opt_state,
                                    batch, clip_state)
            if stats_delta is None:
                stats_delta = {k: getattr(STATS, k) - v
                               for k, v in before.items()}
            traces.append((dr, gname, g))
            model_traces.append((mr, ms.group.group_name, g))
        if len(traces) > 2:      # model-rank pair first, data pair after
            traces = [traces[0], traces[2]]
    elif not axes or d == 1:
        traces.append((0, "", _trace_step(engine, None, key, params,
                                          opt_state, batch, clip_state)))
    elif engine._shard is not None:
        sh = engine._shard
        traces.append((sh.rank, sh.group.group_name, _trace_step(
            engine, sh, key, params, opt_state, batch, clip_state)))
    else:
        from repro_torch.launch.mesh import fake_world
        for r in sorted({0, d - 1}):
            with fake_world(d, rank=r) as group:
                traces.append((r, group.group_name, _trace_step(
                    engine, DataShard(group, r, d, fsdp), key, params,
                    opt_state, batch, clip_state)))
            if stats_delta is None:
                stats_delta = {k: getattr(STATS, k) - v
                               for k, v in before.items()}
    if stats_delta is None:
        stats_delta = {k: getattr(STATS, k) - v for k, v in before.items()}
    graph = traces[0][2]

    # -- input bookkeeping -------------------------------------------------
    n_p = len(pytree.tree_leaves(params))
    n_o = len(pytree.tree_leaves(opt_state))
    batch_leaves = pytree.tree_leaves(batch)
    n_b = len(batch_leaves)
    invars = graph.invars
    init = {}
    for v, leaf in zip(invars[n_p + n_o:n_p + n_o + n_b], batch_leaves):
        if leaf.shape and leaf.shape[0] == B:
            init[v] = taintlib.Taint(frozenset({0}))
    cs_paths = [pytree.keystr(p) for p, _ in
                pytree.tree_flatten_with_path(clip_state)[0]]
    for v, path in zip(invars[n_p + n_o + n_b:], cs_paths):
        if "prev_norms_sq" in path:
            init[v] = taintlib.Taint(frozenset({0}))

    # -- taint pass --------------------------------------------------------
    res = taintlib.TaintPass(
        graph, B // d, m,
        model_groups=[g for _, g, _ in model_traces[:1]]).run(init)
    sinks = [v for path, v in zip(graph.out_paths, graph.outvars)
             if getattr(path[0], "idx", None) in (0, 1)]
    released = graph.backward_slice(sinks)
    for viol in res.violations:
        if viol.node not in released:
            continue  # feeds only the loss/monitoring outputs
        findings.append(Finding(
            "error", "unclipped_batch_reduction",
            viol.message + " on a path to the released model update",
            "taint"))
    if res.approx:
        uniq = sorted(set(res.approx))
        findings.append(Finding(
            "info", "taint_approximation",
            f"unmodeled ops handled conservatively: {uniq[:8]}", "taint"))
    checked["taint"] = (
        f"all batch-axis reductions reaching the released update cross a "
        f"clip contraction ({len(graph.nodes)} op nodes, B={B})")

    # -- clip marker discipline -------------------------------------------
    clip_markers = [p for _, p in graph.markers()
                    if p.get("kind") == "clip_coef"]
    if not clip_markers:
        findings.append(Finding(
            "error", "clip_missing",
            "no clip-coefficient marker in the traced step — the "
            "per-example clip was removed or replaced", "taint"))
    else:
        modes = {p.get("mode") for p in clip_markers}
        if mode not in modes and not (mode == "stale" and "flat" in modes):
            findings.append(Finding(
                "error", "clip_mode_mismatch",
                f"engine clips {mode!r} but the traced coefficients are "
                f"{sorted(modes)}", "taint"))
        for p in clip_markers:
            c = p.get("l2_clip")
            if c is not None and abs(float(c) - l2_clip) > 1e-9 * max(
                    l2_clip, 1.0):
                findings.append(Finding(
                    "error", "clip_bound_mismatch",
                    f"traced clip bound {c} != configured C={l2_clip}",
                    "taint"))
                break
    checked["clip"] = (f"{len(clip_markers)} clip-coefficient site(s), "
                       f"mode {mode!r}, C={l2_clip}")

    # -- noise pass --------------------------------------------------------
    findings.extend(noiselib.check_noise(
        graph, step_seed=step_seed, n_param_leaves=n_p,
        noise_multiplier=sigma_mult, l2_clip=l2_clip))
    checked["noise"] = (
        f"one f32 Gaussian per released leaf ({n_p} leaves) at "
        f"sigma·C = {sigma_mult * l2_clip:g}, every draw from the step's "
        f"generator stream (seed noise_seed(run_seed, step), checked by "
        f"_check_key host-side), no stream consumed twice"
        if sigma_mult > 0 else "noise_multiplier == 0: no draws expected")

    # -- sharding ----------------------------------------------------------
    if axes and d > 1:
        findings.extend(shardcheck.check_sharding(
            graph, taints=res.taints, batch_size=B, data_size=d,
            rank=traces[0][0], group_name=traces[0][1],
            n_batch_inputs=n_b, batch_offset=n_p + n_o,
            noise_expected=sigma_mult > 0,
            rank_seeds=[shardcheck.draw_seeds(g) for _, _, g in traces]))
        checked["sharding"] = (
            f"mesh {costmodel.format_mesh(axes)}: traced as rank(s) "
            f"{[r for r, _, _ in traces]} of {d}; batch slice B/d = "
            f"{B // d}, one sum all-reduce a released leaf over the data "
            f"group, noise after it from one seed, divisor B = {B}, "
            f"statistics over the group")
        if fsdp is not None:
            findings.extend(shardcheck.check_fsdp(
                traces, specs=specs, param_shapes=engine._params_spec,
                data_size=d, noise_expected=sigma_mult > 0))
            n_dl = sum(1 for p in leaf_paths(specs)
                       if data_dims(get_subtree(specs, p)))
            checked["sharding"] += (
                f"; FSDP: {n_dl} of {len(leaf_paths(specs))} leaves sliced "
                f"{d} ways over data, traced as data rank(s) "
                f"{[r for r, _, _ in traces]}: the param gathers layout "
                f"moves, each summed leaf the rank's own slice, its noise "
                f"the rank's slice of one full draw")
    elif axes:
        checked["sharding"] = (f"mesh {costmodel.format_mesh(axes)}: no "
                               f"data degree")
    else:
        checked["sharding"] = "no mesh: single-device step"
    if model_traces:
        findings.extend(shardcheck.check_model(
            model_traces, taints=res.taints, specs=specs,
            param_shapes=engine._params_spec, model_size=msize,
            noise_expected=sigma_mult > 0))
        n_sh = sum(1 for p in leaf_paths(specs)
                   if is_sharded(get_subtree(specs, p)))
        checked["sharding"] += (
            f"; params partitioned over model ({n_sh} of "
            f"{len(leaf_paths(specs))} leaves sliced {msize} ways), traced "
            f"as model rank(s) {sorted({r for r, _, _ in model_traces})}: "
            f"each sliced group's partial norm² summed over model once "
            f"before any coefficient, replicated norms never, clipped "
            f"contributions local, noise the slices of one full draw")

    # -- plan pass ---------------------------------------------------------
    expected_fp = (engine.fingerprint()
                   if plan is not None and m == 1 else None)
    findings.extend(plancheck.check_plan(
        graph, plan=plan, clip_mode=mode, stale_steady=stale_steady,
        stats_delta=stats_delta, expected_fingerprint=expected_fp,
        microbatches=m, coll_bytes_warn=coll_bytes_warn))
    checked["plan"] = (
        f"{len(plan.groups)} group realizations present in the graph, "
        f"STATS census {stats_delta}, fingerprint {plan.fingerprint or '-'}"
        if plan is not None
        else f"fixed strategy {engine.dp.strategy!r}: no plan to check")

    owner = getattr(engine.apply_fn, "__self__", None)
    model = (type(owner).__qualname__ if owner is not None
             else getattr(engine.apply_fn, "__qualname__", "<fn>"))
    target = (f"{model} clip={mode} sigma={sigma_mult} B={B} "
              f"mesh={costmodel.format_mesh(axes) if axes else 'none'} "
              f"device={dev}" + (f" microbatches={m}" if m != 1 else ""))
    order = {"error": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: order[f.severity])
    return VerifyReport(target=target, findings=findings, checked=checked,
                        census=graphlib.census(graph))
