"""Sharding pass: the data-parallel private step's collectives.

The JAX package's pass (``repro/analysis/shardcheck.py``) reads the
declared SPMD shardings of a jitted step, since XLA inserts the psums
itself.  The port's sharded step (:func:`repro_torch.core.clipping.
dp_gradient` with a :class:`~repro_torch.core.clipping.DataShard`) has
its collectives in the graph: each is a ``_c10d_functional.all_reduce``
node naming its group.  So the pass keeps the JAX package's intent and
proves it on the port's own terms, over the ``make_fx`` graph of the
step as one rank of a fake group of the mesh's data degree traces it
(:func:`repro_torch.launch.mesh.fake_world`):

  * the batch input is the rank's contiguous ``B/d`` slice, and nothing
    else of the global batch is read (``batch_not_sharded``);
  * every released parameter leaf passes through exactly one sum
    all-reduce over the data group (``grad_sync_missing`` /
    ``grad_sync_repeated``): the replicas stay equal and each example is
    counted once;
  * the noise carries no example axis (``noise_per_example``), is added
    after that all-reduce (``noise_before_sync``: noise summed over d
    ranks has d times the variance), and every rank draws it from a
    generator of one seed (``noise_seed_rank_dependent``, comparing the
    traces of two ranks);
  * the released sum is divided by the global batch
    (``divisor_not_global``);
  * the statistics the next step's clipping reads — the per-example
    norms and, under per_layer clipping, the per-layer norms the auto
    budgets' quantiles come from — and the mean loss cover the whole
    group's examples (``budget_stats_local``, ``loss_not_global``).

The model half (:func:`check_model`), over the traces of a
tensor-sharded step (``data x model``, each rank on its slices), where
the JAX package's pass reads the declared param shardings:

  * each sliced group's partial norm² (its ``group_norm`` marker) passes
    through exactly one sum all-reduce over the model group on its way
    to the clip coefficients and the norm statistics
    (``model_norm_sum_missing`` / ``model_norm_sum_repeated``); a
    replicated group's norm, whole on every rank, through none
    (``model_norm_overcount``);
  * a partial replicated leaf — a replicated parameter applied to a
    rank's slice (qk-norm's query scale on sliced heads, Mamba2's ``ssd``
    params and sLSTM's gate bias in their ``local_vjp`` scans), whose
    per-example gradient the kind marks ``partial_pe`` — has that
    gradient summed over the model group exactly once before its group's
    norm (its ``group_norm`` marker) takes it (``model_partial_unsummed``:
    each rank would clip with the norm of its own heads' share); the sum
    is a legitimate model-group sum of a value with the example axis,
    neither a norm sum nor a contribution's, and the one sum a sliced
    group's norm takes after its marker (sLSTM's ``rec``: ``R`` sliced
    beside the partial ``b``) is the norm rule's;
  * no clipped contribution (a value without the example axis) is summed
    over the model group on its way to a released leaf
    (``model_contrib_reduced``: a slice would add the other ranks'
    slices, a replicated leaf M copies of itself), but for a partial
    replicated parameter's autograd gradient, marked ``partial_grad``
    (``launch.sharding.copy_to_model(param=True)``), whose sum over
    ``model`` completes it;
  * the noise of every leaf is drawn at the leaf's full shape, and a
    sliced leaf keeps the rank's slice of it; the model ranks draw from
    one seed (``noise_slice_mismatch``, comparing two model ranks'
    traces, as ``noise_seed_rank_dependent`` compares data ranks').

The data-slice half (:func:`check_fsdp`), over the traces of an FSDP
step (params and moments sliced over the data axes too; each data rank
traced on its slices).  The JAX package's pass reports any declared
sharding of a param over a data axis (``params_not_replicated``,
``outputs_not_replicated``), since its engine never hands it such a
layout; the port judges an FSDP step by the guarantee behind that rule,
stated in terms of the moves in the graph:

  * the param gathers at the step's start (``fsdp_gather`` markers) are
    layout moves, not sums over examples: they are left out of the
    counts above, so a released data-sliced leaf still passes through
    exactly one sum all-reduce over data (``grad_sync_missing`` /
    ``grad_sync_repeated``);
  * after that sum the rank keeps **its own** slice of each data-sliced
    leaf (``fsdp_slice_mismatch``: another rank's slice would release a
    sum twice and another never);
  * its noise is drawn at the leaf's full shape and the rank keeps its
    slice at its data coordinate (``noise_slice_mismatch``, as the
    model half checks the model coordinate).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.analysis.graph import FlatGraph, op_name, shape, val
from repro_torch.analysis.report import Finding

WHERE = "sharding"


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def sync_nodes(graph: FlatGraph, group_name: str) -> list:
    """The sum all-reduces of floating-point values over the group, in
    graph order.  An integer sum (the MoE dispatch's per-expert entry
    counts, which place a data rank's entries in the global slots) sums
    no gradient, norm or loss."""
    return [n for n in graph.nodes
            if op_name(n) == "all_reduce" and len(n.args) >= 3
            and str(n.args[1]) == "sum" and str(n.args[2]) == group_name
            and _floating(n)]


def gather_nodes(graph: FlatGraph, group_name: str) -> set:
    """FSDP's param gathers over the group: the sum all-reduces behind an
    ``fsdp_gather`` marker (a layout move, not a reduction)."""
    marks = [n for n, p in graph.markers() if p.get("kind") == "fsdp_gather"]
    if not marks:
        return set()
    return set(sync_nodes(graph, group_name)) & graph.backward_slice(marks)


def _floating(node) -> bool:
    v = val(node)
    return not isinstance(v, torch.Tensor) or v.dtype.is_floating_point


def draw_seeds(graph: FlatGraph) -> list:
    """The seeds of the generators the Gaussian draws take, in graph
    order (``None``: the default generator)."""
    from repro_torch.analysis.noise import _DRAWS
    out = []
    for n in graph.nodes:
        if op_name(n) in _DRAWS:
            g = graph.generator(n)
            out.append(None if g is None else g.initial_seed())
    return out


def _out_index(path) -> Optional[int]:
    return getattr(path[0], "idx", None) if path else None


def _out_key(path, i: int):
    if len(path) <= i:
        return None
    return getattr(path[i], "key", getattr(path[i], "idx", None))


def _divisors_after(node, depth: int = 8) -> list:
    """The numbers a value is divided by on its way from ``node`` to the
    release: ``div(x, n)`` (or in place, ``div_``) nodes reached through
    at most ``depth`` users (the noise add, casts, views)."""
    out, frontier, seen = [], [node], set()
    for _ in range(depth):
        nxt = []
        for n in frontier:
            for u in n.users:
                if u in seen:
                    continue
                seen.add(u)
                if op_name(u) in ("div", "div_") and len(u.args) > 1 \
                        and _is_number(u.args[1]) and u.args[0] is n:
                    out.append(u.args[1])
                else:
                    nxt.append(u)
        frontier = nxt
    return out


def check_sharding(graph: FlatGraph, *, taints, batch_size: int,
                   data_size: int, rank: int, group_name: str,
                   n_batch_inputs: int, batch_offset: int,
                   noise_expected: bool,
                   rank_seeds: Sequence[list] = ()) -> List[Finding]:
    """The sharded step's graph, traced as rank ``rank`` of ``data_size``
    with the data group named ``group_name``.  ``batch_offset`` and
    ``n_batch_inputs`` locate the batch among the graph's inputs;
    ``rank_seeds`` holds the draw seeds of every traced rank."""
    findings: List[Finding] = []
    B, d = batch_size, data_size
    if B % d:
        findings.append(Finding(
            "error", "batch_not_divisible",
            f"global batch {B} is not divisible by the mesh's "
            f"data-parallel degree {d}", WHERE))
        return findings
    Bl = B // d
    lo, hi = rank * Bl, (rank + 1) * Bl

    # -- the batch: this rank's slice, nothing else -------------------------
    for v in graph.invars[batch_offset:batch_offset + n_batch_inputs]:
        if not shape(v) or shape(v)[0] != B:
            continue
        for u in v.users:
            ok = (op_name(u) == "slice" and len(u.args) >= 4
                  and u.args[1] == 0 and u.args[2] == lo
                  and min(u.args[3], B) == hi)
            if not ok:
                findings.append(Finding(
                    "error", "batch_not_sharded",
                    f"a batch input of {B} examples is read by "
                    f"{op_name(u)}{tuple(u.args[1:4])}, not as this rank's "
                    f"slice [{lo}:{hi}) — per-example work would not be "
                    f"split over the data group", WHERE))
                break

    sync_set = set(sync_nodes(graph, group_name)) - gather_nodes(
        graph, group_name)

    # -- one gradient all-reduce a released leaf ----------------------------
    grad_syncs = set()
    for path, out in zip(graph.out_paths, graph.outvars):
        if _out_index(path) != 0:
            continue
        mine = sync_set & graph.backward_slice([out])
        grad_syncs |= mine
        n = len(mine)
        if n != 1:
            code = "grad_sync_missing" if n == 0 else "grad_sync_repeated"
            findings.append(Finding(
                "error", code,
                f"released parameter {path} passes through {n} sum "
                f"all-reduce(s) over the data group, not exactly one — "
                + ("the replicas drift apart and each updates from its "
                   "own examples only" if n == 0 else
                   "its examples are counted more than once"), WHERE))

    # -- noise: aggregate-level, after the sum, one seed -------------------
    noise = [node for node, p in graph.markers() if p.get("kind") == "noise"]
    for node in noise:
        t = taints.get(node.args[0]) if node.args else None
        if t is not None and t.batch:
            findings.append(Finding(
                "error", "noise_per_example",
                "a noise marker still carries the example axis — noise "
                "must attach to the aggregate, one draw", WHERE))
            break
    if noise and grad_syncs:
        before = graph.backward_slice([s.args[0] for s in grad_syncs])
        if any(node in before for node in noise):
            findings.append(Finding(
                "error", "noise_before_sync",
                f"noise is added before the all-reduce over the data "
                f"group: the released sum holds {d} draws, {d}x the "
                f"variance the accountant charges for", WHERE))
    seeds = [tuple(s) for s in rank_seeds]
    if noise_expected and len(set(seeds)) > 1:
        findings.append(Finding(
            "error", "noise_seed_rank_dependent",
            f"the ranks draw their noise from generators of different "
            f"seeds ({[list(s)[:2] for s in seeds]}): replicas add "
            f"independent noise and diverge", WHERE))

    # -- the divisor is the global batch -----------------------------------
    divs = sorted({x for s in grad_syncs for x in _divisors_after(s)})
    if grad_syncs and B not in divs:
        findings.append(Finding(
            "error", "divisor_not_global",
            f"the all-reduced clipped sum is divided by {divs}, not by "
            f"the global batch {B}", WHERE))

    # -- statistics over the group -----------------------------------------
    for path, out in zip(graph.out_paths, graph.outvars):
        idx, key = _out_index(path), _out_key(path, 1)
        if idx == 2:
            if not sync_set & graph.backward_slice([out]):
                findings.append(Finding(
                    "error", "loss_not_global",
                    "the mean loss is this rank's, not the group's: no "
                    "all-reduce over the data group feeds it", WHERE))
        elif idx == 3 and key in ("per_example_norms", "per_layer_norms"):
            sh = shape(out)
            if (sh and sh[-1] != B) or not sync_set & graph.backward_slice(
                    [out]):
                findings.append(Finding(
                    "error", "budget_stats_local",
                    f"aux {key!r} of shape {tuple(sh)} covers this rank's "
                    f"examples only, not the group's {B}: the clip "
                    f"fraction and the auto budgets' quantiles would differ "
                    f"from rank to rank", WHERE))
    return findings


# ---------------------------------------------------------------------------
# The model half


def _descendants(node, within: set) -> set:
    """Nodes reached from ``node`` through users, inside ``within``."""
    out, stack = set(), [node]
    while stack:
        n = stack.pop()
        for u in n.users:
            if u in within and u not in out:
                out.add(u)
                stack.append(u)
    return out


def _slices_of(node, depth: int = 6) -> list:
    """``(dim, start, end)`` of the ``slice`` ops reached from ``node``
    through at most ``depth`` users."""
    out, frontier, seen = [], [node], set()
    for _ in range(depth):
        nxt = []
        for n in frontier:
            for u in n.users:
                if u in seen:
                    continue
                seen.add(u)
                if op_name(u) == "slice" and len(u.args) >= 4:
                    out.append(tuple(u.args[1:4]))
                nxt.append(u)
        frontier = nxt
    return out


def _partial_grad(node) -> bool:
    """A ``partial_grad`` marker: a partial replicated parameter's
    autograd gradient, which its sum over ``model`` completes."""
    from repro_torch.analysis.markers import is_marker, marker_params
    return (is_marker(node)
            and marker_params(node).get("kind") == "partial_grad")


def check_model(traces: Sequence, *, taints, specs, param_shapes,
                model_size: int,
                noise_expected: bool) -> List[Finding]:
    """The model half over ``traces``: ``(model rank, model group name,
    graph)`` of each traced rank, the first the graph ``taints`` belongs
    to.  ``specs``: the param spec tree; ``param_shapes``: the whole
    params' shapes (:class:`~repro_torch.core.tapper.TensorSpec`)."""
    from repro_torch.analysis.noise import _DRAWS
    from repro_torch.launch.sharding import is_sharded, model_dims
    from repro_torch.tree import get_subtree, leaf_paths
    findings: List[Finding] = []
    rank0, gname, graph = traces[0]
    msums = set(sync_nodes(graph, gname))

    def sliced(key: str) -> bool:
        sub = get_subtree(specs, tuple(key.split("/")))
        if isinstance(sub, dict):
            return any(is_sharded(get_subtree(sub, p))
                       for p in leaf_paths(sub))
        return is_sharded(sub)

    # -- partial norms: one model sum each, replicated ones none -----------
    sinks = [n for n, p in graph.markers() if p.get("kind") == "clip_coef"]
    sinks += [out for path, out in zip(graph.out_paths, graph.outvars)
              if _out_index(path) == 3]
    upstream = graph.backward_slice(sinks)
    reported = set()
    for node, p in graph.markers():
        if p.get("kind") != "group_norm":
            continue
        key = str(p.get("group"))
        n = len(msums & _descendants(node, upstream))
        if sliced(key) and n != 1:
            code = ("model_norm_sum_missing" if n == 0
                    else "model_norm_sum_repeated")
            msg = (f"group {key} is sliced over model, but its partial "
                   f"norm² reaches the clip coefficients through {n} sum "
                   f"all-reduce(s) over the model group, not exactly one "
                   f"— " + ("each rank clips with its own slice's norm"
                            if n == 0 else
                            "the norm is counted more than once"))
        elif not sliced(key) and n:
            code = "model_norm_overcount"
            msg = (f"group {key} is replicated (its norm is whole on every "
                   f"rank) but reaches the clip coefficients through {n} "
                   f"sum all-reduce(s) over the model group: counted "
                   f"{model_size}x")
        else:
            continue
        if (code, key) not in reported:
            reported.add((code, key))
            findings.append(Finding("error", code, msg, WHERE))

    # -- partial replicated leaves: their per-example grad summed once ----
    # before the group's norm; the sums after a group_norm marker are the
    # norm rule's above.
    normed = set()
    for node, p in graph.markers():
        if p.get("kind") == "group_norm":
            normed |= _descendants(node, upstream)
    for node, p in graph.markers():
        if p.get("kind") != "partial_pe" or node not in upstream:
            continue
        key = str(p.get("group"))
        n = len((msums & _descendants(node, upstream)) - normed)
        if n != 1 and ("model_partial_unsummed", key) not in reported:
            reported.add(("model_partial_unsummed", key))
            findings.append(Finding(
                "error", "model_partial_unsummed",
                f"group {key} is replicated but applied to this rank's "
                f"slice: its partial per-example gradient reaches a norm "
                f"through {n} sum all-reduce(s) over the model group, not "
                f"exactly one — " + (
                    "each rank clips with its own slice's share"
                    if n == 0 else "the gradient is counted more than once"),
                WHERE))

    # -- clipped contributions stay local -----------------------------------
    # A contribution has a released leaf's local shape and no example
    # axis (the shape tells it from a one-example activation, B/d = 1).
    leaf_shapes = {shape(out) for path, out in zip(graph.out_paths,
                                                   graph.outvars)
                   if _out_index(path) == 0}
    for path, out in zip(graph.out_paths, graph.outvars):
        if _out_index(path) != 0:
            continue
        bad = [s for s in msums & graph.backward_slice([out])
               if not getattr(taints.get(s.args[0]), "batch", True)
               and shape(s.args[0]) in leaf_shapes
               and not _partial_grad(s.args[0])]
        if bad:
            findings.append(Finding(
                "error", "model_contrib_reduced",
                f"released parameter {path} receives a value without the "
                f"example axis summed over the model group: a clipped "
                f"contribution is reduced over model ({model_size} ranks' "
                f"slices or copies added)", WHERE))
            break

    # -- noise: slices of one full draw, one seed ----------------------------
    if noise_expected:
        paths = leaf_paths(param_shapes)
        seeds = []
        for mr, _, g in traces:
            draws = [n for n in g.nodes if op_name(n) in _DRAWS]
            seeds.append([None if g.generator(n) is None
                          else g.generator(n).initial_seed() for n in draws])
            for node, p in zip(draws, paths):
                full = tuple(get_subtree(param_shapes, p).shape)
                got = tuple(node.meta["val"].shape) if isinstance(
                    node.meta.get("val"), torch.Tensor) else ()
                dims = model_dims(get_subtree(specs, p))
                want = [(dd, mr * full[dd] // model_size,
                         (mr + 1) * full[dd] // model_size) for dd in dims]
                if got != full or not set(want) <= set(_slices_of(node)):
                    findings.append(Finding(
                        "error", "noise_slice_mismatch",
                        f"model rank {mr}: the noise of {'/'.join(p)} is "
                        f"drawn at {got}, not as its slice {want} of one "
                        f"draw at the leaf's full shape {full}: the model "
                        f"ranks' noise is not the single-device noise",
                        WHERE))
                    break
        if len({tuple(x) for x in seeds}) > 1:
            findings.append(Finding(
                "error", "noise_slice_mismatch",
                "the model ranks draw their noise from generators of "
                "different seeds: their slices are not of one draw",
                WHERE))
    return findings


# ---------------------------------------------------------------------------
# The data-slice half (FSDP)


def _leaf_key(path) -> tuple:
    """A released output's param path (its pytree path past the output
    index)."""
    return tuple(_out_key(path, i) for i in range(1, len(path)))


def check_fsdp(traces: Sequence, *, specs, param_shapes, data_size: int,
               noise_expected: bool) -> List[Finding]:
    """The data-slice half over ``traces``: ``(data rank, data group
    name, graph)`` of each traced rank.  ``specs``: the FSDP param spec
    tree; ``param_shapes``: the whole params' shapes."""
    from repro_torch.analysis.noise import _DRAWS
    from repro_torch.launch.sharding import data_dims
    from repro_torch.tree import get_subtree, leaf_paths
    findings: List[Finding] = []
    reported = set()

    def want(dr, p):
        full = tuple(get_subtree(param_shapes, p).shape)
        n = {d: full[d] // data_size
             for d in data_dims(get_subtree(specs, p))}
        return full, [(d, dr * k, (dr + 1) * k) for d, k in n.items()]

    for dr, gname, graph in traces:
        syncs = set(sync_nodes(graph, gname)) - gather_nodes(graph, gname)
        # -- the rank's own slice of each summed leaf ----------------------
        for path, out in zip(graph.out_paths, graph.outvars):
            if _out_index(path) != 0:
                continue
            p = _leaf_key(path)
            _, cuts = want(dr, p)
            if not cuts:
                continue
            within = graph.backward_slice([out])
            kept = {tuple(u.args[1:4]) for s in syncs & within
                    for u in _descendants(s, within)
                    if op_name(u) == "slice" and len(u.args) >= 4}
            mine = syncs & within
            if mine and not set(cuts) <= kept \
                    and ("fsdp_slice_mismatch", p) not in reported:
                reported.add(("fsdp_slice_mismatch", p))
                findings.append(Finding(
                    "error", "fsdp_slice_mismatch",
                    f"data rank {dr}: released parameter {'/'.join(p)} "
                    f"keeps {sorted(kept)} of its sum over the data group, "
                    f"not its own slice {cuts}: a slice would be released "
                    f"by two ranks and another by none", WHERE))
        # -- noise: the rank's slice of one full draw ----------------------
        if not noise_expected:
            continue
        draws = [n for n in graph.nodes if op_name(n) in _DRAWS]
        for node, p in zip(draws, leaf_paths(param_shapes)):
            full, cuts = want(dr, p)
            if not cuts:
                continue
            got = tuple(node.meta["val"].shape) if isinstance(
                node.meta.get("val"), torch.Tensor) else ()
            if got != full or not set(cuts) <= set(_slices_of(node)):
                findings.append(Finding(
                    "error", "noise_slice_mismatch",
                    f"data rank {dr}: the noise of {'/'.join(p)} is drawn "
                    f"at {got}, not as its slice {cuts} of one draw at the "
                    f"leaf's full shape {full}: the data ranks' noise is "
                    f"not the single-device noise", WHERE))
                break
    return findings
