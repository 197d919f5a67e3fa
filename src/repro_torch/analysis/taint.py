"""Per-example taint tracking over the captured private-step graph.

The JAX package's lattice (``repro/analysis/taint.py``) over aten nodes:
for each value, (a) which of its axes carry the *example* dimension
(``batch``), (b) whether a per-example clip coefficient has entered it
multiplicatively (``clipped``: structurally, the ``dp_tag[kind=clip_coef]``
marker on its history), and (c) whether it *is* coefficient-derived
(``weight``).  The port adds (d) ``ex``: the examples whose width-1
slices of the example axis the value came from (the ``naive``
strategy's batch-1 passes).  A ``stack`` or ``cat`` of parts from
different examples puts the example axis back on the axis it builds, so
a sum over the stacked per-example gradients is a reduction like any
other.

The invariant proved is the same: on every path from per-example
quantities to the released parameter and optimizer outputs, a clip
contraction happens *before* any reduction over the example axis.  A
reduction over a batch-tainted axis (``sum`` / ``mean`` over dims, a
contracting ``mm`` / ``bmm`` / ``addmm``, the weight or bias gradient of
``convolution_backward``, ``index_add`` / ``scatter_add`` /
``embedding_dense_backward``, the contribution of ``gram_norm_fused``)
whose operands are neither clipped nor coefficient-derived is recorded as
a violation; the verifier keeps those whose results reach the released
outputs (the mean loss and the clip fractions average over examples
legitimately).

The hand-written kernels are modelled exactly, not by a fallback:
``gram_norm*``, ``pe_conv_grad_*`` and ``flash_*`` keep the example axis
at axis 0 and reduce over no example; ``gram_norm_fused``'s contribution
``Σ_b w_b·x_bᵀδy_b`` reduces over the batch and is clean only when ``w``
carries the clip-coefficient taint.

A tensor written in place (``copy_`` into a slice of a buffer, the
embedding contribution's ``index_add_``) passes the write's taint on to
the buffer it views.  An op with no handler falls back conservatively:
an output that keeps a leading example axis keeps the taint, anything
else with per-example payload counts as a reduction; the op is listed
as an approximation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List

import numpy as np
import torch
from torch.fx import Node

from repro_torch.analysis.graph import (FlatGraph, is_inplace, op_name,
                                        shape, val)
from repro_torch.analysis.markers import marker_params

EMPTY: FrozenSet[int] = frozenset()


@dataclasses.dataclass(frozen=True)
class Taint:
    batch: FrozenSet[int] = EMPTY   # axes carrying the example dim
    clipped: bool = False           # clip coefficient entered the chain
    weight: bool = False            # value is coefficient-derived
    ex: FrozenSet[int] = EMPTY      # width-1 example slices it came from

    @property
    def per_example(self) -> bool:
        return bool(self.batch)

    @property
    def covered(self) -> bool:
        return self.clipped or self.weight


NONE = Taint()


@dataclasses.dataclass
class Violation:
    node: Node
    message: str


@dataclasses.dataclass
class TaintResult:
    taints: Dict
    violations: List[Violation]
    approx: List[str]


# Values that do not depend on any input's values.
_CONST = {"ones_like", "zeros_like", "empty_like", "full_like", "new_zeros",
          "new_ones", "new_empty", "new_full", "zeros", "ones", "empty",
          "full", "arange", "randn", "rand", "randint", "normal",
          "randn_like", "rand_like", "lift_fresh_copy", "scalar_tensor",
          "empty_strided", "eye", "linspace", "zero", "fill"}
_MUL_LIKE = {"mul", "div"}
_ADD_LIKE = {"add", "sub", "rsub", "maximum", "minimum", "clamp",
             "clamp_min", "clamp_max"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
           "var", "std", "var_mean", "norm", "linalg_vector_norm", "argmax",
           "argmin", "any", "all", "count_nonzero", "nansum"}
# Ops that mix values along one ``dim`` axis.
_ALONG_DIM = {"_softmax", "_log_softmax", "cumsum", "cumprod", "sort",
              "cummax", "cummin", "logcumsumexp"}
# Per-example ops with the example axis at axis 0 of input and outputs.
_KEEP0 = {"max_pool2d_with_indices", "avg_pool2d", "adaptive_avg_pool2d",
          "_adaptive_avg_pool2d", "max_pool2d", "upsample_nearest2d",
          "upsample_bilinear2d", "im2col", "col2im", "constant_pad_nd",
          "reflection_pad2d", "replication_pad2d",
          "gram_norm", "gram_norm_tokmask", "pe_conv_grad_1d",
          "pe_conv_grad_2d", "flash_fwd"}


def _rank(node) -> int:
    return len(shape(node))


def _arg(node, i: int, name: str, default=None):
    """Argument ``name`` of an op node: a keyword, else position ``i``."""
    if name in node.kwargs:
        return node.kwargs[name]
    return node.args[i] if len(node.args) > i else default


def _wide(node, axes) -> bool:
    """True if any of ``node``'s ``axes`` holds more than one entry: a
    reduction over an example axis of size 1 (one example's slice) mixes
    no examples."""
    shp = shape(node)
    return any(a >= len(shp) or shp[a] > 1 for a in axes)


def _join(ts: List[Taint], batch=None) -> Taint:
    """Add-like union: clipped only when every per-example part is."""
    pe = [t for t in ts if t.per_example]
    if batch is None:
        batch = frozenset().union(*[t.batch for t in ts]) if ts else EMPTY
    return Taint(batch, bool(pe) and all(t.covered for t in pe),
                 bool(pe) and all(t.weight for t in pe))


def _with_ex(taint, ex):
    """``taint`` (or a tuple of them) with ``ex`` added to each."""
    if isinstance(taint, tuple):
        return tuple(_with_ex(t, ex) for t in taint)
    return dataclasses.replace(taint, ex=taint.ex | ex)


def _dims(d, rank: int):
    if d is None:
        return set(range(rank))
    if isinstance(d, int):
        d = [d]
    d = list(d)
    if not d:
        return set(range(rank))
    return {a % rank for a in d} if rank else set()


class TaintPass:
    def __init__(self, graph: FlatGraph, batch_size: int,
                 microbatches: int = 1, model_groups=()):
        self.graph = graph
        # A sum over a model group adds the model ranks' partial values
        # of the same examples: no reduction over the examples.
        self.model_groups = frozenset(model_groups)
        self.B = batch_size
        # A microbatch's example count: the step's loop runs one at a time.
        self.mb = batch_size // microbatches
        self.sizes = {self.B, self.mb}
        self.violations: List[Violation] = []
        self.approx: List[str] = []
        self.taints: Dict = {}

    # -- entry -------------------------------------------------------------

    def run(self, init: Dict) -> TaintResult:
        self.taints = dict(init)
        for node in self.graph.nodes:
            self._step(node)
        return TaintResult(self.taints, self.violations, self.approx)

    # -- helpers -----------------------------------------------------------

    def t(self, x) -> Taint:
        """The taint of an argument (a node, a list of nodes, a constant)."""
        if isinstance(x, Node):
            v = self.taints.get(x, NONE)
            return v if isinstance(v, Taint) else _with_ex(
                _join(list(v)), frozenset().union(*[t.ex for t in v]))
        if isinstance(x, (list, tuple)):
            ts = [self.t(a) for a in x]
            return _with_ex(_join(ts), frozenset().union(
                *[t.ex for t in ts]))
        return NONE

    def _violate(self, node: Node, msg: str):
        self.violations.append(Violation(node, msg))

    def _reduce_event(self, node: Node, ins: List[Taint], what: str):
        if not any(t.covered for t in ins):
            self._violate(node,
                          f"batch-axis reduction in `{op_name(node)}` "
                          f"({what}) with no clip contraction on any "
                          f"operand")

    def _set(self, node: Node, taint):
        self.taints[node] = taint

    def _aligned(self, x, out_rank: int) -> Taint:
        """``x``'s taint with its axes right-aligned to ``out_rank``
        (broadcasting)."""
        t = self.t(x)
        if not isinstance(x, Node):
            return t
        shift = out_rank - _rank(x)
        return dataclasses.replace(t, batch=frozenset(
            a + shift for a in t.batch if a + shift >= 0))

    def _tensor_args(self, node: Node) -> List:
        out = []
        for a in list(node.args) + list(node.kwargs.values()):
            for x in (a if isinstance(a, (list, tuple)) else [a]):
                if isinstance(x, Node) and isinstance(val(x), torch.Tensor):
                    out.append(x)
        return out

    # -- per-node transfer -------------------------------------------------

    def _step(self, node: Node):
        name = op_name(node)
        base = name[:-1] if is_inplace(node) else name
        args = self._tensor_args(node)
        ins = [self.t(a) for a in args]
        ex = frozenset().union(*[t.ex for t in ins])
        if name == "getitem":
            self._h_getitem(node)
        elif base in _CONST:
            self._set(node, NONE)
        elif not any(t.per_example or t.covered for t in ins) \
                and base not in ("dp_tag", "stack", "cat", "all_reduce"):
            self._set(node, Taint(ex=ex))
        else:
            handler = getattr(self, f"_h_{base}", None)
            if handler is not None:
                handler(node)
            elif base in _MUL_LIKE:
                self._elementwise(node, "mul")
            elif base in _ADD_LIKE:
                self._elementwise(node, "add")
            elif base in _REDUCE:
                self._reduce(node)
            elif base in _ALONG_DIM:
                self._along_dim(node)
            elif base in _KEEP0:
                self._keep0(node)
            elif base.endswith("_backward") or base.endswith(
                    "_backward_data"):
                self._elementwise(node, "linear0")
            elif all(shape(a) == shape(node) for a, t in zip(args, ins)
                     if t.per_example or t.covered) \
                    and isinstance(val(node), torch.Tensor):
                self._elementwise(node, "pass")
            else:
                self._fallback(node, args, ins)
            if ex and base not in ("stack", "cat", "slice"):
                self._set(node, _with_ex(self.taints[node], ex))
        if is_inplace(node):
            self._write(node.args[0], self.t(node))

    def _elementwise(self, node: Node, kind: str):
        args = self._tensor_args(node)
        r = _rank(node)
        ins = [self._aligned(a, r) for a in args]
        pe = [t for t in ins if t.per_example]
        batch = frozenset().union(*[t.batch for t in ins]) if ins else EMPTY
        if kind == "mul":
            clipped = any(t.covered for t in ins) and bool(pe)
        elif kind == "linear0":
            clipped = bool(pe) and ins[0].covered
        elif kind == "pass" and len(pe) == 1:
            clipped = pe[0].clipped
        else:
            clipped = bool(pe) and all(t.covered for t in pe)
        weight = bool(pe) and all(t.weight for t in pe)
        self._set(node, Taint(batch, clipped, weight))

    def _fallback(self, node: Node, args, ins: List[Taint]):
        """Unmodeled shape-changing op: an output that keeps a leading
        example axis keeps the taint there; otherwise treat it as a
        (possibly covered) batch reduction."""
        clipped = any(t.clipped for t in ins)
        weight = all(t.weight for t in ins if t.per_example) \
            and any(t.per_example for t in ins)
        payload = [t for t in ins if t.per_example and not t.weight]
        self.approx.append(op_name(node))
        keeps0 = any(0 in t.batch for t in ins)
        outs = val(node)
        multi = isinstance(outs, (tuple, list))
        res = []
        for o in (outs if multi else [outs]):
            shp = tuple(o.shape) if isinstance(o, torch.Tensor) else ()
            if shp and shp[0] in self.sizes and keeps0:
                res.append(Taint(frozenset({0}), clipped, weight))
            elif payload:
                self._reduce_event(node, ins, f"unmodeled `{op_name(node)}`")
                res.append(Taint(EMPTY, any(t.covered for t in ins), False))
            else:
                res.append(Taint(EMPTY, clipped, weight))
        self._set(node, tuple(res) if multi else res[0])

    def _write(self, dst: Node, t: Taint):
        """An in-place write of ``t`` into ``dst``: the base tensor ``dst``
        views takes the union of what it held and the write (the write's
        axes mapped back through the views)."""
        node = dst
        batch = set(t.batch)
        while node is not self.graph.base(node):
            batch = self._unview(node, batch)
            node = node.args[0]
        old = self.t(node)
        new = _join([old, Taint(frozenset(batch), t.clipped, t.weight)])
        if not old.per_example and not batch:
            new = Taint(EMPTY, old.clipped or t.clipped,
                        old.weight or t.weight)
        self._set(node, _with_ex(new, old.ex | t.ex))
        if node is not dst:
            self._set(dst, t)

    def _unview(self, view: Node, batch) -> set:
        """Axes of ``view`` mapped to the axes of its input."""
        name = op_name(view)
        src = view.args[0]
        if name == "getitem":
            if op_name(src) == "unbind":
                d = _arg(src, 1, "dim", 0) % _rank(src.args[0])
                return {a + (a >= d) for a in batch}
            return set(batch)
        if name == "select":
            d = view.args[1] % _rank(src)
            return {a + (a >= d) for a in batch}
        if name == "permute":
            perm = [p % _rank(src) for p in view.args[1]]
            return {perm[a] for a in batch}
        if name in ("t", "transpose"):
            d0, d1 = ((0, 1) if name == "t"
                      else (view.args[1] % _rank(src),
                            view.args[2] % _rank(src)))
            return {d1 if a == d0 else d0 if a == d1 else a for a in batch}
        if name == "unsqueeze":
            d = view.args[1] % _rank(view)
            return {a - (a > d) for a in batch if a != d}
        if name in ("slice", "alias", "detach", "split", "unbind"):
            return set(batch)
        out = set()
        for a in batch:
            out.update(_reshape_axis_map(shape(view), shape(src), a))
        return out

    # -- structured handlers ----------------------------------------------

    def _h_dp_tag(self, node: Node):
        t = self.t(node.args[0])
        if marker_params(node).get("kind") == "clip_coef":
            # The structural clip recognition: downstream of this marker,
            # multiplying by the coefficients IS the clip contraction.
            t = dataclasses.replace(t, weight=True)
        self._set(node, t)

    def _h_getitem(self, node: Node):
        v = self.taints.get(node.args[0], NONE)
        self._set(node, v[node.args[1]] if isinstance(v, tuple) else v)

    def _h_expand(self, node: Node):
        self._set(node, self._aligned(node.args[0], _rank(node)))

    def _h_permute(self, node: Node):
        t = self.t(node.args[0])
        r = _rank(node)
        perm = [p % r for p in node.args[1]] if r else []
        self._set(node, dataclasses.replace(t, batch=frozenset(
            j for j, a in enumerate(perm) if a in t.batch)))

    def _h_t(self, node: Node):
        t = self.t(node.args[0])
        if _rank(node) == 2:
            t = dataclasses.replace(t, batch=frozenset(1 - a
                                                      for a in t.batch))
        self._set(node, t)

    def _h_transpose(self, node: Node):
        t = self.t(node.args[0])
        r = _rank(node)
        d0, d1 = node.args[1] % r, node.args[2] % r
        self._set(node, dataclasses.replace(t, batch=frozenset(
            d1 if a == d0 else d0 if a == d1 else a for a in t.batch)))

    def _h_unsqueeze(self, node: Node):
        t = self.t(node.args[0])
        d = node.args[1] % _rank(node)
        self._set(node, dataclasses.replace(t, batch=frozenset(
            a + (a >= d) for a in t.batch)))

    def _removed_axes(self, node: Node, removed) -> Taint:
        """Taint after dropping the input axes ``removed``.  Dropping the
        example axis (a selection of one example) is no sum: the result
        loses the axis and keeps its flags."""
        t = self.t(node.args[0])
        return dataclasses.replace(t, batch=frozenset(
            a - sum(1 for r in removed if r < a)
            for a in t.batch if a not in removed))

    def _h_squeeze(self, node: Node):
        src = node.args[0]
        in_shape = shape(src)
        dims = _dims(_arg(node, 1, "dim"), len(in_shape))
        removed = {d for d in dims if in_shape[d] == 1}
        self._set(node, self._removed_axes(node, removed))

    def _h_select(self, node: Node):
        d = node.args[1] % _rank(node.args[0])
        self._set(node, self._removed_axes(node, {d}))

    def _h_unbind(self, node: Node):
        d = _arg(node, 1, "dim", 0) % _rank(node.args[0])
        t = self._removed_axes(node, {d})
        self._set(node, tuple(t for _ in val(node)))

    def _h_split(self, node: Node):
        self._set(node, tuple(self.t(node.args[0]) for _ in val(node)))


    def _h_view(self, node: Node):
        t = self.t(node.args[0])
        in_shape, out_shape = shape(node.args[0]), shape(node)
        batch = set()
        for a in t.batch:
            split_all = a < len(in_shape) and in_shape[a] == self.B
            batch.update(_reshape_axis_map(in_shape, out_shape, a,
                                           split_all=split_all))
        self._set(node, dataclasses.replace(t, batch=frozenset(batch)))

    _h__unsafe_view = _h_view

    def _gather_examples(self, parts: List[Taint], d: int) -> Taint:
        """The join of ``parts`` put together along axis ``d``: parts
        sliced from different examples make ``d`` an example axis."""
        exs = {p.ex for p in parts if p.ex}
        out = _join(parts)
        if len(exs) > 1:
            return dataclasses.replace(out, batch=out.batch | {d})
        return _with_ex(out, frozenset().union(*exs))

    def _h_cat(self, node: Node):
        d = _arg(node, 1, "dim", 0) % max(_rank(node), 1)
        self._set(node, self._gather_examples(
            [self.t(a) for a in node.args[0]], d))

    def _h_stack(self, node: Node):
        d = _arg(node, 1, "dim", 0) % _rank(node)
        parts = [self.t(a) for a in node.args[0]]
        parts = [dataclasses.replace(p, batch=frozenset(
            a + (a >= d) for a in p.batch)) for p in parts]
        self._set(node, self._gather_examples(parts, d))

    def _h_where(self, node: Node):
        r = _rank(node)
        cond = self._aligned(node.args[0], r)
        vals = [self._aligned(a, r) for a in node.args[1:3]]
        pev = [t for t in vals if t.per_example]
        self._set(node, Taint(
            frozenset().union(cond.batch, *[t.batch for t in vals]),
            bool(pev) and all(t.covered for t in pev),
            bool(pev) and all(t.weight for t in pev)))

    def _h_select_backward(self, node: Node):
        tg = self.t(node.args[0])
        d = node.args[2] % _rank(node)
        self._set(node, Taint(frozenset(a + (a >= d) for a in tg.batch),
                              tg.covered, False))

    def _h_copy(self, node: Node):
        self._set(node, self._aligned(node.args[1], _rank(node)))

    def _h_slice(self, node: Node):
        """A width-1 slice of a wide example axis is one example's: the
        value records its offset (``ex``)."""
        src = node.args[0]
        t = self.t(src)
        d = _arg(node, 1, "dim", 0) % max(_rank(src), 1)
        if d in t.batch and _wide(src, {d}) and shape(node)[d] == 1:
            start = _arg(node, 2, "start", 0) or 0
            t = dataclasses.replace(t, ex=frozenset({start % shape(src)[d]}))
        self._set(node, t)

    def _h_alias(self, node: Node):
        self._set(node, self.t(node.args[0]))

    _h_detach = _h_alias

    def _h_all_reduce(self, node: Node):
        """A sum over the data group adds the ranks' values position by
        position: the zero-padded per-example slices of
        ``clipping.gather_examples`` stay per example, an aggregate stays
        an aggregate.  An aggregate of one rank's single example (``ex``:
        a batch slice of width 1) is summed with the other ranks'
        examples here, so it must be clipped already.  A sum over a model
        group (``model_groups``) adds partial values of the same
        examples and passes the taint on."""
        t = self.t(node.args[0])
        src = node if op_name(node) == "all_reduce" else node.args[0]
        model = (isinstance(src, Node) and op_name(src) == "all_reduce"
                 and len(src.args) > 2
                 and str(src.args[2]) in self.model_groups)
        if not model and not t.batch and t.ex:
            self._reduce_event(node, [t], "sum over the data group's "
                                          "examples")
        self._set(node, t)

    _h_wait_tensor = _h_all_reduce

    def _keep0(self, node: Node):
        ins = [self.t(a) for a in self._tensor_args(node)]
        pe = any(0 in t.batch for t in ins)
        t = Taint(frozenset({0}) if pe else EMPTY,
                  any(t.clipped for t in ins), False)
        outs = val(node)
        self._set(node, tuple(t for _ in outs)
                  if isinstance(outs, (tuple, list)) else t)

    # -- reductions --------------------------------------------------------

    def _reduce(self, node: Node):
        src = node.args[0]
        t = self.t(src)
        r = _rank(src)
        dim_at = 2 if op_name(node) == "linalg_vector_norm" else 1
        dims = _dims(_arg(node, dim_at, "dim"), r)
        keep = bool(_arg(node, dim_at + 1, "keepdim", False))
        reduced = bool(t.batch & dims)
        if _wide(src, t.batch & dims) and not t.covered:
            self._reduce_event(node, [t], "reduce over the example axis")
        if keep:
            batch = frozenset(a for a in t.batch if a not in dims)
        else:
            batch = frozenset(a - sum(1 for d in dims if d < a)
                              for a in t.batch if a not in dims)
        out = Taint(batch, t.clipped or (reduced and t.covered),
                    t.weight and not reduced)
        outs = val(node)
        self._set(node, tuple(out for _ in outs)
                  if isinstance(outs, (tuple, list)) else out)

    def _along_dim(self, node: Node):
        t = self.t(node.args[0])
        d = _arg(node, 1, "dim", -1) % max(_rank(node.args[0]), 1)
        if d in t.batch and not t.covered:
            self._violate(node, f"`{op_name(node)}` runs *across* "
                                f"examples")
        outs = val(node)
        self._set(node, tuple(t for _ in outs)
                  if isinstance(outs, (tuple, list)) else t)

    # -- contractions ------------------------------------------------------

    def _contract(self, node: Node, operands, extra=()):
        """``operands``: (arg, contracted axes, {input axis: output axis})
        per operand; ``extra``: args added elementwise to the product."""
        ins = [self.t(a) for a, _, _ in operands]
        covered = any(t.covered for t in ins)
        out_batch = set()
        for (a, contract, amap), t in zip(operands, ins):
            if _wide(a, t.batch & set(contract)) and not covered:
                self._reduce_event(node, ins, f"`{op_name(node)}` "
                                   f"contracts the example axis")
            out_batch.update(amap[x] for x in t.batch if x in amap)
        pe = [t for t in ins if t.per_example]
        prod = Taint(frozenset(out_batch), covered and bool(pe),
                     bool(pe) and all(t.weight for t in pe))
        if extra:
            r = _rank(node)
            prod = _join([prod] + [self._aligned(e, r) for e in extra])
        self._set(node, prod)

    def _h_mm(self, node: Node):
        a, b = node.args[:2]
        self._contract(node, [(a, {1}, {0: 0}), (b, {0}, {1: 1})])

    def _h_bmm(self, node: Node):
        a, b = node.args[:2]
        self._contract(node, [(a, {2}, {0: 0, 1: 1}),
                              (b, {1}, {0: 0, 2: 2})])

    def _h_addmm(self, node: Node):
        c, a, b = node.args[:3]
        self._contract(node, [(a, {1}, {0: 0}), (b, {0}, {1: 1})],
                       extra=[c])

    # -- convolutions ------------------------------------------------------

    def _h_convolution(self, node: Node):
        x, w = node.args[:2]
        tx, tw = self.t(x), self.t(w)
        groups = _arg(node, 8, "groups", 1)
        if tx.batch <= {0} and not tw.per_example:
            # Forward / data-grad conv: the example axis passes through.
            self._set(node, Taint(tx.batch, tx.clipped, False))
            return
        if tx.batch == {1} and tw.batch == {0} and groups > 1 \
                and groups % self.mb == 0:
            # The per-example group trick (Algorithm 2): each group sees
            # one example, so the output keeps it on its feature axis.
            self._set(node, Taint(frozenset({1}),
                                  tx.covered or tw.covered, False))
            return
        self._reduce_event(node, [tx, tw],
                           "conv weight-gradient contraction")
        self._set(node, Taint(EMPTY, tx.covered or tw.covered, False))

    def _h_convolution_backward(self, node: Node):
        go, x, w = node.args[:3]
        tg, tx, tw = self.t(go), self.t(x), self.t(w)
        cov = tg.covered or tx.covered
        groups = _arg(node, 9, "groups", 1)
        if groups > 1 and groups % self.mb == 0 \
                and tg.batch | tx.batch == {1}:
            # The group trick in reverse (``multi``'s vmap of a conv):
            # the examples sit on the channel axis, one group each, and
            # the weight gradient keeps them on its output-channel axis.
            self._set(node, (Taint(frozenset({1}), tg.covered, False),
                             Taint(frozenset({0}), cov, False),
                             Taint(frozenset({0}), cov, False)))
            return
        grad_in = Taint(tg.batch | tx.batch if tg.per_example else EMPTY,
                        tg.covered, False)
        mask = _arg(node, 10, "output_mask", [True] * 3)
        if (mask[1] or mask[2]) and not cov and (
                _wide(go, tg.batch) or _wide(x, tx.batch)):
            self._reduce_event(node, [tg, tx],
                               "conv weight / bias gradient over examples")
        reduced = Taint(EMPTY, cov and (tg.per_example or tx.per_example),
                        False)
        self._set(node, (grad_in, reduced, reduced))

    # -- scatters and embedding backward -----------------------------------

    def _scatter(self, node: Node, dim: int, src: Node, index=None):
        tself, tsrc = self.t(node.args[0]), self.t(src)
        tidx = self.t(index) if index is not None else NONE
        d = dim % max(_rank(src), 1)
        if _wide(src, tsrc.batch & {d}) and not tsrc.covered:
            self._reduce_event(node, [tsrc], "scatter-add over examples")
        batch = tself.batch | (tsrc.batch - {d}) | (tidx.batch - {d})
        pe = [t for t in (tself, tsrc) if t.per_example]
        self._set(node, Taint(frozenset(batch),
                              (d in tsrc.batch and tsrc.covered)
                              or (bool(pe) and all(t.covered for t in pe)),
                              False))

    def _h_scatter_add(self, node: Node):
        self._scatter(node, node.args[1], node.args[3], node.args[2])


    def _h_index_add(self, node: Node):
        self._scatter(node, node.args[1], node.args[3], node.args[2])

    def _example_iota(self, node):
        """The length n when ``node`` is ``arange(n)`` under views, n a
        batch's or a microbatch's example count (an index that sends
        example b to row b), else None."""
        while isinstance(node, Node) and op_name(node) in (
                "unsqueeze", "view", "expand", "_to_copy", "reshape",
                "alias", "clone"):
            node = node.args[0]
        if isinstance(node, Node) and op_name(node) == "arange" \
                and len(shape(node)) == 1 and shape(node)[0] in self.sizes:
            return shape(node)[0]
        return None

    def _h_index_put(self, node: Node):
        tself, tv = self.t(node.args[0]), self.t(node.args[2])
        if node.args[1] and shape(node.args[0])[:1] == (
                self._example_iota(node.args[1][0]),):
            # A write indexed by the example on axis 0 (``multi``'s
            # per-example embedding gradient): nothing crosses examples.
            self._set(node, _join([tself, Taint(frozenset({0}),
                                                 tv.clipped, False)]))
            return
        # Values right-align to (broadcast index shape, self's rest): the
        # axes on the index part scatter into the indexed rows.
        k = max((_rank(i) for i in node.args[1] if i is not None),
                default=0)
        shift = k + _rank(node.args[0]) - len(node.args[1]) \
            - _rank(node.args[2])
        lead = {a for a in tv.batch if a + shift < k}
        if _wide(node.args[2], lead) and not tv.covered:
            self._reduce_event(node, [tv], "index_put over examples")
        self._set(node, _join([tself, Taint(EMPTY, tv.covered, False)]))

    def _h_embedding_dense_backward(self, node: Node):
        tg = self.t(node.args[0])
        if _wide(node.args[0], tg.batch) and not tg.covered:
            self._reduce_event(node, [tg], "embedding gradient over examples")
        self._set(node, Taint(EMPTY, tg.covered, False))

    def _h_gather(self, node: Node):
        src, d, index = node.args[:3]
        ts, ti = self.t(src), self.t(index)
        d %= max(_rank(src), 1)
        if d in ts.batch:
            # Gathering across examples only selects; no sum happens.
            self._set(node, Taint(ti.batch, ts.clipped, False))
            return
        self._set(node, Taint(ts.batch | ti.batch, ts.clipped, ts.weight))

    def _h_index(self, node: Node):
        """``table[ids]`` with the indices on the leading axes."""
        src, indices = node.args[:2]
        ts = self.t(src)
        idx = [i for i in indices if i is not None]
        n = len(indices)
        if len(idx) != n:
            self._fallback(node, self._tensor_args(node),
                           [self.t(a) for a in self._tensor_args(node)])
            return
        k = max((_rank(i) for i in idx), default=0)
        batch = set()
        for i in idx:
            ti = self.t(i)
            batch.update(a + k - _rank(i) for a in ti.batch)
        batch.update(a - n + k for a in ts.batch if a >= n)
        self._set(node, Taint(frozenset(batch), ts.clipped, ts.weight))

    # -- the port's kernels ------------------------------------------------

    def _h_gram_norm_fused(self, node: Node):
        x, dy, w = node.args[:3]
        tx, ty, tw = self.t(x), self.t(dy), self.t(w)
        norms = Taint(frozenset({0}) if (tx.per_example or ty.per_example)
                      else EMPTY, False, False)
        if (tx.per_example or ty.per_example) and not tw.covered:
            self._violate(node, "batch-axis reduction in `gram_norm_fused` "
                                "(its contribution Σ_b w_b·x_bᵀδy_b) with "
                                "weights that are no clip coefficients")
        contrib = Taint(EMPTY, tw.covered, False)
        self._set(node, (norms, contrib, contrib))

    def _h_flash_dq(self, node: Node):
        ins = [self.t(a) for a in node.args[:6]]
        pe = any(t.per_example for t in ins)
        self._set(node, Taint(frozenset({0}) if pe else EMPTY,
                              ins[3].covered, False))

    def _h_flash_dkv(self, node: Node):
        self._h_flash_dq(node)
        t = self.taints[node]
        self._set(node, (t, t))


def _reshape_axis_map(in_shape, out_shape, axis,
                      split_all: bool = False) -> List[int]:
    """Output axes a tainted input axis lands on under a row-major
    reshape (the JAX package's rule).  Merges taint the merged axis;
    splits taint only the outermost factor — the example axis stays the
    slowest-varying one in a flatten like (B·g,) → (B, g) — EXCEPT when
    the split axis is the example axis itself (``split_all``, the
    microbatch reshape (B,) → (m, B/m)): then every factor indexes
    examples and all split axes are tainted."""
    def spans(shape):
        out, period = [], int(np.prod(shape)) if shape else 1
        for d in shape:
            block = period // max(d, 1)
            out.append((block, period))
            period = block
        return out

    in_spans, out_spans = spans(in_shape), spans(out_shape)
    if axis >= len(in_spans):
        return []
    blk_i, per_i = in_spans[axis]
    hits = [j for j, (blk_j, per_j) in enumerate(out_spans)
            if not (per_j <= blk_i or blk_j >= per_i)]
    if len(hits) > 1:
        if split_all:
            return hits
        exact = [j for j in hits if out_spans[j] == in_spans[axis]]
        if exact:
            return exact[:1]
        return hits[:1]  # split: outermost factor only
    return hits
