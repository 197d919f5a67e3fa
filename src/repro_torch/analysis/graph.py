"""Capture and flatten the private step for the static DP verifier.

:func:`capture` records a function with ``make_fx`` on fake tensors: the
Python runs once, every tensor operation it dispatches lands in one FX
graph as an aten node, and nothing executes (no kernel launches, no
device memory).  ``torch.autograd.grad`` traces into its backward's
aten ops; the port's scans and microbatch loops are Python loops and
unroll; ``torch.utils.checkpoint`` under ``remat`` inlines its
recompute; each hand-written kernel (``repro_torch::<name>``) and each
marker (``repro_torch::dp_tag``) stays one node.  A ``torch.Generator``
is no argument an FX graph can hold on every torch version, so while
recording, a draw's generator is taken off the call and kept on its
node instead (``node.meta["generator"]``, :meth:`FlatGraph.generator`):
the draw a step makes from the default generator has none.

So the graph is already flat, unlike the JAX package's jaxpr with its
nested calls and scan bodies (``repro/analysis/graph.py``).
:class:`FlatGraph` gives the passes what that module gives them:
ordered nodes with resolved inputs, the graph's inputs and outputs, the
markers, op counts and a backward slice.  A node's op name is its
overload packet's (``"mm"``, ``"copy_"``, ``"gram_norm_fused"``;
``"getitem"`` for one output of a multi-output node).
"""
from __future__ import annotations

import collections
import operator
from typing import Dict, Iterable, List, Set, Tuple

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from repro_torch.analysis.markers import is_marker, marker_params

KERNEL_NS = "repro_torch"

# Ops whose output depends on an input's shape and dtype only.
SHAPE_ONLY = {"ones_like", "zeros_like", "empty_like", "full_like",
              "new_zeros", "new_ones", "new_empty", "new_full", "randn_like",
              "rand_like", "sym_size"}

# Ops whose output is a view of their first input: an in-place op on the
# view writes the base.
VIEW_OPS = {"view", "select", "slice", "permute", "t", "transpose",
            "unsqueeze", "squeeze", "expand", "alias", "detach", "diagonal",
            "as_strided", "unfold", "split", "unbind", "getitem"}


def op_name(node) -> str:
    """``"getitem"``, or the overload packet's name of an op node."""
    if node.target is operator.getitem:
        return "getitem"
    return getattr(node.target, "_opname", str(node.target))


def is_kernel(node) -> bool:
    """True for a hand-written kernel's op node (``repro_torch::*`` other
    than the marker)."""
    return (node.op == "call_function"
            and getattr(node.target, "namespace", "") == KERNEL_NS
            and not is_marker(node))


def is_inplace(node) -> bool:
    """An aten op that writes its first argument (``copy_``,
    ``scatter_add_``, ...)."""
    name = op_name(node)
    return (node.op == "call_function" and name.endswith("_")
            and not name.startswith("_") and bool(node.args)
            and isinstance(node.args[0], torch.fx.Node))


def val(node):
    """The fake value(s) a node produced (a tensor, a tuple, a scalar)."""
    return node.meta.get("val")


def shape(node) -> Tuple[int, ...]:
    v = val(node) if isinstance(node, torch.fx.Node) else None
    return tuple(v.shape) if isinstance(v, torch.Tensor) else ()


def dtype(node):
    v = val(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


class FlatGraph:
    """The flattened view of one captured ``GraphModule``."""

    def __init__(self, gm: torch.fx.GraphModule, out_spec=None):
        self.gm = gm
        self.invars: List = []
        self.nodes: List = []
        out = None
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                self.invars.append(node)
            elif node.op == "call_function":
                self.nodes.append(node)
            elif node.op == "output":
                out = node.args[0]
        if out_spec is not None:
            # The traced function's outputs, recorded flat: give each its
            # path in the function's own output structure.
            out = pytree.tree_unflatten(list(out), out_spec)
        leaves = pytree.tree_flatten_with_path(out)[0]
        self.out_paths = [path for path, _ in leaves]
        self.outvars = [leaf for _, leaf in leaves]
        # In-place writers of each base tensor, in graph order.
        self.writers: Dict = collections.defaultdict(list)
        for node in self.nodes:
            if is_inplace(node):
                self.writers[self.base(node.args[0])].append(node)

    # -- queries -----------------------------------------------------------

    def generator(self, node):
        """The ``torch.Generator`` a draw node took (``None``: the default
        generator)."""
        return node.meta.get("generator")

    def base(self, node):
        """The tensor ``node`` is a view of (itself if it is none)."""
        while node.op == "call_function" and op_name(node) in VIEW_OPS \
                and node.args and isinstance(node.args[0], torch.fx.Node):
            node = node.args[0]
        return node

    def markers(self) -> List[Tuple[object, dict]]:
        """All ``dp_tag`` nodes with their params, in graph order."""
        return [(n, marker_params(n)) for n in self.nodes if is_marker(n)]

    def kernel_counts(self) -> Dict[str, int]:
        """Nodes per hand-written kernel op."""
        return dict(collections.Counter(op_name(n) for n in self.nodes
                                        if is_kernel(n)))

    def backward_slice(self, targets: Iterable) -> Set:
        """Every node whose value (transitively) feeds ``targets``.  An
        input that only lends its shape (``ones_like``, ...) is no
        dependence; a tensor written in place depends on its writers."""
        seen: Set = set()
        stack = [t for t in targets if isinstance(t, torch.fx.Node)]
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            if v.op != "call_function":
                continue
            stack.extend(self.writers.get(self.base(v), ()))
            if op_name(v) in SHAPE_ONLY:
                continue
            stack.extend(i for i in v.all_input_nodes if i not in seen)
        return seen


class _GeneratorNotes(TorchFunctionMode):
    """Takes the ``generator=`` off each call that passes one and notes it
    on the nodes the call records."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        gen = kwargs.pop("generator", None)
        mode = get_proxy_mode()
        if not isinstance(gen, torch.Generator) or mode is None:
            if gen is not None:
                kwargs["generator"] = gen
            return func(*args, **kwargs)
        n = len(mode.tracer.graph.nodes)
        out = func(*args, **kwargs)
        for node in list(mode.tracer.graph.nodes)[n:]:
            node.meta["generator"] = gen
        return out


def capture(fn, *args) -> FlatGraph:
    """Record ``fn(*args)`` on fake tensors.  ``args`` hold fake tensors
    (``make_fx`` takes up their fake mode): tensors of the device the
    step runs on, so the graph holds the ops that device would run."""
    spec = {}

    def noted(*a):
        with _GeneratorNotes():
            leaves, spec["out"] = pytree.tree_flatten(fn(*a))
            return leaves
    gm = make_fx(noted, tracing_mode="fake")(*args)
    return FlatGraph(gm, out_spec=spec["out"])


def census(graph: FlatGraph) -> dict:
    """What the traced step holds, as the reports and tests compare it:
    nodes; kernel nodes by op; noise draws (``noise`` markers); the clip
    modes of the ``clip_coef`` markers; ``group_norm`` markers by
    ``group|method``; the methods of the ``realization`` markers by layer
    path (a stack realized one layer at a time marks its path once a
    layer); the paths of the ``fused_impl`` markers."""
    out = {"nodes": len(graph.gm.graph.nodes),
           "kernels": graph.kernel_counts(), "noise": 0, "clip_coef": [],
           "group_norm": collections.Counter(), "realization": {},
           "fused_impl": set()}
    for _, p in graph.markers():
        kind = p.get("kind")
        if kind == "noise":
            out["noise"] += 1
        elif kind == "clip_coef":
            out["clip_coef"].append(p.get("mode"))
        elif kind == "group_norm":
            out["group_norm"][f"{p.get('group')}|{p.get('method')}"] += 1
        elif kind == "realization":
            out["realization"].setdefault(p.get("path"), set()).add(
                p.get("method"))
        elif kind == "fused_impl":
            out["fused_impl"].add(p.get("path"))
    out["clip_coef"] = sorted(out["clip_coef"])
    out["group_norm"] = dict(out["group_norm"])
    out["realization"] = {k: sorted(v) for k, v in
                          sorted(out["realization"].items())}
    out["fused_impl"] = sorted(out["fused_impl"])
    return out
