"""Tap/capture engine for per-example gradient reconstruction.

The chain-rule-based (``crb``) strategy of Rochette et al. (2019) — and
the ghost / book-keeping extensions built on top of it — need, for every
parametric layer, two tensors per example:

  * the layer *input*  ``x_b``   (captured on the forward pass), and
  * the layer *output cotangent* ``δy_b = ∂L_b/∂y_b``.

The JAX package adds a zero-valued "tap" to every layer output and
differentiates ``Σ_b L_b`` with respect to the taps.  Eager PyTorch can
differentiate with respect to the layer outputs themselves, so the
capture forward marks each output as a differentiation target (an output
that does not require grad yet becomes a leaf that does) and one
``torch.autograd.grad(losses.sum(), outputs)`` yields every ``δy_b``
(examples are independent, so ``∂(Σ_b L_b)/∂y[b] = ∂L_b/∂y[b]``).  No
zero tensor is allocated or added.

The shape-only ``probe`` the planner consumes runs the model on
``device="meta"`` tensors: it records every layer's metadata, capture
shapes and output shapes, and touches no data and no device.

:func:`scan_with_taps` runs a stack of layers (params with a leading L
axis) as a Python loop, one layer at a time; each layer's captures and
outputs come out stacked with a leading L axis, and their metas get
``scanned + 1``, as ``lax.scan`` gives them in the JAX package.  The
stacks are formed after the backward pass, one tap at a time, so the
forward never holds a capture twice (a layer's capture is the tensor its
backward saves anyway) and captures that are one tensor in the model
(the input of ``wq``/``wk``/``wv``) stay one stacked tensor.

Shared parameters (tied embeddings, Zamba2's shared attention block,
which :func:`scan_with_taps` hands every step as ``shared_params``) are
declared by prefixing the tap name with ``"~"``: the parameter path is
then read from the params root and the layer is marked ``shared``.
:meth:`Tapper.dense_segmented` taps dispatched slots (MoE experts) whose
captures carry each slot's example id.  :meth:`Tapper.local_vjp` taps a
generic layer ``fn(params_sub, *inputs)`` (the parameters inside an SSM
recurrence): its capture ``"inputs"`` is a tuple of tensors, which the
stacking, the probe's specs and the planner take element by element.

An attention block tapped as one ``"attn"`` layer (``dp_attn``) captures
only its input and carries its rebuild closure in ``LayerMeta.fn``; the
kind runs the block again under an inner capture-mode ``Tapper``, a
layer-local recompute that ticks no :data:`STATS` counter (the census
stays one forward and one backward a step).

Models stay pure: a ``Tapper`` in mode ``"none"`` is a no-op, so the same
model code serves ordinary training and every PEG strategy.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# Pipeline instrumentation
#
# Counts Python-level executions of the expensive phases: model forwards
# and backward passes through the model.  PyTorch runs eagerly, so every
# tick is a real execution.


class PipelineStats:
    """Counters for forwards / backwards / probes through a model.

    ``fused`` additionally counts fused norm+contrib realizations
    (``gram_norm_fused`` single passes picked by stale-coefficient plans)
    and ``recomputes`` the layers a ``remat`` backward ran again; both
    stay out of :meth:`snapshot`, which counts passes through the
    model."""

    __slots__ = ("forwards", "backwards", "probes", "fused", "recomputes")

    def __init__(self):
        self.reset()

    def reset(self):
        self.forwards = 0
        self.backwards = 0
        self.probes = 0
        self.fused = 0
        self.recomputes = 0

    def snapshot(self) -> dict:
        return {"forwards": self.forwards, "backwards": self.backwards,
                "probes": self.probes}


STATS = PipelineStats()

# ---------------------------------------------------------------------------
# Layer metadata


@dataclasses.dataclass
class LayerMeta:
    """Static description of one tapped layer (the JAX package's fields).

    Attributes:
      kind: "dense" | "conv" | "embed" | "scale" | "attn" | "local_vjp".
      path: key path of this layer's param dict inside model params.
      param_key: key of the weight inside the layer param dict.
      bias_key: key of the bias (or None).
      w_transposed: "dense" only — weight stored (out, in), used as x @ W.T.
      segmented: captures carry explicit example ids ("seg") instead of
        a leading batch axis (MoE expert slots).
      scanned: number of leading stacked-layer axes on the captures.
      shared: parameter is shared across call sites (path absolute).
      static: extra static configuration (conv strides, kernel shape;
        an attention block's projection widths; a segmented layer's
        ``n_examples``; ``model_partial`` on a "scale" layer that runs
        on this rank's slice of an activation sharded over ``model``
        with a replicated parameter, qk-norm's query scale on sliced
        heads: its per-example gradient here is partial, and the kind
        sums it over the model group each time a norm or a contribution
        reads it; on a "local_vjp" layer the tuple of the replicated
        leaves its ``fn`` reads for the rank's heads only, Mamba2's
        ``ssd`` params, sLSTM's gate bias.  Set only on a live model
        axis, so never by a probe: plans see a replicated group).
      fn: for "attn": the block's rebuild closure
        ``fn(tapper, params_sub, x) -> y``, which the kind runs again to
        recover each projection's captures and cotangents; for
        "local_vjp": the pure layer ``fn(params_sub, *inputs) -> y``
        (neither is serialized with a plan).
    """

    kind: str
    path: tuple
    param_key: str = "w"
    bias_key: str | None = None
    w_transposed: bool = False
    segmented: bool = False
    scanned: int = 0
    shared: bool = False
    static: dict = dataclasses.field(default_factory=dict)
    fn: Callable | None = None


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor: what the shape-only probe records."""

    shape: tuple
    dtype: torch.dtype


def spec_of(t) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


def _parse_name(name: str) -> tuple[tuple, bool]:
    shared = name.startswith("~")
    return tuple(name.lstrip("~").split("/")), shared


def cap_map(fn, cap: dict) -> dict:
    """``fn`` over every tensor of a capture dict, whose values are
    tensors or (``local_vjp``'s ``"inputs"``) tuples of tensors."""
    return {k: tuple(map(fn, v)) if is_multi(v) else fn(v)
            for k, v in cap.items()}


def is_multi(v) -> bool:
    """A capture value that is a tuple of tensors (or of their specs; a
    :class:`TensorSpec` is a named tuple, and not one of these)."""
    return type(v) is tuple


class Tapper:
    """Records captures and marks layer outputs while running a model.

    Modes:
      * ``"none"``    — plain forward; nothing recorded.
      * ``"capture"`` — record each layer's captures (detached) and its
                        output as a differentiation target in ``outputs``.
      * ``"probe"``   — record each layer's captures and output as
                        :class:`TensorSpec` (the model runs on meta
                        tensors, see :func:`probe`).

    Inside :func:`scan_with_taps` a scanned tap's captures and output are
    lists with one entry per layer until :func:`capture_backward` stacks
    them (probe mode stacks the specs at once).
    """

    def __init__(self, mode: str = "none", metas: dict | None = None):
        if mode not in ("none", "capture", "probe"):
            raise ValueError(f"unknown Tapper mode {mode!r}")
        self.mode = mode
        self.captures: dict = {}
        self.outputs: dict = {}
        self.metas: dict[str, LayerMeta] = metas if metas is not None else {}

    def active(self) -> bool:
        return self.mode != "none"

    # -- core -------------------------------------------------------------
    def tap(self, name: str, y, captures: dict, meta: LayerMeta):
        if self.mode == "none":
            return y
        if name in self.outputs:
            # The JAX package overwrites the first capture here; a shared
            # parameter used more than once is either scanned
            # (scan_with_taps) or tapped under names of its own.
            raise ValueError(
                f"tap {name!r} applied twice outside a scan: the first "
                f"call site's capture would be lost")
        self.metas.setdefault(name, meta)
        if self.mode == "probe":
            self.outputs[name] = spec_of(y)
            self.captures[name] = cap_map(spec_of, captures)
            return y
        if not y.requires_grad:
            y = y.detach().requires_grad_(True)
        self.outputs[name] = y
        self.captures[name] = cap_map(torch.Tensor.detach, captures)
        return y

    # -- layer helpers ----------------------------------------------------
    def dense(self, name: str, x, w, b=None, *, w_transposed: bool = False,
              param_key: str = "w", bias_after_sum: bool = False):
        """Tapped dense layer ``y = x @ W (+ b)``.  ``bias_after_sum``: a
        row-sharded layer whose replicated bias ``b`` the caller adds once,
        after the sum over ``model``: the tapped output is the partial
        product without it, whose cotangent is the whole one, and the
        meta keeps ``bias_key`` (the bias's per-example gradient, the
        cotangent summed over positions, is whole on every rank)."""
        y = torch.matmul(x, w.T if w_transposed else w)
        if b is not None and not bias_after_sum:
            y = y + b
        path, shared = _parse_name(name)
        meta = LayerMeta("dense", path, param_key=param_key,
                         bias_key="b" if b is not None else None,
                         w_transposed=w_transposed, shared=shared)
        return self.tap(name, y, {"x": x}, meta)

    def dense_segmented(self, name: str, x, w, seg, b=None, *,
                        n_examples: int, stacked_axes: int = 1):
        """Dense over dispatched slots: x (*stack, S, Din) with example ids
        seg (*stack, S) and per-group weights w (*stack, Din, Dout), e.g.
        MoE experts with stack = (E,).  ``stacked_axes`` counts the
        leading group axes (:func:`scan_with_taps` adds the layer's)."""
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        path, shared = _parse_name(name)
        meta = LayerMeta("dense", path, bias_key="b" if b is not None
                         else None, segmented=True, shared=shared,
                         scanned=stacked_axes,
                         static={"n_examples": n_examples})
        return self.tap(name, y, {"x": x, "seg": seg}, meta)

    def embed(self, name: str, table, ids, *, n_rows: int | None = None):
        """Tapped embedding gather ``y = table[ids]``.  ``n_rows``: the
        whole table's rows; when ``table`` arrives as this rank's slice of
        a vocabulary sharded over the active model group, the rank looks
        up the ids in its shard (capturing their local ids), zeroes the
        rest, and the rows are summed over ``model``.  The zeroed rows
        carry a zero cotangent, so the kinds count only the tokens whose
        id lies in the shard."""
        from repro_torch.launch import sharding
        path, shared = _parse_name(name)
        meta = LayerMeta("embed", path, param_key="emb", shared=shared)
        if n_rows is None or not sharding.split(table.shape[0], n_rows):
            return self.tap(name, table[ids.long()], {"ids": ids}, meta)
        lid, mine = sharding.lookup(table, ids)
        y = self.tap(name, table[lid], {"ids": lid}, meta)
        return sharding.reduce_from_model(y * mine[..., None].to(y.dtype))

    def scale(self, name: str, x, g, b=None, *, model_partial: bool = False):
        """Tapped elementwise affine (RMSNorm/LayerNorm): y = x*g (+ b).
        ``model_partial``: ``x`` is this rank's slice of an activation
        sharded over the active model group and ``g`` is replicated, so
        ``g`` enters through ``copy_to_model(param=True)`` (autograd's
        gradient summed over ``model``) and ``LayerMeta.static`` marks
        the tap partial."""
        if model_partial:
            from repro_torch.launch import sharding
            g = sharding.copy_to_model(g, param=True)
        y = x * g
        if b is not None:
            y = y + b
        path, shared = _parse_name(name)
        meta = LayerMeta("scale", path, param_key="g",
                         bias_key="b" if b is not None else None,
                         shared=shared,
                         static={"model_partial": True} if model_partial
                         else {})
        return self.tap(name, y, {"x": x}, meta)

    def conv(self, name: str, x, w, b=None, *, stride=1, dilation=1,
             padding=0, groups=1):
        """Tapped N-D convolution, NC(spatial) layout, weight (D, C/g, *K)."""
        from repro_torch.models.convops import conv_forward
        y = conv_forward(x, w, stride=stride, dilation=dilation,
                         padding=padding, groups=groups)
        if b is not None:
            y = y + b.reshape((1, -1) + (1,) * (y.ndim - 2))
        path, shared = _parse_name(name)
        meta = LayerMeta(
            "conv", path, bias_key="b" if b is not None else None,
            shared=shared,
            static={"stride": stride, "dilation": dilation,
                    "padding": padding, "groups": groups,
                    "kernel_shape": tuple(w.shape)})
        return self.tap(name, y, {"x": x}, meta)

    def local_vjp(self, name: str, fn: Callable, params_sub, *inputs,
                  model_partial=()):
        """Tapped generic layer ``y = fn(params_sub, *inputs)`` (pure;
        every input has a leading B): its per-example grads come from the
        layer-local VJP under ``torch.func.vmap`` (``kinds``).
        ``model_partial``: the keys of ``params_sub`` (``True``: all)
        that are replicated and that ``fn`` reads for this rank's slice of
        a sharded activation only (its heads, its channels): each enters
        through ``copy_to_model(param=True)``, and ``LayerMeta.static``
        names them, whose per-example gradient the kind sums over
        ``model``.  ``fn`` itself stays rank-local: the kind runs it
        under ``vmap``, which the collectives do not take."""
        keys = tuple(params_sub) if model_partial is True \
            else tuple(model_partial)
        if keys:
            from repro_torch.launch import sharding
            params_sub = {k: sharding.copy_to_model(v, param=True)
                          if k in keys else v for k, v in params_sub.items()}
        y = fn(params_sub, *inputs)
        path, shared = _parse_name(name)
        meta = LayerMeta("local_vjp", path, shared=shared, fn=fn,
                         static={"model_partial": keys} if keys else {})
        return self.tap(name, y, {"inputs": tuple(inputs)}, meta)


# ---------------------------------------------------------------------------
# Scanned layer stacks


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


def _stack_spec(specs) -> TensorSpec:
    return TensorSpec((len(specs),) + tuple(specs[0].shape), specs[0].dtype)


def _per_layer(caps: list, k: str):
    """One capture key over the layers: a list with one entry a layer, or
    for a tuple-valued capture a tuple of such lists (one per element)."""
    if is_multi(caps[0][k]):
        return tuple([c[k][j] for c in caps] for j in range(len(caps[0][k])))
    return [c[k] for c in caps]


def _checkpointed(body_fn, stp: Tapper):
    """``body_fn(·, carry, params_l, *shared)`` under a per-layer
    ``torch.utils.checkpoint`` (``jax.checkpoint`` in the JAX package):
    the forward records into ``stp`` and keeps only what the tapper holds
    (captures, layer outputs) and the layer's inputs; the backward runs
    the layer again under an inactive tapper, which records nothing and
    builds the same graph (every tapped output of a layer derives from
    the carry, which requires grad, so the capture pass turns none of
    them into a new leaf).  Shared params are closed over: the
    non-reentrant checkpoint saves them through its hooks, so their
    gradient flows as without it."""
    calls = []

    def run(carry, p_l, *shared):
        if calls:
            STATS.recomputes += 1
        t = Tapper() if calls else stp
        calls.append(1)
        return body_fn(t, carry, p_l, *shared)

    def fn(carry, p_l, *shared):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(lambda c, p: run(c, p, *shared), carry, p_l,
                          use_reentrant=False)
    return fn


def scan_with_taps(tp: Tapper, name: str, body_fn, carry, xs_params, *,
                   remat: bool = False, shared_params=None):
    """Run ``body_fn(sub_tp, carry, params_l) -> carry`` over stacked
    layers (``xs_params``: the parameter tree with a leading L axis), one
    layer at a time, in order (``lax.scan``'s semantics), threading
    captures; with ``shared_params`` (an unstacked subtree, Zamba2's
    shared block) each step is ``body_fn(sub_tp, carry, params_l,
    shared_params)``, and taps against it use ``"~"`` names.  Each
    sub-tap ``n`` appears in ``tp`` as ``name/n`` with ``scanned + 1``
    and, unless it is shared (``"~"``: its path stays absolute),
    ``name``'s path in front of its own.  ``remat`` recomputes
    each layer in the backward (:func:`_checkpointed`) wherever autograd
    records a graph.  ``torch.func``'s transforms (the ``multi``
    strategy's vmap of grad) take no saved-tensor hooks: there the layers
    run as without it, with the same values, and a ``RuntimeWarning``
    naming fault F4 says so (ROADMAP.md, divergences by design)."""
    prefix = name + "/"
    sub_metas: dict[str, LayerMeta] = {}
    layers = []
    remat = remat and torch.is_grad_enabled() and tp.mode != "probe"
    if remat and torch._C._are_functorch_transforms_active():
        warnings.warn(
            f"F4: remat=True is not applied to the scanned layers "
            f"{name!r} under torch.func transforms (the 'multi' "
            f"strategy's vmap(grad)): they run without recompute, with "
            f"the same values", RuntimeWarning, stacklevel=2)
        remat = False
    shared = () if shared_params is None else (shared_params,)
    for i in range(_leading(xs_params)):
        stp = Tapper(tp.mode, metas=sub_metas)
        p_l = tree_map(lambda a: a[i], xs_params)
        if remat:
            carry = _checkpointed(body_fn, stp)(carry, p_l, *shared)
        else:
            carry = body_fn(stp, carry, p_l, *shared)
        layers.append(stp)
    if not tp.active():
        return carry
    # Sorted, as the JAX package's scan returns its capture dict.
    for sub_name in sorted(sub_metas):
        meta = sub_metas[sub_name]
        full = prefix + sub_name
        new_path = meta.path if meta.shared \
            else tuple(name.split("/")) + meta.path
        tp.metas.setdefault(full, dataclasses.replace(
            meta, path=new_path, scanned=meta.scanned + 1))
        caps = [stp.captures[sub_name] for stp in layers]
        outs = [stp.outputs[sub_name] for stp in layers]
        per_layer = {k: _per_layer(caps, k) for k in caps[0]}
        if tp.mode == "probe":
            tp.captures[full] = {
                k: tuple(map(_stack_spec, v)) if is_multi(v)
                else _stack_spec(v) for k, v in per_layer.items()}
            tp.outputs[full] = _stack_spec(outs)
        else:
            tp.captures[full] = per_layer
            tp.outputs[full] = outs
    return carry


def _flat(tree, out: list):
    """Tensors of a (nested) list, depth first."""
    if isinstance(tree, list):
        for t in tree:
            _flat(t, out)
    else:
        out.append(tree)
    return out


def _unflat(tree, it):
    if isinstance(tree, list):
        return [_unflat(t, it) for t in tree]
    return next(it)


def _stack(items, seen: dict):
    """(Nested) per-layer list -> one tensor with the leading layer axes
    (a tuple of such lists -> a tuple of tensors).  Lists of the very
    same per-layer tensors (one capture feeding several taps) stack once;
    the list is emptied, so a layer's tensors are freed as soon as no
    list holds them."""
    if is_multi(items):
        return tuple(_stack(i, seen) for i in items)
    if not isinstance(items, list):
        return items
    if isinstance(items[0], list):
        out = torch.stack([_stack(i, seen) for i in items])
    else:
        key = tuple((t.untyped_storage()._cdata, t.storage_offset(),
                     tuple(t.shape), t.stride(), t.dtype) for t in items)
        out = seen.get(key)
        if out is None:
            out = seen[key] = torch.stack(items)
    items.clear()
    return out


# ---------------------------------------------------------------------------
# Probe and the capture backward pass


def _meta(t):
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def probe(apply_fn, params, batch, *, return_captures: bool = False):
    """Shape-only trace: the model runs once on ``device="meta"`` copies
    of ``params`` and ``batch`` (tensors or anything with ``shape`` and
    ``dtype``), so no data is read and no device does work.  Returns
    (metas, out_shapes) — the :class:`LayerMeta` of every tapped layer and
    the :class:`TensorSpec` of its output (= its cotangent) — and with
    ``return_captures`` also the per-layer capture spec dicts, which the
    planner consumes."""
    STATS.probes += 1
    tp = Tapper("probe")
    with torch.no_grad():
        apply_fn(tree_map(_meta, params), tree_map(_meta, batch), tp)
    if return_captures:
        return tp.metas, tp.outputs, tp.captures
    return tp.metas, tp.outputs


def capture_backward(apply_fn, params, batch, *, with_metas: bool = False):
    """One forward + one backward → (per-example losses, captures, output
    cotangents), all detached; scanned taps' come stacked (leading L).
    ``with_metas`` also returns the :class:`LayerMeta` dict recorded
    during the forward."""
    STATS.forwards += 1
    STATS.backwards += 1
    metas: dict[str, LayerMeta] = {}
    tp = Tapper("capture", metas=metas)
    with torch.enable_grad():
        losses = apply_fn(params, batch, tp)
        names = list(tp.outputs)
        if not names:
            raise ValueError("no tapped layers")
        flat: list = []
        for n in names:
            _flat(tp.outputs[n], flat)
        grads = torch.autograd.grad(losses.sum(), flat)
    del flat
    it = iter(grads)
    nested = {n: _unflat(tp.outputs[n], it) for n in names}
    del it, grads
    tp.outputs.clear()
    dtaps = {n: _stack(nested[n], {}) for n in names}
    seen: dict = {}
    caps = {n: {k: _stack(v, seen) for k, v in c.items()}
            for n, c in tp.captures.items()}
    losses = losses.detach()
    if with_metas:
        return losses, caps, dtaps, metas
    return losses, caps, dtaps
