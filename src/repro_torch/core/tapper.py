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
shapes and output shapes, and touches no data and no device.  Scanned
stacks (``scan_with_taps``) and the LM layer kinds (``embed``/``scale``/
``local_vjp``/``dense_segmented``) come with the LM slice (ROADMAP.md
item 11).  Shared parameters keep the ``"~"`` name prefix.

Models stay pure: a ``Tapper`` in mode ``"none"`` is a no-op, so the same
model code serves ordinary training and every PEG strategy.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
    (``gram_norm_fused`` single passes picked by stale-coefficient plans);
    it stays out of :meth:`snapshot`, which counts passes through the
    model."""

    __slots__ = ("forwards", "backwards", "probes", "fused")

    def __init__(self):
        self.reset()

    def reset(self):
        self.forwards = 0
        self.backwards = 0
        self.probes = 0
        self.fused = 0

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
      kind: "dense" | "conv" in this slice.
      path: key path of this layer's param dict inside model params.
      param_key: key of the weight inside the layer param dict.
      bias_key: key of the bias (or None).
      w_transposed: "dense" only — weight stored (out, in), used as x @ W.T.
      segmented: captures carry explicit example ids (MoE; LM slice).
      scanned: number of leading stacked-layer axes on the captures.
      shared: parameter is shared across call sites (path absolute).
      static: extra static configuration (conv strides, kernel shape).
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


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor: what the shape-only probe records."""

    shape: tuple
    dtype: torch.dtype


def spec_of(t) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


def _parse_name(name: str) -> tuple[tuple, bool]:
    shared = name.startswith("~")
    return tuple(name.lstrip("~").split("/")), shared


class Tapper:
    """Records captures and marks layer outputs while running a model.

    Modes:
      * ``"none"``    — plain forward; nothing recorded.
      * ``"capture"`` — record each layer's captures (detached) and its
                        output as a differentiation target in ``outputs``.
      * ``"probe"``   — record each layer's captures and output as
                        :class:`TensorSpec` (the model runs on meta
                        tensors, see :func:`probe`).
    """

    def __init__(self, mode: str = "none", metas: dict | None = None):
        if mode not in ("none", "capture", "probe"):
            raise ValueError(f"unknown Tapper mode {mode!r}")
        self.mode = mode
        self.captures: dict = {}
        self.outputs: dict = {}
        self.metas: dict[str, LayerMeta] = metas if metas is not None else {}

    # -- core -------------------------------------------------------------
    def tap(self, name: str, y, captures: dict, meta: LayerMeta):
        if self.mode == "none":
            return y
        if name in self.outputs:
            raise NotImplementedError(
                f"tap {name!r} applied twice: shared/scanned layers come with "
                f"the LM slice (ROADMAP.md item 11)")
        self.metas.setdefault(name, meta)
        if self.mode == "probe":
            self.outputs[name] = spec_of(y)
            self.captures[name] = {k: spec_of(v) for k, v in captures.items()}
            return y
        if not y.requires_grad:
            y = y.detach().requires_grad_(True)
        self.outputs[name] = y
        self.captures[name] = {k: v.detach() for k, v in captures.items()}
        return y

    # -- layer helpers ----------------------------------------------------
    def dense(self, name: str, x, w, b=None, *, w_transposed: bool = False,
              param_key: str = "w"):
        """Tapped dense layer ``y = x @ W (+ b)``."""
        y = torch.matmul(x, w.T if w_transposed else w)
        if b is not None:
            y = y + b
        path, shared = _parse_name(name)
        meta = LayerMeta("dense", path, param_key=param_key,
                         bias_key="b" if b is not None else None,
                         w_transposed=w_transposed, shared=shared)
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
    cotangents), all detached.  ``with_metas`` also returns the
    :class:`LayerMeta` dict recorded during the forward."""
    STATS.forwards += 1
    STATS.backwards += 1
    metas: dict[str, LayerMeta] = {}
    tp = Tapper("capture", metas=metas)
    with torch.enable_grad():
        losses = apply_fn(params, batch, tp)
        names = list(tp.outputs)
        if not names:
            raise ValueError("no tapped layers")
        grads = torch.autograd.grad(losses.sum(),
                                    [tp.outputs[n] for n in names])
    dtaps = dict(zip(names, grads))
    losses = losses.detach()
    if with_metas:
        return losses, tp.captures, dtaps, metas
    return losses, tp.captures, dtaps
