"""``tag``: the marker the core pipeline puts on its load-bearing values:

  * ``kind="clip_coef"``   — per-example clip coefficients (``mode`` says
    which policy produced them: flat, per_layer or stale);
  * ``kind="group_norm"``  — a parameter group's per-example squared
    norms, with the group key, the realized method and whether a fused
    single pass produced them;
  * ``kind="realization"`` — a kind-level norm realization;
  * ``kind="fused_impl"``  — a fused norm+contrib single pass
    (``gram_norm_fused``);
  * ``kind="noise"``       — each Gaussian noise term, with its structural
    scale ``sigma = noise_multiplier * l2_clip``.

The marker is the custom op ``repro_torch::dp_tag(Tensor x, str params)``
(``params``: the static scalars as sorted JSON).  It is the identity, with
a fake implementation, an identity autograd rule and a vmap rule, so a
graph captured with ``make_fx`` (:mod:`repro_torch.analysis.graph`) keeps
each marker as one ``dp_tag`` node with its params, where the static
verifier finds it.

The JAX package's marker lowers to nothing.  A custom op may not return
its input, so its real implementation copies; :func:`tag` therefore
dispatches the op only while a graph is being recorded and returns ``x``
itself otherwise, and an eager step pays nothing for its markers.
"""
from __future__ import annotations

import json
from typing import Any

import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode

MARKER_OP = "repro_torch.dp_tag.default"
_ALLOWED = (str, int, float, bool)


@torch.library.custom_op("repro_torch::dp_tag", mutates_args=())
def _dp_tag(x: torch.Tensor, params: str) -> torch.Tensor:
    return x.clone()


_dp_tag.register_fake(lambda x, params: torch.empty_like(x))
_dp_tag.register_autograd(lambda ctx, grad: (grad, None))
_dp_tag.register_vmap(
    lambda info, in_dims, x, params: (_dp_tag(x, params), in_dims[0]))


def tag(x, **params: Any):
    """Identity on ``x``.  ``params`` must include ``kind=`` and hold only
    static scalars (str/int/float/bool); in a recorded graph they surface
    as the ``dp_tag`` node's params (:func:`marker_params`)."""
    if "kind" not in params:
        raise ValueError("dp_tag requires a kind= param")
    for k, v in params.items():
        if not isinstance(v, _ALLOWED):
            raise TypeError(
                f"dp_tag param {k}={v!r} is not a static scalar "
                f"(str/int/float/bool)")
    if get_proxy_mode() is None:
        return x
    return torch.ops.repro_torch.dp_tag(x, json.dumps(params, sort_keys=True))


def is_marker(node) -> bool:
    """True if an FX node is a ``dp_tag`` marker."""
    return node.op == "call_function" and str(node.target) == MARKER_OP


def marker_params(node) -> dict:
    """The static params a ``dp_tag`` node records."""
    return json.loads(node.args[1])
