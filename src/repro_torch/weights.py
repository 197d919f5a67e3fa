"""Carrying weights between the JAX package and the port.

Random init streams differ between the frameworks, so parity runs
initialize once (in JAX), take the params to numpy (``jax.device_get``)
and load them here, leaf for leaf under the same key paths.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import get_subtree, leaf_paths, tree_map


def _leaves(tree):
    return {p: get_subtree(tree, p) for p in leaf_paths(tree)}


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def params_from_numpy(tree, *, like=None, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    ``like`` (a nested dict of tensors, e.g. the port's own ``init``) pins
    the expected structure: a missing leaf, an extra leaf or a shape
    mismatch raises instead of loading a tree the model cannot use."""
    dev = resolve_device(device)
    got = _leaves(tree)
    for path, leaf in got.items():
        if not isinstance(leaf, (np.ndarray, np.generic)):
            raise TypeError(f"leaf {_path_str(path)} is "
                            f"{type(leaf).__name__}, not a numpy array")
    if like is not None:
        want = {p: tuple(v.shape) for p, v in _leaves(like).items()}
        missing = sorted(_path_str(p) for p in set(want) - set(got))
        extra = sorted(_path_str(p) for p in set(got) - set(want))
        if missing or extra:
            raise KeyError(f"param tree mismatch: missing {missing}, "
                           f"extra {extra}")
        for p, shape in want.items():
            if tuple(np.shape(got[p])) != shape:
                raise ValueError(
                    f"leaf {_path_str(p)} has shape {np.shape(got[p])}, "
                    f"expected {shape}")

    def load(t):
        # numpy has no bfloat16 of its own: JAX hands bf16 leaves over in
        # an extension dtype that torch cannot read, so they pass as f32.
        if t.dtype.name == "bfloat16":
            return torch.from_numpy(np.asarray(t, np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return tree_map(load, tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
