"""repro_torch: the per-example-gradient DP-SGD system of :mod:`repro`
(Rochette, Manoel & Tramel 2019) ported to PyTorch and CUDA for one
NVIDIA H100.

The module layout mirrors the JAX package (``core/``, ``kernels/``,
``models/``, ``configs/``, ``optim/``, ``data/``, ``checkpoint/``,
``runtime/``, ``calibrate/``, ``launch/``, ``analysis/``) and so do the
names, so every function has an obvious counterpart.  Params are nested
dicts of tensors with the JAX package's key paths and layouts
(conv ``w`` is ``(D, C, K, K)``, dense ``w`` is ``(in, out)`` used as
``x @ w``), and models keep ``apply(params, batch, tapper) -> (B,)``.

It covers the DP-SGD step on one device on the paper's CNNs (and any
model of plain 1-D or 2-D convs and dense layers), under the fixed
strategies (naive / multi / crb / ghost / bk) and the planned one
(``strategy="auto"``), with flat, per-layer and stale clipping; on
Llama-3.2-1B under bk and ``auto`` with flat clipping; plans priced by
the card's measured constants (``calibrate``) with the mispredict re-plan
loop; and the training CLI (``python -m repro_torch.launch.train``) with
checkpoint/resume.  Sharding and the other LM families come later (see
ROADMAP.md).  Every entry point takes ``device=`` and defaults to
``"cuda"``; without a card it raises unless ``device="cpu"`` is passed.
"""
__version__ = "0.1.0"

from repro_torch.core import (DPConfig, NormCfg, PrivacyAccountant,
                              PrivacyEngine, Tapper, clipped_grad_sum,
                              dp_gradient)
from repro_torch.weights import params_from_numpy, params_to_numpy

__all__ = ["DPConfig", "NormCfg", "PrivacyAccountant", "PrivacyEngine",
           "Tapper", "clipped_grad_sum", "dp_gradient", "params_from_numpy",
           "params_to_numpy", "__version__"]
