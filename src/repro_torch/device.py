"""The device rule every entry point of the port follows.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card
they raise instead of quietly running on the CPU: a CPU run is only ever
what the caller asked for (the tests pass ``device="cpu"``).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; pass device='cpu' to "
            "run the port on the CPU (its kernels then take their plain "
            "PyTorch versions)")
    return dev
