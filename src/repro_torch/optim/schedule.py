"""Learning-rate schedules over a step count (int or 0-dim tensor)."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, *, warmup: int, peak: float):
    return peak * torch.clamp((_f32(step) + 1) / max(warmup, 1), max=1.0)


def cosine_schedule(step, *, warmup: int, total: int, peak: float,
                    floor: float = 0.0):
    s = _f32(step)
    warm = peak * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(s < warmup, warm, cos)
