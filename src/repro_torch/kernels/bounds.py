"""The bound that an f32 product-sum kernel is held to on the card.

A kernel that sums n products a·b in f32 is held, entry by entry, to

    |got − exact| ≤ u·√n·absprod,        u = 2⁻²⁴,

where ``exact`` is the same sum taken in f64 over the same inputs and
``absprod`` the sum of |a|·|b| in f64.  u·√n·absprod is the typical
rounding error of an f32 sum of n terms, so the rule admits every
correct f32 summation order (sequential, in blocks, on the tensor
cores) with room to spare, and fails a kernel that rounds its operands
to TF32 without the error-compensating split, drops a term, or
accumulates in bf16 (``tests/test_torch_sum_bound.py``).  An entry whose
``absprod`` is 0 is a sum of zeros and must be exactly 0.

The conv-gradient kernels' plain versions take f64 inputs as f64, so
``exact = ref(x.double(), dy.double())`` and
``absprod = ref(x.double().abs(), dy.double().abs())``.
"""
from __future__ import annotations

import math

import torch

U = 2.0 ** -24


def sum_bound(got, exact, absprod, n: int):
    """(worst, ok): the largest |got − exact| / (u·√n·absprod) over the
    entries (inf where absprod is 0 and got differs from exact), and
    whether it is at most 1."""
    err = (got.to(torch.float64) - exact).abs()
    lim = U * math.sqrt(max(n, 1)) * absprod
    ratio = torch.where(lim > 0, err / lim.clamp_min(1e-300),
                        torch.where(err > 0, math.inf, 0.0))
    worst = ratio.max().item() if ratio.numel() else 0.0
    return worst, worst <= 1.0
