"""The f32 product-sum bound (``repro_torch.kernels.bounds.sum_bound``)
on the CPU: |got − exact| ≤ u·√n·Σ|a|·|b|, entry by entry, u = 2⁻²⁴.

(32 × n)·(n × 48) products of randn operands at the conv kernels' sum
lengths (n = H′W′ = 225 and 961 on AlexNet, T′ = 4096 on the 1-D lane),
two seeds.  The rule accepts every correct f32 order a kernel may take:
sequential (the plain version), in blocks of 8 and 16 (a tensor core's
k-step), and 3xTF32 (each 32-deep stage's three TF32 products summed
from zero, then added in f32, as ``csrc/pe_conv_grad.cu`` does).  It
rejects one TF32 product without the split, a sum that drops one term,
and a sum accumulated in bf16.  TF32 rounding is emulated by bit masking
on an int32 view (round to nearest, ties away: ``cvt.rna.tf32.f32``).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bounds, ref  # noqa: E402

LENGTHS = (225, 961, 4096)
SEEDS = (0, 1)
STAGE = 32  # contraction depth of a stage of the 2-D kernel's f32 route


def _tf32(v):
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(32, n, generator=g), torch.randn(48, n, generator=g)


def _exact(a, b):
    return a.double() @ b.double().T, a.double().abs() @ b.double().abs().T


def _seq(prods, dtype=torch.float32):
    """Σ over the last axis in order, each partial sum rounded to dtype."""
    acc = torch.zeros(prods.shape[:-1], dtype=dtype)
    for t in range(prods.shape[-1]):
        acc = (acc.float() + prods[..., t]).to(dtype)
    return acc.float()


def _pad(v, m):
    return torch.nn.functional.pad(v, (0, -v.shape[-1] % m))


def _blocked(prods, m):
    """Blocks of m products summed from zero, the blocks added in order."""
    p = _pad(prods, m)
    return _seq(p.view(*p.shape[:-1], -1, m).sum(-1))


def _staged(a, b, split):
    """Per 32-deep stage: the TF32 products (lo·hi + hi·lo + hi·hi with
    the split, hi·hi without) summed from zero in f32, then added to an
    f32 accumulator in stage order."""
    a, b = _pad(a, STAGE), _pad(b, STAGE)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = torch.zeros(a.shape[0], b.shape[0])
    for s in range(0, a.shape[1], STAGE):
        k = slice(s, s + STAGE)
        stage = ah[:, k] @ bh[:, k].T
        if split:
            stage = al[:, k] @ bh[:, k].T + ah[:, k] @ bl[:, k].T + stage
        acc = acc + stage
    return acc


def _candidate(kind, a, b):
    prods = a[:, None, :] * b[None, :, :]  # (32, 48, n), f32
    if kind == "sequential":
        return _seq(prods)
    if kind == "blocks8":
        return _blocked(prods, 8)
    if kind == "blocks16":
        return _blocked(prods, 16)
    if kind == "3xtf32":
        return _staged(a, b, split=True)
    if kind == "tf32_no_split":
        return _staged(a, b, split=False)
    if kind == "dropped_term":
        return _seq(torch.cat([prods[..., :a.shape[1] // 2],
                               prods[..., a.shape[1] // 2 + 1:]], -1))
    if kind == "bf16_accumulation":
        return _seq(prods, torch.bfloat16)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ("sequential", "blocks8", "blocks16",
                                  "3xtf32"))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_rule_accepts_correct_f32_orders(n, seed, kind):
    a, b = _operands(n, seed)
    exact, absprod = _exact(a, b)
    worst, ok = bounds.sum_bound(_candidate(kind, a, b), exact, absprod, n)
    assert ok, f"{kind} at n={n}: {worst:.3f}x the bound"


@pytest.mark.parametrize("kind", ("tf32_no_split", "dropped_term",
                                  "bf16_accumulation"))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_rule_rejects_broken_sums(n, seed, kind):
    a, b = _operands(n, seed)
    exact, absprod = _exact(a, b)
    worst, ok = bounds.sum_bound(_candidate(kind, a, b), exact, absprod, n)
    assert not ok and worst > 2, f"{kind} at n={n}: {worst:.3f}x"


def test_rule_on_zero_sums():
    """An entry with Σ|a|·|b| = 0 must be exactly 0; n scales the bound
    by √n."""
    exact = torch.zeros(3, dtype=torch.float64)
    absprod = torch.tensor([0.0, 1.0, 4.0], dtype=torch.float64)
    assert bounds.sum_bound(torch.zeros(3), exact, absprod, 9) == (0.0, True)
    worst, ok = bounds.sum_bound(torch.tensor([1e-30, 0.0, 0.0]), exact,
                                 absprod, 9)
    assert worst == math.inf and not ok
    got = torch.tensor([0.0, 3 * bounds.U, 12 * bounds.U])
    assert bounds.sum_bound(got, exact, absprod, 9) == (1.0, True)
    assert not bounds.sum_bound(got, exact, absprod, 4)[1]


@pytest.mark.parametrize("dims", ("2d", "1d"))
def test_plain_versions_meet_the_rule_and_keep_f64(dims):
    """The conv plain versions keep f64 inputs in f64 (the exact sum and
    Σ|a|·|b|), leave f32 in f32, and their f32 result meets the rule."""
    g = torch.Generator().manual_seed(5)
    if dims == "2d":
        x, dy = torch.randn(2, 6, 19, 19, generator=g), torch.randn(
            2, 5, 15, 15, generator=g)
        fn, n = (lambda a, b: ref.pe_conv_grad_2d_ref(a, b, 5, 5)), 225
    else:
        x, dy = torch.randn(2, 6, 963, generator=g), torch.randn(
            2, 5, 961, generator=g)
        fn, n = (lambda a, b: ref.pe_conv_grad_1d_ref(a, b, 3)), 961
    got = fn(x, dy)
    exact = fn(x.double(), dy.double())
    absprod = fn(x.double().abs(), dy.double().abs())
    assert got.dtype == torch.float32 and exact.dtype == torch.float64
    assert fn(x.bfloat16(), dy.bfloat16()).dtype == torch.float32
    assert bounds.sum_bound(got, exact, absprod, n)[1]
