"""Error-compensated TF32 ("3xTF32") against the bound before F3, on the
CPU: TF32 rounding is emulated in torch by bit masking on an int32 view.

Before fault F3 was repaired, ``chip_smoke.py`` held the conv-gradient
kernels to rtol 1e-4 with an absolute floor of 1e-7 of the largest entry
against the plain f32 version (``compare``).  These tests document why
that bound failed, over T' = 4096 (the 1-D lane's length):

* the three split products lo.hi + hi.lo + hi.hi, summed exactly, meet
  the bound before F3 against an f64 product, and one TF32 product
  misses it by two orders of magnitude;
* two f32 sums of the same exact products, in two orders, differ by more
  than the bound before F3: a tensor-core kernel, which sums 8 or 16
  products at a time, could not meet it against the sequential f32 sum
  of the plain version, whatever the accuracy of its products.

The bound that replaced it (``repro_torch.kernels.bounds.sum_bound``, an
f64 product scaled with the sum's length) is tested in
``tests/test_torch_sum_bound.py``.
"""
import pytest

torch = pytest.importorskip("torch")


def _tf32(v):
    """v (f32) rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), kept in f32."""
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _worst(got, want):
    """The largest error of ``got`` as a multiple of the bound before F3:
    rtol 1e-4 of the entry plus 1e-4 * 1e-3 of the largest entry."""
    err = (got.double() - want.double()).abs()
    bound = 1e-4 * want.abs() + 1e-7 * want.abs().max()
    return (err / bound).max().item()


def _operands(seed, T=4096):
    """dy (2, 32, T) and the shifted x operand (2, 48, T), as a 1-D
    layer's GEMM takes them, from a seed."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, 32, T, generator=g), torch.randn(2, 48, T,
                                                           generator=g)


def _prod(a, b):
    return torch.einsum("bdt,bnt->bdn", a.double(), b.double())


def test_tf32_rounding_is_round_to_nearest_away():
    v = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -11),
                      1 + 2 ** -10])
    got = _tf32(v)
    assert got.tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 ** -9), 1 + 2 ** -10]
    assert not (got.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_products_meet_rtol_one_tf32_product_misses(seed):
    a, b = _operands(seed)
    exact = _prod(a, b)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    three = _prod(al, bh) + _prod(ah, bl) + _prod(ah, bh)
    assert _worst(three, exact) <= 1
    assert _worst(_prod(ah, bh), exact) > 100


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_f32_sums_in_two_orders_differ_beyond_the_bound(seed):
    a, b = _operands(seed)
    prods = a[:, :, None, :] * b[:, None, :, :]  # (2, 32, 48, T) in f32
    seq = torch.zeros(prods.shape[:-1])
    for t in range(prods.shape[-1]):  # the plain version's order
        seq = seq + prods[..., t]
    chunks = prods.view(*prods.shape[:-1], -1, 16).sum(-1)  # 16 at a time
    blocked = torch.zeros(prods.shape[:-1])
    for j in range(chunks.shape[-1]):
        blocked = blocked + chunks[..., j]
    exact = _prod(a, b)
    assert _worst(blocked, seq) > 1
    assert _worst(seq, exact) > 1
