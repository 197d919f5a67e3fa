"""The port's convolution ops against ``repro.models.convops``.

Same numpy inputs into both packages, over the 2-D versions of
``tests/test_conv_trick.py``'s CASES (stride, dilation, padding, groups)
and a few 1-D ones.  f32, atol 1e-5 (sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.models import convops as jconv  # noqa: E402
from repro_torch.models import convops as tconv  # noqa: E402

CASES = [
    # (B, C, D, T, K, stride, dilation, padding, groups)
    (3, 4, 6, 16, 3, 1, 1, 0, 1),
    (2, 4, 6, 17, 5, 2, 1, 2, 1),
    (2, 4, 6, 19, 3, 1, 2, 1, 1),
    (2, 6, 9, 16, 3, 2, 2, 2, 3),
    (4, 8, 8, 21, 4, 3, 2, 3, 4),
    (1, 2, 2, 8, 2, 1, 1, 1, 2),
]


def _inputs(case, rank):
    B, C, D, T, K, s, r, p, g = case
    rng = np.random.RandomState(sum(case) + rank)
    S = (T,) * rank
    x = rng.randn(B, C, *S).astype(np.float32)
    w = rng.randn(D, C // g, *((K,) * rank)).astype(np.float32)
    y = np.asarray(jconv.conv_forward(jnp.asarray(x), jnp.asarray(w),
                                      stride=s, dilation=r, padding=p,
                                      groups=g))
    dy = rng.randn(*y.shape).astype(np.float32)
    return x, w, y, dy


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_conv_forward(case, rank):
    B, C, D, T, K, s, r, p, g = case
    x, w, y, _ = _inputs(case, rank)
    got = tconv.conv_forward(torch.from_numpy(x), torch.from_numpy(w),
                             stride=s, dilation=r, padding=p, groups=g)
    np.testing.assert_allclose(got.numpy(), y, atol=1e-5, rtol=1e-5)
    assert tconv.conv_output_spatial((T,) * rank, (K,) * rank, s, r, p) \
        == tuple(y.shape[2:])


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_unfold_patches_order(case, rank):
    """Channel-major / filter-position-minor: the same layout as
    ``lax.conv_general_dilated_patches`` (a wrong order passes the norm
    tests but breaks the conv contribution)."""
    B, C, D, T, K, s, r, p, g = case
    x, _, _, _ = _inputs(case, rank)
    want = jconv.unfold_patches(jnp.asarray(x), (K,) * rank, stride=s,
                                dilation=r, padding=p)
    got = tconv.unfold_patches(torch.from_numpy(x), (K,) * rank, stride=s,
                               dilation=r, padding=p)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unfold_matches_lax_patches_exactly():
    """The scratch check behind the port's choice of ``F.unfold``: x
    (2,3,7,7), K3, stride 2, pad 1 against lax's patches."""
    x = np.random.RandomState(0).randn(2, 3, 7, 7).astype(np.float32)
    want = lax.conv_general_dilated_patches(
        jnp.asarray(x), (3, 3), (2, 2), ((1, 1), (1, 1)))
    got = tconv.unfold_patches(torch.from_numpy(x), (3, 3), stride=2,
                               padding=1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(2, 27, -1))


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_pe_conv_grad_fgc(case, rank):
    B, C, D, T, K, s, r, p, g = case
    x, _, _, dy = _inputs(case, rank)
    kw = dict(kernel_spatial=(K,) * rank, stride=s, dilation=r, padding=p,
              groups=g)
    want = jconv.pe_conv_grad(jnp.asarray(x), jnp.asarray(dy), impl="fgc",
                              **kw)
    got = tconv.pe_conv_grad(torch.from_numpy(x), torch.from_numpy(dy),
                             impl="fgc", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if rank == 2:
        # The kernel route (its plain version on the CPU), including the
        # grouped-conv fallback for non-plain convs.
        got_k = tconv.pe_conv_grad(torch.from_numpy(x), torch.from_numpy(dy),
                                   impl="pallas", **kw)
        np.testing.assert_allclose(got_k.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_pe_conv_grad_bgc_not_ported():
    x, dy = torch.zeros(2, 4, 8, 8), torch.zeros(2, 6, 6, 6)
    with pytest.raises(NotImplementedError, match="batch_group_count"):
        tconv.pe_conv_grad(x, dy, kernel_spatial=(3, 3), impl="bgc")
