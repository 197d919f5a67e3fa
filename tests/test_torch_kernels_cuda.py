"""The conv-gradient and ghost-norm kernels on the card (tests marked
``cuda``; they skip without one), against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py tests/test_torch_flash_cuda.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX).  The plain
versions are themselves held against the JAX package's Pallas kernels in
``tests/test_torch_kernels.py``.  Tolerance: rtol 1e-4 (f32 sums in
another order than the plain version's; bf16 inputs, f32 arithmetic), with
an absolute floor of 1e-4 of the largest entry for the conv gradients'
entries near zero.  Every kernel must repeat bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the kernels there")


def _close(got, want, rtol=1e-4):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * want.abs().max().item())


@pytest.mark.cuda
def test_cuda_gram_norm_fused_matches_ref():
    """Card only: the fused kernel against its plain version on strided
    (conv) and contiguous (dense) layouts, ragged T, bias on and off, f32
    and bf16 inputs; two launches are bitwise equal."""
    _needs_card()
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for B, T, Di, Do, strided, bias in ((3, 70, 90, 33, True, True),
                                            (2, 1, 130, 65, False, False)):
            if strided:
                x = torch.randn(B, Di, T, generator=g).to("cuda", dt)
                dy = torch.randn(B, Do, T, generator=g).to("cuda", dt)
                x, dy = x.transpose(1, 2), dy.transpose(1, 2)
            else:
                x = torch.randn(B, T, Di, generator=g).to("cuda", dt)
                dy = torch.randn(B, T, Do, generator=g).to("cuda", dt)
            w = torch.rand(B, generator=g).to("cuda")
            n0 = ops.LAUNCHES["gram_norm_fused"]
            got = ops.gram_norm_fused(x, dy, w, has_bias=bias)
            again = ops.gram_norm_fused(x, dy, w, has_bias=bias)
            assert ops.LAUNCHES["gram_norm_fused"] == n0 + 2
            want = ref.gram_norm_fused_ref(x, dy, w, has_bias=bias)
            for a, b, c in zip(got, again, want):
                assert torch.equal(a, b)
                torch.testing.assert_close(a, c, rtol=1e-4,
                                           atol=1e-4 * c.abs().max().item())


@pytest.mark.cuda
def test_cuda_kernels_match_ref():
    """Card only: both kernels against their plain versions (f32 exact
    order is not promised, so rtol 1e-4; bf16 inputs, f32 math)."""
    _needs_card()
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 5, 12, 12, generator=g).to("cuda", dt)
        dy = torch.randn(3, 7, 10, 10, generator=g).to("cuda", dt)
        n0 = ops.LAUNCHES["pe_conv_grad_2d"]
        got = ops.pe_conv_grad_2d(x, dy, KH=3, KW=3)
        assert ops.LAUNCHES["pe_conv_grad_2d"] == n0 + 1
        torch.testing.assert_close(got, ref.pe_conv_grad_2d_ref(x, dy, 3, 3),
                                   rtol=1e-4, atol=1e-4)
        x = torch.randn(3, 70, 9, generator=g).to("cuda", dt)
        dy = torch.randn(3, 70, 4, generator=g).to("cuda", dt)
        got = ops.gram_norm(x, dy, has_bias=True)
        torch.testing.assert_close(got, ref.gram_norm_ref(x, dy,
                                                          has_bias=True),
                                   rtol=1e-4, atol=0)


# (B, C, D, T, K): the JAX kernel test's sweep, then a ragged case (T'
# not a multiple of the 16-deep chunk, D and C·K wider than one 64 tile)
# and the 1-D lane's first layer (C·K = 33 of a 64-wide tile).
PE1D_SHAPES = [(2, 5, 6, 20, 3), (1, 3, 8, 33, 5), (4, 2, 2, 9, 2),
               (3, 70, 130, 100, 4), (2, 3, 64, 300, 11)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", PE1D_SHAPES)
def test_cuda_pe_conv_grad_1d_matches_ref(shape, dtype):
    _needs_card()
    B, C, D, T, K = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(B, C, T, generator=g).to("cuda", dtype)
    dy = torch.randn(B, D, T - K + 1, generator=g).to("cuda", dtype)
    n0 = ops.LAUNCHES["pe_conv_grad_1d"]
    got = ops.pe_conv_grad_1d(x, dy, K=K)
    again = ops.pe_conv_grad_1d(x, dy, K=K)
    assert ops.LAUNCHES["pe_conv_grad_1d"] == n0 + 2
    assert got.dtype == torch.float32 and got.shape == (B, D, C, K)
    assert torch.equal(got, again)
    _close(got, ref.pe_conv_grad_1d_ref(x, dy, K))


@pytest.mark.cuda
def test_cuda_pe_conv_grad_dispatch_1d_padded():
    """``ops.pe_conv_grad`` on a plain padded 1-D conv pads x, casts dy to
    x's dtype and launches the kernel; a strided conv takes the grouped-
    conv lowering and launches nothing."""
    _needs_card()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 17, generator=g).cuda()
    dy = torch.randn(2, 6, 17, generator=g).cuda()
    n0 = ops.LAUNCHES["pe_conv_grad_1d"]
    got = ops.pe_conv_grad(x, dy, kernel_spatial=(5,), padding=2)
    assert ops.LAUNCHES["pe_conv_grad_1d"] == n0 + 1
    want = ref.pe_conv_grad_1d_ref(torch.nn.functional.pad(x, (2, 2)), dy, 5)
    _close(got, want)
    dys = torch.randn(2, 6, 8, generator=g).cuda()
    ops.pe_conv_grad(x, dys, kernel_spatial=(3,), stride=2)
    assert ops.LAUNCHES["pe_conv_grad_1d"] == n0 + 1


# (B, T, D, id range): heavily repeated ids (small ranges), ragged T
# against the 64-row tiles, and ids from a 128 256 vocabulary (almost only
# the diagonal matches).
TOKMASK_SHAPES = [(2, 33, 9, 7), (3, 70, 5, 3), (2, 1000, 64, 16),
                  (2, 256, 128, 128256), (1, 1, 8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", TOKMASK_SHAPES)
def test_cuda_gram_norm_tokmask_matches_ref(shape, dtype):
    _needs_card()
    B, T, D, V = shape
    g = torch.Generator().manual_seed(T + D)
    ids = torch.randint(0, V, (B, T), generator=g).cuda()
    dy = torch.randn(B, T, D, generator=g).to("cuda", dtype)
    n0 = ops.LAUNCHES["gram_norm_tokmask"]
    got = ops.gram_norm_tokmask(ids, dy)
    again = ops.gram_norm_tokmask(ids, dy)
    assert ops.LAUNCHES["gram_norm_tokmask"] == n0 + 2
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.gram_norm_tokmask_ref(ids, dy),
                               rtol=1e-4, atol=0)
