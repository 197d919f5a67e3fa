"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions
(``repro_torch.kernels.ref``); those are held here against the Pallas
kernels run in interpret mode, exactly as ``tests/test_kernels.py`` runs
them, over the same shape and dtype sweep.  The CUDA kernels themselves
run only on the card: ``test_cuda_kernels_match_ref`` checks them there
and skips elsewhere (``chip_smoke.py`` holds them against the plain
versions at the main path's shapes).

Tolerances: f32 rtol 2e-5 for the Gram norms (sums over up to T² terms
in another order), 1e-5 for the conv gradients and for the fused
kernel's norms and contributions (atol 1e-5 on contribution entries near
zero); bf16 rtol 5e-2 (the Pallas kernel multiplies in bf16 before
accumulating, the port casts to f32 first).  The tests that need the card
carry the ``cuda`` marker.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gram_norm import gram_norm as jax_gram_norm  # noqa: E402
from repro.kernels.gram_norm import (  # noqa: E402
    gram_norm_fused as jax_gram_norm_fused)
from repro.kernels.pe_conv_grad import (  # noqa: E402
    pe_conv_grad_2d as jax_pe_conv_grad_2d)
from repro_torch.kernels import ops, ref  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("shape", [(3, 50, 16, 24), (2, 256, 32, 8),
                                   (2, 300, 7, 5), (1, 8, 128, 128),
                                   (2, 1, 40, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_bias", [False, True])
def test_gram_norm_ref_vs_pallas(shape, dtype, has_bias):
    B, T, Di, Do = shape
    rng = np.random.RandomState(sum(shape))
    xn = rng.randn(B, T, Di).astype(np.float32)
    dyn = rng.randn(B, T, Do).astype(np.float32)
    want = jax_gram_norm(jnp.asarray(xn, JAX_DT[dtype]),
                         jnp.asarray(dyn, JAX_DT[dtype]), has_bias=has_bias,
                         bt=64, interpret=True)
    x = torch.from_numpy(xn).to(TORCH_DT[dtype])
    dy = torch.from_numpy(dyn).to(TORCH_DT[dtype])
    before = dict(ops.LAUNCHES)
    got = ops.gram_norm(x, dy, has_bias=has_bias)
    assert ops.LAUNCHES == before        # CPU tensors never launch
    assert got.dtype == torch.float32 and got.shape == (B,)
    rtol = 2e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)


@pytest.mark.parametrize("shape", [(3, 50, 16, 24), (2, 300, 7, 5),
                                   (2, 1, 40, 12), (4, 65, 70, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_bias", [False, True])
def test_gram_norm_fused_ref_vs_pallas(shape, dtype, has_bias):
    """Ragged T (50, 300, 65 against 64-row tiles), T = 1, bias on and
    off."""
    B, T, Di, Do = shape
    rng = np.random.RandomState(sum(shape) + 1)
    xn = rng.randn(B, T, Di).astype(np.float32)
    dyn = rng.randn(B, T, Do).astype(np.float32)
    wn = rng.rand(B).astype(np.float32)
    want = jax_gram_norm_fused(jnp.asarray(xn, JAX_DT[dtype]),
                               jnp.asarray(dyn, JAX_DT[dtype]),
                               jnp.asarray(wn), has_bias=has_bias, bt=64,
                               interpret=True)
    x = torch.from_numpy(xn).to(TORCH_DT[dtype])
    dy = torch.from_numpy(dyn).to(TORCH_DT[dtype])
    before = dict(ops.LAUNCHES)
    got = ops.gram_norm_fused(x, dy, torch.from_numpy(wn),
                              has_bias=has_bias)
    assert ops.LAUNCHES == before        # CPU tensors never launch
    assert [tuple(g.shape) for g in got] == [(B,), (Di, Do), (Do,)]
    assert all(g.dtype == torch.float32 for g in got)
    rtol = 1e-5 if dtype == "float32" else 5e-2
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


def test_gram_norm_fused_reads_strided_views():
    """The conv path hands over transposed im2col views; the plain
    version (like the kernel) takes them as they are."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 9, 20).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 5, 20).astype(np.float32))
    w = torch.tensor([0.3, 1.0])
    got = ops.gram_norm_fused(x.transpose(1, 2), dy.transpose(1, 2), w,
                              has_bias=True)
    want = ops.gram_norm_fused(x.transpose(1, 2).contiguous(),
                               dy.transpose(1, 2).contiguous(), w,
                               has_bias=True)
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 3, 4, 10, 3), (1, 2, 6, 8, 2)])
def test_pe_conv_grad_2d_ref_vs_pallas(shape):
    B, C, D, HW, K = shape
    rng = np.random.RandomState(sum(shape))
    xn = rng.randn(B, C, HW, HW).astype(np.float32)
    dyn = rng.randn(B, D, HW - K + 1, HW - K + 1).astype(np.float32)
    want = jax_pe_conv_grad_2d(jnp.asarray(xn), jnp.asarray(dyn), KH=K, KW=K,
                               interpret=True)
    got = ops.pe_conv_grad_2d(torch.from_numpy(xn), torch.from_numpy(dyn),
                              KH=K, KW=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pe_conv_grad_alexnet_shaped_padded():
    """An AlexNet-conv1-shaped case (C=8, D=12, K=5, pad 2) through the
    wrapper's padding, against the Pallas kernel on the padded input."""
    rng = np.random.RandomState(5)
    B, C, D, HW, K, P = 2, 8, 12, 9, 5, 2
    xn = rng.randn(B, C, HW, HW).astype(np.float32)
    dyn = rng.randn(B, D, HW, HW).astype(np.float32)
    xp = np.pad(xn, ((0, 0), (0, 0), (P, P), (P, P)))
    want = jax_pe_conv_grad_2d(jnp.asarray(xp), jnp.asarray(dyn), KH=K, KW=K,
                               interpret=True)
    got = ops.pe_conv_grad(torch.from_numpy(xn), torch.from_numpy(dyn),
                           kernel_spatial=(K, K), padding=P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 3, 6, 6)
    with pytest.raises(ValueError):
        ops.pe_conv_grad_2d(x, torch.zeros(2, 4, 5, 5), KH=3, KW=3)
    with pytest.raises(TypeError):
        ops.gram_norm(torch.zeros(2, 4, 3, dtype=torch.float64),
                      torch.zeros(2, 4, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.gram_norm(torch.zeros(2, 4, 3), torch.zeros(2, 5, 5))
    with pytest.raises(NotImplementedError):
        ops.pe_conv_grad(torch.zeros(2, 3, 8), torch.zeros(2, 4, 6),
                         kernel_spatial=(3,))
    with pytest.raises(ValueError):
        ops.gram_norm_fused(torch.zeros(2, 4, 3), torch.zeros(2, 4, 5),
                            torch.zeros(3))
    with pytest.raises(TypeError):
        ops.gram_norm_fused(torch.zeros(2, 4, 3),
                            torch.zeros(2, 4, 5, dtype=torch.bfloat16),
                            torch.zeros(2))


@pytest.mark.parametrize("call", [
    lambda x, dy: ops.gram_norm(x, dy),
    lambda x, dy: ops.gram_norm_fused(x, dy, torch.ones(2, device="meta")),
    lambda x, dy: ops.pe_conv_grad_2d(x.reshape(2, 1, 4, 3),
                                      x.reshape(2, 1, 4, 3), KH=1, KW=1)],
    ids=["gram_norm", "gram_norm_fused", "pe_conv_grad_2d"])
def test_wrappers_raise_off_cpu_and_cuda(call):
    """One dispatch rule for every wrapper: a tensor on neither the CPU
    nor a CUDA card has no kernel and no plain fallback."""
    x = torch.empty(2, 4, 3, device="meta")
    dy = torch.empty(2, 4, 5, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        call(x, dy)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the kernels there")


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
