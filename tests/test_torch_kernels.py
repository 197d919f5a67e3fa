"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions
(``repro_torch.kernels.ref``); those are held here against the Pallas
kernels run in interpret mode, exactly as ``tests/test_kernels.py`` runs
them, over the same shape and dtype sweep.  The CUDA kernels themselves
run only on the card: ``tests/test_torch_kernels_cuda.py`` (free of JAX,
so it runs on the machine with the card) checks them there and skips
elsewhere, and ``chip_smoke.py`` holds them against the plain versions at
the main path's shapes.

Tolerances: f32 rtol 2e-5 for the Gram norms (sums over up to T² terms
in another order), 1e-5 for the conv gradients and for the fused
kernel's norms and contributions (atol 1e-5 on contribution entries near
zero); bf16 rtol 5e-2 (the Pallas kernel multiplies in bf16 before
accumulating, the port casts to f32 first).  ``pe_conv_grad_1d``: f32
rtol 1e-5, atol 1e-5; bf16 rtol 1e-2 (the inputs are rounded to bf16 once,
the products and sums run in f32 on both sides).  ``gram_norm_tokmask``:
rtol 1e-4, as ``tests/test_kernels.py`` holds the Pallas kernel to its
reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gram_norm import gram_norm as jax_gram_norm  # noqa: E402
from repro.kernels.gram_norm import (  # noqa: E402
    gram_norm_fused as jax_gram_norm_fused)
from repro.kernels.gram_norm import (  # noqa: E402
    gram_norm_tokmask as jax_gram_norm_tokmask)
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.pe_conv_grad import (  # noqa: E402
    pe_conv_grad_1d as jax_pe_conv_grad_1d)
from repro.kernels.pe_conv_grad import (  # noqa: E402
    pe_conv_grad_2d as jax_pe_conv_grad_2d)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convops  # noqa: E402

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
    with pytest.raises(ValueError):
        ops.pe_conv_grad_1d(torch.zeros(2, 3, 8), torch.zeros(2, 4, 5), K=3)
    with pytest.raises(ValueError):
        ops.gram_norm_tokmask(torch.zeros(2, 5, dtype=torch.long),
                              torch.zeros(2, 4, 3))
    with pytest.raises(TypeError):
        ops.gram_norm_tokmask(torch.zeros(2, 4), torch.zeros(2, 4, 3))
    with pytest.raises(ValueError, match="int32"):
        ops.gram_norm_tokmask(torch.full((2, 4), 2 ** 31),
                              torch.zeros(2, 4, 3))
    edge = torch.tensor([[2 ** 31 - 1, -2 ** 31]], dtype=torch.int32)
    assert ops.gram_norm_tokmask(edge, torch.ones(1, 2, 3)).item() == 6.0
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
                                      x.reshape(2, 1, 4, 3), KH=1, KW=1),
    lambda x, dy: ops.pe_conv_grad_1d(x, x, K=1),
    lambda x, dy: ops.gram_norm_tokmask(
        torch.zeros(2, 4, dtype=torch.long, device="meta"), dy)],
    ids=["gram_norm", "gram_norm_fused", "pe_conv_grad_2d",
         "pe_conv_grad_1d", "gram_norm_tokmask"])
def test_wrappers_raise_off_cpu_and_cuda(call):
    """One dispatch rule for every wrapper: a tensor on neither the CPU
    nor a CUDA card has no kernel and no plain fallback."""
    x = torch.empty(2, 4, 3, device="meta")
    dy = torch.empty(2, 4, 5, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        call(x, dy)


@pytest.mark.parametrize("shape", [(2, 5, 6, 20, 3), (1, 3, 8, 33, 5),
                                   (4, 2, 2, 9, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pe_conv_grad_1d_ref_vs_pallas(shape, dtype):
    """The JAX kernel test's sweep (``tests/test_kernels.py``)."""
    B, C, D, T, K = shape
    rng = np.random.RandomState(sum(shape))
    xn = rng.randn(B, C, T).astype(np.float32)
    dyn = rng.randn(B, D, T - K + 1).astype(np.float32)
    want = jax_pe_conv_grad_1d(jnp.asarray(xn, JAX_DT[dtype]),
                               jnp.asarray(dyn, JAX_DT[dtype]), K=K,
                               interpret=True)
    before = dict(ops.LAUNCHES)
    got = ops.pe_conv_grad_1d(torch.from_numpy(xn).to(TORCH_DT[dtype]),
                              torch.from_numpy(dyn).to(TORCH_DT[dtype]), K=K)
    assert ops.LAUNCHES == before        # CPU tensors never launch
    assert got.dtype == torch.float32 and got.shape == (B, D, C, K)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-5)


# Every 1-D case of tests/test_conv_trick.py (B, C, D, T, K, stride,
# dilation, padding, groups), then a plain padded one.  Only plain convs
# reach the kernel's plain version; the rest take the grouped-conv
# lowering in both packages.
CONV_TRICK_1D = [(3, 4, 6, 16, 3, 1, 1, 0, 1), (2, 4, 6, 17, 5, 2, 1, 2, 1),
                 (2, 4, 6, 19, 3, 1, 2, 1, 1), (2, 6, 9, 16, 3, 2, 2, 2, 3),
                 (4, 8, 8, 21, 4, 3, 2, 3, 4), (1, 2, 2, 8, 2, 1, 1, 1, 2),
                 (2, 4, 6, 17, 5, 1, 1, 2, 1)]


@pytest.mark.parametrize("case", CONV_TRICK_1D)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pe_conv_grad_1d_dispatch_vs_jax(case, dtype):
    """``convops.pe_conv_grad(impl="pallas")`` against the JAX package's
    ``kernels.ops.pe_conv_grad`` (Pallas in interpret mode for plain
    convs, its grouped-conv fallback otherwise), padding done by the
    wrappers."""
    B, C, D, T, K, s, r, p, g = case
    rng = np.random.RandomState(sum(case))
    Tp = (T + 2 * p - r * (K - 1) - 1) // s + 1
    xn = rng.randn(B, C, T).astype(np.float32)
    dyn = rng.randn(B, D, Tp).astype(np.float32)
    kw = dict(kernel_spatial=(K,), stride=s, dilation=r, padding=p,
              groups=g)
    want = jax_ops.pe_conv_grad(jnp.asarray(xn, JAX_DT[dtype]),
                                jnp.asarray(dyn, JAX_DT[dtype]), **kw)
    got = convops.pe_conv_grad(torch.from_numpy(xn).to(TORCH_DT[dtype]),
                               torch.from_numpy(dyn).to(TORCH_DT[dtype]),
                               impl="pallas", **kw)
    assert tuple(got.shape) == (B, D, C // g, K)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=1e-5)


@pytest.mark.parametrize("bt", [8, 16, 64])
@pytest.mark.parametrize("T,V", [(33, 7), (70, 3), (64, 1000)])
def test_gram_norm_tokmask_ref_vs_pallas(bt, T, V):
    """The JAX kernel test's inputs (ids from a range of 7, heavily
    repeated) and ragged T against every ``bt``, plus a tile-exact T
    with rarely repeated ids."""
    rng = np.random.RandomState(bt + T)
    ids = rng.randint(0, V, (2, T))
    dyn = rng.randn(2, T, 9).astype(np.float32)
    want = jax_gram_norm_tokmask(jnp.asarray(ids), jnp.asarray(dyn), bt=bt,
                                 interpret=True)
    before = dict(ops.LAUNCHES)
    got = ops.gram_norm_tokmask(torch.from_numpy(ids), torch.from_numpy(dyn))
    assert ops.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
