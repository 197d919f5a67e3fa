"""The conv-gradient and ghost-norm kernels on the card (tests marked
``cuda``; they skip without one), against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py tests/test_torch_flash_cuda.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX).  The plain
versions are themselves held against the JAX package's Pallas kernels in
``tests/test_torch_kernels.py``.  Tolerance: the conv gradients are held
to ``kernels/bounds.py``'s rule, |got − exact| ≤ 2⁻²⁴·√n·Σ|x|·|δy| entry
by entry against the f64 product over the n = H′W′ or T′ terms of the
sum (the plain versions compute ``exact`` and Σ|x|·|δy| from f64
inputs); the norms to rtol 1e-4 of the plain version (f32 sums in another
order; bf16 inputs, f32 arithmetic).  Every kernel must repeat bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bounds, ops, ref  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the kernels there")


def _close(got, want, rtol=1e-4):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * want.abs().max().item())


def _meets_rule(got, fn, x, dy, n):
    """``got`` against ``fn`` (a conv gradient's plain version) under
    ``bounds.sum_bound``: the exact sum and Σ|x|·|δy| in f64 over n
    terms."""
    exact = fn(x.double(), dy.double())
    absprod = fn(x.double().abs(), dy.double().abs())
    worst, ok = bounds.sum_bound(got, exact, absprod, n)
    assert ok, f"{worst:.3f}x the f32 sum bound"


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
    """Card only: both kernels against their plain versions (the conv
    gradient under the f32 sum bound; the norm to rtol 1e-4; bf16 inputs,
    f32 math)."""
    _needs_card()
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 5, 12, 12, generator=g).to("cuda", dt)
        dy = torch.randn(3, 7, 10, 10, generator=g).to("cuda", dt)
        n0 = ops.LAUNCHES["pe_conv_grad_2d"]
        got = ops.pe_conv_grad_2d(x, dy, KH=3, KW=3)
        assert ops.LAUNCHES["pe_conv_grad_2d"] == n0 + 1
        _meets_rule(got, lambda a, b: ref.pe_conv_grad_2d_ref(a, b, 3, 3),
                    x, dy, 100)
        x = torch.randn(3, 70, 9, generator=g).to("cuda", dt)
        dy = torch.randn(3, 70, 4, generator=g).to("cuda", dt)
        got = ops.gram_norm(x, dy, has_bias=True)
        torch.testing.assert_close(got, ref.gram_norm_ref(x, dy,
                                                          has_bias=True),
                                   rtol=1e-4, atol=0)


# (B, C, H, D, K) with square images: AlexNet's conv1-4 at B = 32 (x
# padded, H'W' = 961 and 225; D = 192 takes the 64 x 256 tiles, the rest
# 128 x 128), a ragged case (H'W' = 121, not a multiple of the 32-deep
# stage; D = 70 and C·K² = 27 off the tiles, C·K² not a multiple of 4),
# C·K² = 1000 over several 256-wide tiles with D = 130 on 128-row tiles,
# and the small shape above.
PE2D_SHAPES = [(32, 64, 35, 192, 5), (32, 192, 17, 384, 3),
               (32, 384, 17, 256, 3), (32, 256, 17, 256, 3),
               (3, 3, 13, 70, 3), (2, 40, 12, 130, 5), (3, 5, 12, 7, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", PE2D_SHAPES)
def test_cuda_pe_conv_grad_2d_matches_ref(shape, dtype):
    """Card only: the tensor-core kernel under the f32 sum bound (3xTF32
    for f32, bf16 products for bf16), two launches bitwise equal, one
    count a call."""
    _needs_card()
    B, C, H, D, K = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(B, C, H, H, generator=g).to("cuda", dtype)
    dy = torch.randn(B, D, H - K + 1, H - K + 1, generator=g).to("cuda",
                                                                 dtype)
    n0 = ops.LAUNCHES["pe_conv_grad_2d"]
    got = ops.pe_conv_grad_2d(x, dy, KH=K, KW=K)
    again = ops.pe_conv_grad_2d(x, dy, KH=K, KW=K)
    assert ops.LAUNCHES["pe_conv_grad_2d"] == n0 + 2
    assert got.dtype == torch.float32 and got.shape == (B, D, C, K, K)
    assert torch.equal(got, again)
    _meets_rule(got, lambda a, b: ref.pe_conv_grad_2d_ref(a, b, K, K), x, dy,
                (H - K + 1) ** 2)


# VGG16's conv0 (C·KH·KW = 27 of a 64-wide tile), conv1 (65 536-term
# sums) and conv12 at 256 px, B = 2: (name, B, C, H padded, D, K).
VGG_TILE_SHAPES = [("conv0", 2, 3, 258, 64, 3), ("conv1", 2, 64, 258, 64, 3),
                   ("conv12", 2, 512, 18, 512, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ops.PE_TILE_ROWS)
@pytest.mark.parametrize("shape", VGG_TILE_SHAPES, ids=lambda s: s[0])
def test_cuda_pe_conv_grad_2d_tiles(shape, rows):
    """Card only: every tile the calibration sweep may pick (0: the shape
    rule; 64 or 128 rows forced) at VGG16's shapes, under the f32 sum
    bound and bitwise repeatable."""
    _needs_card()
    _, B, C, H, D, K = shape
    g = torch.Generator().manual_seed(H + D)
    x = torch.randn(B, C, H, H, generator=g).to("cuda")
    dy = torch.randn(B, D, H - K + 1, H - K + 1, generator=g).to("cuda")
    got = ops.pe_conv_grad_2d(x, dy, KH=K, KW=K, tile_rows=rows)
    again = ops.pe_conv_grad_2d(x, dy, KH=K, KW=K, tile_rows=rows)
    assert torch.equal(got, again)
    _meets_rule(got, lambda a, b: ref.pe_conv_grad_2d_ref(a, b, K, K), x, dy,
                (H - K + 1) ** 2)


@pytest.mark.cuda
def test_cuda_calibrate_quick():
    """Card only: the quick harness measures finite rates on the card and
    picks its tile from its own sweep."""
    _needs_card()
    from repro_torch import calibrate
    calib = calibrate.measure(quick=True)
    assert calib.hardware == calibrate.hardware_signature("cuda")
    for rate in (calib.flops_per_second, calib.hbm_bytes_per_second):
        assert 0 < rate < float("inf")
    pe = calib.kernels["pe_conv_grad"]
    assert pe["tile_rows"] in ops.PE_TILE_ROWS
    assert str(pe["tile_rows"]) in pe["sweep"]
    assert pe["sweep"][str(pe["tile_rows"])]["seconds"] == min(
        v["seconds"] for v in pe["sweep"].values())
    assert calib.kernels["gram_norm_fused"]["seconds"] > 0
    assert calibrate.Calibration.from_json(calib.to_json()) == calib


# (B, C, D, T, K): the JAX kernel test's sweep, then a ragged case (T'
# not a multiple of the 32-deep stage, D and C·K wider than one tile)
# and the 1-D lane's first layer (C·K = 33 of a 64-wide tile); then the
# 1-D lane's five layers (B = 32, T' = 4096; chip_smoke.py's C1_LAYERS):
# D = 64 and 192 take the kernel's 64 x 64 output tiles, conv2-4
# 128 x 128 in f32 and 128 x 64 in bf16; then two ragged cases (D = 300,
# T' = 1097 odd), C·K = 28 and C·K = 500, on 128 x 128 tiles in f32 and
# 128 x 64 in bf16.
PE1D_SHAPES = [(2, 5, 6, 20, 3), (1, 3, 8, 33, 5), (4, 2, 2, 9, 2),
               (3, 70, 130, 100, 4), (2, 3, 64, 300, 11),
               (32, 3, 64, 4106, 11), (32, 64, 192, 4100, 5),
               (32, 192, 384, 4098, 3), (32, 384, 256, 4098, 3),
               (32, 256, 256, 4098, 3), (2, 7, 300, 1100, 4),
               (2, 125, 300, 1100, 4)]


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
    _meets_rule(got, lambda a, b: ref.pe_conv_grad_1d_ref(a, b, K), x, dy,
                T - K + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_cuda_pe_conv_grad_1d_empty_t(dtype):
    """Card only: with T' = 0 (T = K - 1) the gradient is zeros, and no
    kernel launches."""
    _needs_card()
    x = torch.randn(2, 3, 3, device="cuda").to(dtype)
    dy = torch.randn(2, 5, 0, device="cuda").to(dtype)
    n0 = ops.LAUNCHES["pe_conv_grad_1d"]
    got = ops.pe_conv_grad_1d(x, dy, K=4)
    assert ops.LAUNCHES["pe_conv_grad_1d"] == n0
    assert got.shape == (2, 5, 3, 4) and not got.any()


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
    _meets_rule(got, lambda a, b: ref.pe_conv_grad_1d_ref(
        torch.nn.functional.pad(a, (2, 2)), b, 5), x, dy, 17)
    dys = torch.randn(2, 6, 8, generator=g).cuda()
    ops.pe_conv_grad(x, dys, kernel_spatial=(3,), stride=2)
    assert ops.LAUNCHES["pe_conv_grad_1d"] == n0 + 1


# (B, T, D, id range): heavily repeated ids (small ranges), ragged T
# against the 64-token slices, and ids from a 128 256 vocabulary (almost
# only the diagonal matches); one id repeated T times (one segment: the
# first slice walks all of it); T = 4096 over two 1024-feature chunks;
# T just below and above the sort's cap of 16 384 pairs
# (ops.tokmask_route: the sorted route, then the masked-Gram tiles).
TOKMASK_SHAPES = [(2, 33, 9, 7), (3, 70, 5, 3), (2, 1000, 64, 16),
                  (2, 256, 128, 128256), (1, 1, 8, 4), (2, 300, 40, 1),
                  (2, 4096, 2048, 128256), (1, 16384, 8, 1000),
                  (1, 16385, 8, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", TOKMASK_SHAPES)
def test_cuda_gram_norm_tokmask_matches_ref(shape, dtype):
    _needs_card()
    B, T, D, V = shape
    assert ops.tokmask_route(T) == ("sorted" if T <= 16384 else "gram")
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


def _gram_inputs(B, T, Di, Do, layout, dtype, seed):
    """x (B, T, Di), dy (B, T, Do) on the card in one of three layouts:
    "contiguous"; "strided", the transposed views of (B, F, T) tensors the
    conv path hands over (t contiguous); "sliced", every other feature of
    a wider tensor (neither axis contiguous)."""
    g = torch.Generator().manual_seed(seed)

    def make(F):
        if layout == "strided":
            return torch.randn(B, F, T, generator=g).to("cuda",
                                                        dtype).transpose(1, 2)
        if layout == "sliced":
            return torch.randn(B, T, 2 * F, generator=g).to("cuda",
                                                            dtype)[..., ::2]
        return torch.randn(B, T, F, generator=g).to("cuda", dtype)

    return make(Di), make(Do)


# (B, T, Di, Do, layout, the route gram_route picks): T = 1 (rank-1), 64,
# 65 and 225 (both sides of the 64-row tiles), Di and Do off the tiles'
# multiples, long Ts that the direct route cuts into chunks (T-split),
# and the three layouts.
GRAM_ROUTE_CASES = [(3, 1, 130, 65, "contiguous", "rank1"),
                    (3, 1, 70, 33, "sliced", "rank1"),
                    (3, 64, 70, 33, "strided", "direct"),
                    (3, 65, 90, 100, "contiguous", "direct"),
                    (2, 65, 500, 300, "contiguous", "gram"),
                    (2, 225, 1000, 200, "strided", "gram"),
                    (2, 225, 1000, 200, "sliced", "gram"),
                    (2, 3000, 100, 60, "strided", "direct"),
                    (2, 1000, 100, 250, "strided", "direct"),
                    (2, 100, 70, 33, "sliced", "direct")]


@pytest.mark.cuda
@pytest.mark.parametrize("bias", (True, False), ids=("bias", "nobias"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("case", GRAM_ROUTE_CASES)
def test_cuda_gram_norm_routes_match_ref(case, dtype, bias):
    """Card only: every route of ``gram_norm`` against its plain version
    (rtol 1e-4: f32 sums in another order; bf16 inputs, f32 arithmetic),
    two launches bitwise equal, one count a call."""
    _needs_card()
    B, T, Di, Do, layout, route = case
    assert ops.gram_route(T, Di, Do) == route
    x, dy = _gram_inputs(B, T, Di, Do, layout, dtype, T + Di + Do)
    n0 = ops.LAUNCHES["gram_norm"]
    got = ops.gram_norm(x, dy, has_bias=bias)
    again = ops.gram_norm(x, dy, has_bias=bias)
    assert ops.LAUNCHES["gram_norm"] == n0 + 2
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.gram_norm_ref(x, dy, has_bias=bias),
                               rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_cuda_gram_norm_splits_t():
    """The T-split case above is one: its blocks cover the card only when
    T is cut into chunks."""
    _needs_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.direct_splits(2, 3000, 1, sms)[0] > 1


# (B, T, Di, Do, layout): ragged tiles, T = 1, a batch of several groups
# (AlexNet conv2's widths at a small batch), and the three layouts.
FUSED_CASES = [(3, 70, 90, 33, "strided"), (2, 1, 130, 65, "contiguous"),
               (8, 225, 1728, 384, "strided"), (4, 65, 200, 70, "sliced"),
               (5, 225, 300, 130, "contiguous"),
               (3, 100, 200, 250, "sliced")]


@pytest.mark.cuda
@pytest.mark.parametrize("bias", (True, False), ids=("bias", "nobias"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("case", FUSED_CASES)
def test_cuda_gram_norm_fused_core_matches_ref(case, dtype, bias):
    """Card only: ``gram_norm_fused`` on the per-example product core
    against its plain version; the contributions are signed sums, held to
    rtol 1e-4 of their largest entry; bitwise repeat and one count a
    call."""
    _needs_card()
    B, T, Di, Do, layout = case
    x, dy = _gram_inputs(B, T, Di, Do, layout, dtype, B + T + Di)
    w = torch.rand(B, generator=torch.Generator().manual_seed(B)).cuda()
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
@pytest.mark.parametrize("w_transposed", (False, True), ids=("io", "oi"))
def test_cuda_kinds_bf16_products_are_bf16_gemms(monkeypatch, w_transposed):
    """Card only (F1): the kinds' Gram norm and per-example gradient on
    bf16 captures run as bf16 GEMMs with f32 output (``bmm`` with
    ``out_dtype``) and equal the same calls on f32-widened captures
    (rtol 1e-5: exact products, f32 sums in another order)."""
    _needs_card()
    from repro_torch.core import kinds
    from repro_torch.core.tapper import LayerMeta

    calls = []
    real_bmm = torch.bmm

    def spy(a, b, **kw):
        calls.append((a.dtype, b.dtype, kw.get("out_dtype")))
        return real_bmm(a, b, **kw)

    monkeypatch.setattr(torch, "bmm", spy)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 96, 48, generator=g).to("cuda", torch.bfloat16)
    dy = torch.randn(4, 96, 40, generator=g).to("cuda", torch.bfloat16)
    meta = LayerMeta("dense", ("l",), param_key="w", bias_key="b",
                     w_transposed=w_transposed)

    def both(fn):
        calls.clear()
        got = fn({"x": x}, dy)
        assert calls and all(c == (torch.bfloat16, torch.bfloat16,
                                   torch.float32) for c in calls), calls
        return got, fn({"x": x.float()}, dy.float())

    got, want = both(lambda c, d: kinds.dense_norm_sq(meta, c, d,
                                                      method="gram"))
    _close(got, want, rtol=1e-5)
    got, want = both(lambda c, d: kinds.dense_pe_grad(meta, c, d))
    for k in want:
        _close(got[k], want[k], rtol=1e-5)
