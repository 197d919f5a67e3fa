"""How ``gram_norm`` and ``gram_norm_fused`` plan a call on the card, on
the CPU: the route per shape (``ops.gram_route``), the T-split of the
direct route (``ops.direct_splits``), how each operand is staged
(``ops._staging``), and the kinds' batched products that replace their
two-operand einsums on the card (``kinds._BMM``).

The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``); these are the
pure-Python decisions around them.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import kinds  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gram_route_at_alexnet_layers():
    """The product at conv0 and conv1, the symmetric Gram at conv2-4,
    rank-1 at the three fc layers: the routes ``chip_smoke.py`` reports."""
    cases = _smoke().GRAM_CASES
    got = [ops.gram_route(t, di, do) for _, t, di, do in cases]
    assert got == ["direct", "direct", "gram", "gram", "gram",
                   "rank1", "rank1", "rank1"]


@pytest.mark.parametrize("di,do", [(1, 1), (3, 5000), (12544, 4096),
                                   (4096, 1000), (70, 33)])
def test_gram_route_is_rank1_at_t1(di, do):
    assert ops.gram_route(1, di, do) == "rank1"


# Ragged shapes around the tiles (64-row Gram tiles, 128 x 64 product
# tiles, 32-deep steps) and far from them.
RAGGED = [(2, 70, 33), (63, 1, 1), (65, 90, 100), (65, 500, 300),
          (100, 70, 33), (129, 3, 7), (225, 1000, 200), (225, 300, 130),
          (961, 1600, 192), (3000, 100, 60), (4096, 17, 4000),
          (17, 4000, 4000), (300, 5, 5)]


def _pad(n, m):
    return -(-n // m) * m


@pytest.mark.parametrize("t,di,do", RAGGED)
def test_gram_route_is_sensible_at_ragged_shapes(t, di, do):
    """The route with fewer multiply-adds on the kernels' padded tiles is
    picked; and where the shape fills the tiles (every side at least 64)
    and one contraction is at least twice as cheap as the other in exact
    multiply-adds, that one."""
    route = ops.gram_route(t, di, do)
    n_t = -(-t // 64)
    padded = {"direct": _pad(di, 128) * _pad(do, 64) * _pad(t, 32),
              "gram": n_t * (n_t + 1) // 2 * 64 * 64
              * (_pad(di, 32) + _pad(do, 32))}
    assert padded[route] == min(padded.values())
    exact = {"direct": t * di * do, "gram": t * (t + 1) // 2 * (di + do)}
    other = "gram" if route == "direct" else "direct"
    if min(t, di, do) >= 64:
        assert exact[route] < 2 * exact[other]


@pytest.mark.parametrize("shape", [(0, 3, 4), (5, 0, 4), (5, 3, 0)])
def test_gram_route_rejects_empty_shapes(shape):
    with pytest.raises(ValueError, match="positive"):
        ops.gram_route(*shape)


@pytest.mark.parametrize("b,t,n_tiles,sms", [
    (32, 3969, 3, 132), (32, 961, 39, 132), (2, 3000, 1, 132),
    (1, 100, 1, 132), (8, 70, 1, 1), (4, 65536, 2, 132)])
def test_direct_splits_cover_t(b, t, n_tiles, sms):
    """Chunks are multiples of 64 rows, cover T exactly once and leave
    none empty; at least 256 rows a chunk once T is cut."""
    s, chunk = ops.direct_splits(b, t, n_tiles, sms)
    assert s >= 1 and chunk % 64 == 0
    assert (s - 1) * chunk < t <= s * chunk
    if s > 1:
        assert chunk >= 256


def test_direct_splits_at_alexnet_conv0_and_conv1():
    """AlexNet at B = 32 on 132 SMs: conv0's 96 tile blocks are cut 8
    ways (768 blocks, three full waves), conv1's 1248 are enough alone."""
    assert ops.direct_splits(32, 3969, 3, 132) == (8, 512)
    assert ops.direct_splits(32, 961, 39, 132) == (1, 1024)


@pytest.mark.parametrize("b,n_tiles,sms,want", [
    (32, 84, 132, 3), (32, 108, 132, 16), (32, 72, 132, 11),
    (1, 5, 132, 1), (3, 1, 132, 3), (8, 264, 132, 1)])
def test_fused_groups(b, n_tiles, sms, want):
    """AlexNet's conv2-4 at B = 32 on 132 SMs: the group count with the
    fewest (waves x examples a group); groups are never empty."""
    g = ops.fused_groups(b, n_tiles, sms)
    assert g == want
    bg = -(-b // g)
    assert (g - 1) * bg < b <= g * bg


def test_staging_of_each_layout():
    """tmajor names the contiguous axis; 16-byte copies only where every
    row is 16-byte aligned, else 4-byte copies (f32) or plain loads
    (bf16)."""
    f32, bf16 = torch.float32, torch.bfloat16
    # AlexNet's im2col views: T contiguous, T odd.
    assert ops._staging(torch.zeros(2, 363, 3969).transpose(1, 2)) == \
        (True, 4)
    assert ops._staging(torch.zeros(2, 64, 256).transpose(1, 2)) == \
        (True, 16)
    assert ops._staging(torch.zeros(2, 5, 64, dtype=f32)) == (False, 16)
    assert ops._staging(torch.zeros(2, 5, 33, dtype=f32)) == (False, 4)
    assert ops._staging(torch.zeros(2, 5, 64, dtype=bf16)) == (False, 16)
    assert ops._staging(torch.zeros(2, 5, 36, dtype=bf16)) == (False, 0)
    # Neither axis contiguous.
    assert ops._staging(torch.zeros(2, 5, 16)[..., ::2]) == (False, 4)
    assert ops._staging(torch.zeros(2, 5, 16, dtype=bf16)[..., ::2]) == \
        (False, 0)
    # T = 1: the fc layers' rows.
    assert ops._staging(torch.zeros(3, 1, 12544)) == (False, 16)


@pytest.mark.parametrize("eq", sorted(kinds._BMM))
def test_kinds_bmm_forms_equal_their_einsums(eq):
    """Each equation the kinds hand to a bf16 GEMM on the card is mapped
    onto the one batched product it names (checked here in f32)."""
    rng = np.random.default_rng(len(eq))
    lhs = eq.split("->")[0].split(",")
    sizes = {"b": 3, "t": 5, "s": 4, "i": 6, "o": 7, "d": 8}
    a, b = (torch.from_numpy(rng.standard_normal(
        [sizes[c] for c in side]).astype(np.float32)) for side in lhs)
    got = torch.bmm(*kinds._BMM[eq](a, b))
    torch.testing.assert_close(got, torch.einsum(eq, a, b), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(kinds._ee2(eq, a, b), kinds._ee(eq, a, b),
                               rtol=0, atol=0)


@pytest.mark.parametrize("t, want", [(1, "sorted"), (1024, "sorted"),
                                     (16384, "sorted"), (16385, "gram"),
                                     (32768, "gram")])
def test_tokmask_route_by_the_sort_cap(t, want):
    """``gram_norm_tokmask`` sorts up to 16 384 (id, t) pairs an example
    in shared memory (the segment-sum route); above, it keeps the
    masked-Gram tiles, so no T it took before is refused."""
    assert ops.tokmask_route(t) == want


def test_tokmask_route_rejects_empty_t():
    with pytest.raises(ValueError):
        ops.tokmask_route(0)


def test_pe_conv_design_by_dtype():
    assert ops.pe_conv_design(torch.float32) == "3xtf32-wgmma"
    assert ops.pe_conv_design(torch.bfloat16) == "bf16-wgmma"
    with pytest.raises(TypeError):
        ops.pe_conv_design(torch.float16)
