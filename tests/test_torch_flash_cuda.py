"""The flash kernels on the card (tests marked ``cuda``; they skip
without one), and the tolerance they are held to (on the CPU).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_flash_cuda.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX).  The plain
versions these kernels are held against are themselves held against the
JAX package in ``tests/test_torch_attention.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the kernels there")


def _worst(got, want):
    """The largest error as a multiple of its bound: per entry rtol 1e-4
    for an f32 output, 1e-2 for bf16 (one rounding flip), plus 1e-5 of
    the largest entry; a bf16 output also gets 4 bf16 ulps of its row's
    RMS (the forward rounds P to bf16 tile by tile against the running
    max, the plain version once; see the test below)."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = (1e-2 if bf16 else 1e-4) * want.abs() \
        + 1e-5 * want.abs().max()
    if bf16:
        rms = want.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
        bound = bound + 4 * torch.exp2(torch.floor(torch.log2(rms)) - 7)
    return (err / bound).max().item()


def _close(got, want):
    worst = _worst(got, want)
    assert worst <= 1, (f"error {worst:.3g} x its bound "
                        f"({'bf16' if got.dtype == torch.bfloat16 else 'f32'})")


def _tiled_fwd(q, k, v, fault=None, tile=64):
    """The forward kernel's arithmetic in plain PyTorch (causal, rep 1):
    online softmax over key tiles, P cast to v's dtype against the running
    max.  ``fault`` breaks it: "drop_last" skips the last key tile,
    "rescale" puts 3 % on the fourth tile's P."""
    B, T, H, hd = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * hd ** -0.5
    s = s.masked_fill(torch.arange(T)[None] > torch.arange(T)[:, None],
                      -1e30)
    m = torch.full((B, H, T, 1), -1e30)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, hd)
    for i, k0 in enumerate(range(0, T, tile)):
        if fault == "drop_last" and k0 + tile >= T:
            continue
        st = s[..., k0:k0 + tile]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        a, p = torch.exp(m - mn), torch.exp(st - mn)
        l = l * a + p.sum(-1, keepdim=True)
        pv = p * 1.03 if (fault == "rescale" and i == 3) else p
        acc = acc * a + torch.einsum("bhts,bshd->bhtd",
                                     pv.to(v.dtype).float(),
                                     v[:, k0:k0 + tile].float())
        m = mn
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def test_bf16_bound_admits_tile_rounding_and_rejects_faults():
    """CPU: the bf16 bound above passes the forward kernel's own rounding
    against the plain version, with room to spare, and fails a forward
    that drops a key tile or mis-scales one tile's P by 3 %."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 512, 4, 64, generator=g).bfloat16()
               for _ in range(3))
    want = ref.flash_fwd_ref(q, k, v, causal=True)[0]
    assert _worst(_tiled_fwd(q, k, v), want) <= 0.6
    assert _worst(_tiled_fwd(q, k, v, "drop_last"), want) > 10
    assert _worst(_tiled_fwd(q, k, v, "rescale"), want) > 1.5


@pytest.mark.cuda
def test_cuda_flash_kernels_match_ref():
    """Card only: forward, dq and dk/dv against their plain versions for
    rep 1 / 4, causal and full, a ragged T, to ``_close``'s bound; the
    autograd Function launches each kernel once; two dk/dv launches are
    bitwise equal."""
    _needs_card()
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for B, T, H, Hkv, hd, causal in ((2, 100, 4, 1, 64, True),
                                         (2, 64, 8, 2, 32, False),
                                         (1, 130, 4, 4, 128, True)):
            q, k, v, do = (torch.randn(*s, generator=g).to("cuda", dt)
                           for s in ((B, T, H, hd), (B, T, Hkv, hd),
                                     (B, T, Hkv, hd), (B, T, H, hd)))
            o, lse = ops.flash_fwd(q, k, v, causal=causal)
            ro, rl = ref.flash_fwd_ref(q, k, v, causal=causal)
            bwd = (q, k, v, do, lse, ops.flash_delta(o, do))
            got = [o, lse, ops.flash_dq(*bwd, causal=causal),
                   *ops.flash_dkv(*bwd, causal=causal)]
            want = [ro, rl, ref.flash_dq_ref(*bwd, causal=causal),
                    *ref.flash_dkv_ref(*bwd, causal=causal)]
            for a, b in zip(got, want):
                _close(a, b)
            again = ops.flash_dkv(*bwd, causal=causal)
            assert all(torch.equal(a, b) for a, b in zip(got[3:], again))
            n0 = dict(ops.LAUNCHES)
            qa = q.detach().requires_grad_(True)
            out = ops.flash_attention(qa, k, v, causal=causal)
            out.backward(do)
            assert {n: ops.LAUNCHES[n] - n0[n] for n in
                    ("flash_fwd", "flash_dq", "flash_dkv")} == \
                {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
