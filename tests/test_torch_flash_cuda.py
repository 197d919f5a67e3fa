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


def _tiled_fwd(q, k, v, fault=None, design="fma"):
    """The forward kernel's arithmetic in plain PyTorch (causal, rep 1):
    online softmax over 64-key tiles, P cast to v's dtype against the
    running max.  ``design`` "fma" takes the max of the scaled scores and
    P = exp(s * scale - m); "wgmma" takes the max of the raw scores and
    P = 2^(s * c - m * c) with c = scale * log2(e).  ``fault`` breaks it:
    "drop_last" skips the last key tile, "rescale" puts 3 % on the fourth
    tile's P."""
    B, T, H, hd = q.shape
    tile, scale = 64, hd ** -0.5
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if design == "fma":
        s, c = s * scale, None
    else:
        c = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
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
        if c is None:
            a, p = torch.exp(m - mn), torch.exp(st - mn)
        else:
            a, p = torch.exp2((m - mn) * c), torch.exp2(st * c - mn * c)
        l = l * a + p.sum(-1, keepdim=True)
        pv = p * 1.03 if (fault == "rescale" and i == 3) else p
        acc = acc * a + torch.einsum("bhts,bshd->bhtd",
                                     pv.to(v.dtype).float(),
                                     v[:, k0:k0 + tile].float())
        m = mn
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


# Both designs of the forward walk 64-key tiles and round P to bf16 once
# a tile; they differ in where the scale enters the exponent.
@pytest.mark.parametrize("design", ["fma", "wgmma"])
def test_bf16_bound_admits_tile_rounding_and_rejects_faults(design):
    """CPU: the bf16 bound above passes the forward kernel's own rounding
    (P rounded to bf16 once a key tile, against the running max) against
    the plain version, with room to spare, and fails a forward that drops
    a key tile or mis-scales one tile's P by 3 %."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 512, 4, 64, generator=g).bfloat16()
               for _ in range(3))
    want = ref.flash_fwd_ref(q, k, v, causal=True)[0]
    assert _worst(_tiled_fwd(q, k, v, design=design), want) <= 0.6
    assert _worst(_tiled_fwd(q, k, v, "drop_last", design), want) > 10
    assert _worst(_tiled_fwd(q, k, v, "rescale", design), want) > 1.5


def _tiled_dq(q, k, v, do, lse, delta, fault=None):
    """The dq kernel's arithmetic in plain PyTorch (rep 1): dS of each
    64-key tile from the saved lse as P = 2^(s * c - lse * log2(e)),
    rounded to k's dtype, and dq summed over the tiles in order.
    ``fault`` breaks it: "drop_last" skips the last key tile the causal
    mask reaches, "diagonal" puts the causal diagonal one key late (each
    query also sees the next key)."""
    B, T, H, hd = q.shape
    tile, scale = 64, hd ** -0.5
    c = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    shift = 1 if fault == "diagonal" else 0
    masked = torch.arange(T)[None] > torch.arange(T)[:, None] + shift
    s = s.masked_fill(masked, -1e30)
    p = torch.exp2(s * c - lse[..., None] * 1.4426950408889634)
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype).float()
    dq = torch.zeros(B, H, T, hd)
    for k0 in range(0, T, tile):
        if fault == "drop_last" and k0 + tile >= T:
            continue
        dq = dq + torch.einsum("bhts,bshd->bhtd", ds[..., k0:k0 + tile],
                               k[:, k0:k0 + tile].float())
    return dq.transpose(1, 2).to(q.dtype)


def test_dq_bound_admits_tile_order_and_rejects_faults():
    """CPU: the bound above passes the dq kernel's own arithmetic (P from
    the saved lse in base 2, dS rounded to bf16, dq summed over 64-key
    tiles in order) against the plain version, and fails a dq walk that
    drops a key tile or misplaces the causal diagonal."""
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(1, 512, 4, 64, generator=g).bfloat16()
                   for _ in range(4))
    o, lse = ref.flash_fwd_ref(q, k, v, causal=True)
    delta = ref.flash_delta(o, do)
    want = ref.flash_dq_ref(q, k, v, do, lse, delta, causal=True)
    assert _worst(_tiled_dq(q, k, v, do, lse, delta), want) <= 0.6
    assert _worst(_tiled_dq(q, k, v, do, lse, delta, "drop_last"),
                  want) > 10
    assert _worst(_tiled_dq(q, k, v, do, lse, delta, "diagonal"), want) > 10


# The calls csrc/flash_attn.cu runs on the tensor cores: bf16 forward, dq
# and dk/dv at head_dim 64 and 128.  Every other call takes the fma design.
WGMMA_CALLS = {("flash_fwd", 64), ("flash_fwd", 128), ("flash_dq", 64),
               ("flash_dq", 128), ("flash_dkv", 64), ("flash_dkv", 128)}


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_flash_design_names_the_route(which, dtype, hd):
    """CPU: ``flash_design`` over every (kernel, dtype, head_dim) the
    wrappers admit."""
    dt = getattr(torch, dtype)
    want = ("wgmma" if dt == torch.bfloat16 and (which, hd) in WGMMA_CALLS
            else "fma")
    assert ops.flash_design(which, dt, hd) == want


def test_flash_design_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError):
        ops.flash_design("flash_bwd", torch.bfloat16, 64)
    with pytest.raises(TypeError):
        ops.flash_design("flash_fwd", torch.float16, 64)
    with pytest.raises(NotImplementedError):
        ops.flash_design("flash_fwd", torch.bfloat16, 96)


def test_flash_second_derivative_raises():
    """The flash backward is once differentiable: a second derivative
    through it raises rather than coming out zero (CPU, plain version)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g, requires_grad=True)
               for _ in range(3))
    o = ops.flash_attention(q, k, v)
    dq, = torch.autograd.grad(o.square().sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        dq.sum().backward()


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


# (B, T, H, Hkv, hd, causal) of the wgmma cases: T a multiple of the
# forward's 128-row query tile and ragged (130, 1000), causal and full,
# rep 1 and 4, head_dim 64 and 128, and one case with enough (B, H)
# blocks to fill the card.
WGMMA_CASES = [(2, 256, 4, 4, 64, True), (2, 256, 8, 2, 64, False),
               (2, 130, 4, 1, 64, True), (1, 1000, 4, 4, 64, False),
               (1, 1000, 8, 2, 64, True), (2, 256, 4, 4, 128, True),
               (2, 130, 4, 1, 128, False), (1, 1000, 4, 1, 128, True),
               (4, 1024, 32, 32, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: "B{}_T{}_H{}_Hkv{}_hd{}_{}".format(
                             *c[:5], "causal" if c[5] else "full"))
def test_cuda_wgmma_kernels_match_ref(case):
    """Card only: the bf16 forward, dq and dk/dv on the tensor cores
    against their plain versions, to ``_close``'s bound; all three bitwise
    repeatable, one count a call; the library names the design the
    wrapper does."""
    _needs_card()
    from repro_torch.kernels import build
    B, T, H, Hkv, hd, causal = case
    lib = build.load("flash_attn")
    for which, name in enumerate(("flash_fwd", "flash_dq", "flash_dkv")):
        for dt in (torch.float32, torch.bfloat16):
            design = ops.flash_design(name, dt, hd)
            assert lib.repro_flash_design(which, hd, int(
                dt == torch.bfloat16)) == (design == "wgmma")
    assert ops.flash_design("flash_fwd", torch.bfloat16, hd) == "wgmma"
    assert ops.flash_design("flash_dq", torch.bfloat16, hd) == "wgmma"
    assert ops.flash_design("flash_dkv", torch.bfloat16, hd) == "wgmma"
    assert ops.flash_design("flash_fwd", torch.float32, hd) == "fma"
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(*s, generator=g).to("cuda", torch.bfloat16)
                   for s in ((B, T, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd),
                             (B, T, H, hd)))
    o, lse = ops.flash_fwd(q, k, v, causal=causal)
    o2, lse2 = ops.flash_fwd(q, k, v, causal=causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rl = ref.flash_fwd_ref(q, k, v, causal=causal)
    _close(o, ro)
    _close(lse, rl)
    del ro, rl
    bwd = (q, k, v, do, lse, ops.flash_delta(o, do))
    n0 = ops.LAUNCHES["flash_dq"]
    dq = ops.flash_dq(*bwd, causal=causal)
    dq2 = ops.flash_dq(*bwd, causal=causal)
    assert ops.LAUNCHES["flash_dq"] == n0 + 2
    assert torch.equal(dq, dq2)
    _close(dq, ref.flash_dq_ref(*bwd, causal=causal))
    dk, dv = ops.flash_dkv(*bwd, causal=causal)
    dk2, dv2 = ops.flash_dkv(*bwd, causal=causal)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rdk, rdv = ref.flash_dkv_ref(*bwd, causal=causal)
    _close(dk, rdk)
    _close(dv, rdv)


@pytest.mark.cuda
def test_cuda_wgmma_reads_unaligned_rows():
    """Card only: inputs whose rows do not start 16-byte aligned (a view
    at an odd offset) reach the wgmma kernels through an aligned copy and
    give the same outputs, at head_dim 64 and 128."""
    _needs_card()
    g = torch.Generator().manual_seed(2)
    for hd in (64, 128):
        B, T, H = 1, 192, 2
        flat = torch.randn(4 * B * T * H * hd + 1, generator=g).to(
            "cuda", torch.bfloat16)
        q, k, v, do = (flat[1 + i * B * T * H * hd:
                            1 + (i + 1) * B * T * H * hd].view(B, T, H, hd)
                       for i in range(4))
        assert q.data_ptr() % 16 and do.data_ptr() % 16
        o, lse = ops.flash_fwd(q, k, v, causal=True)
        qc, kc, vc, dc = (t.clone() for t in (q, k, v, do))
        oc, lc = ops.flash_fwd(qc, kc, vc, causal=True)
        assert torch.equal(o, oc) and torch.equal(lse, lc)
        delta = ops.flash_delta(o, do)
        got = (ops.flash_dq(q, k, v, do, lse, delta, causal=True),
               *ops.flash_dkv(q, k, v, do, lse, delta, causal=True))
        want = (ops.flash_dq(qc, kc, vc, dc, lse, delta, causal=True),
                *ops.flash_dkv(qc, kc, vc, dc, lse, delta, causal=True))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_fma_only_times_the_fma_design():
    """Card only: while ``repro_flash_fma_only`` is set, bf16 forward, dq
    and dk/dv calls at head_dim 64 take the fma design (chip_smoke.py
    times it as the earlier design), which also passes ``_close``'s
    bound; the wgmma design takes them again once it is cleared."""
    _needs_card()
    from repro_torch.kernels import build
    lib = build.load("flash_attn")
    g = torch.Generator().manual_seed(3)
    B, T, H, hd = 2, 256, 4, 64
    q, k, v, do = (torch.randn(B, T, H, hd, generator=g).to(
        "cuda", torch.bfloat16) for _ in range(4))
    o, lse = ops.flash_fwd(q, k, v, causal=True)
    bwd = (q, k, v, do, lse, ops.flash_delta(o, do))
    dq = ops.flash_dq(*bwd, causal=True)
    dk, dv = ops.flash_dkv(*bwd, causal=True)
    lib.repro_flash_fma_only(1)
    try:
        fo, fl = ops.flash_fwd(q, k, v, causal=True)
        fdq = ops.flash_dq(*bwd, causal=True)
        fdk, fdv = ops.flash_dkv(*bwd, causal=True)
    finally:
        lib.repro_flash_fma_only(0)
    ro, rl = ref.flash_fwd_ref(q, k, v, causal=True)
    rdq = ref.flash_dq_ref(*bwd, causal=True)
    rdk, rdv = ref.flash_dkv_ref(*bwd, causal=True)
    for got, want in ((fo, ro), (fl, rl), (fdq, rdq), (fdk, rdk),
                      (fdv, rdv)):
        _close(got, want)
    o2, lse2 = ops.flash_fwd(q, k, v, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(dq, ops.flash_dq(*bwd, causal=True))
    assert all(torch.equal(a, b) for a, b in
               zip((dk, dv), ops.flash_dkv(*bwd, causal=True)))


# (B, T, S, H, Hkv, hd) of full attention with a key length S other than
# the query length T, as cross attention calls it (the source's length):
# S = T/2, S = 2T, a ragged T over a ragged S, at head_dim 64 (bf16 on
# the wgmma design, f32 on the fma one) and 32 (fma for both).
CROSS_CASES = [(2, 256, 128, 4, 4, 64), (2, 128, 256, 4, 2, 64),
               (1, 100, 260, 4, 1, 64), (2, 130, 70, 4, 4, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES,
                         ids=lambda c: "B{}_T{}_S{}_H{}_Hkv{}_hd{}".format(
                             *c))
def test_cuda_full_attention_other_key_lengths(case):
    """Card only: full (non-causal) forward, dq and dk/dv with S != T
    against their plain versions, to ``_close``'s bound, f32 and bf16,
    each design its route takes; ``flash_attention`` through autograd
    launches each kernel once."""
    _needs_card()
    B, T, S, H, Hkv, hd = case
    g = torch.Generator().manual_seed(4)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(*s, generator=g).to("cuda", dt)
                       for s in ((B, T, H, hd), (B, S, Hkv, hd),
                                 (B, S, Hkv, hd), (B, T, H, hd)))
        o, lse = ops.flash_fwd(q, k, v, causal=False)
        ro, rl = ref.flash_fwd_ref(q, k, v, causal=False)
        _close(o, ro)
        _close(lse, rl)
        bwd = (q, k, v, do, lse, ops.flash_delta(o, do))
        _close(ops.flash_dq(*bwd, causal=False),
               ref.flash_dq_ref(*bwd, causal=False))
        for a, b in zip(ops.flash_dkv(*bwd, causal=False),
                        ref.flash_dkv_ref(*bwd, causal=False)):
            _close(a, b)
        n0 = dict(ops.LAUNCHES)
        qa = q.detach().requires_grad_(True)
        ops.flash_attention(qa, k, v, causal=False).backward(do)
        assert {n: ops.LAUNCHES[n] - n0[n] for n in
                ("flash_fwd", "flash_dq", "flash_dkv")} == \
            {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


@pytest.mark.cuda
def test_cuda_key_length_must_divide_key_blocks():
    """Card only: a key length that does not divide into ``bk`` keys
    (S = 600 > 512) raises ``FlashShapeError`` before any launch, as the
    JAX wrapper's contract says; keys are not padded."""
    _needs_card()
    q = torch.randn(1, 64, 2, 64, device="cuda")
    k = torch.randn(1, 600, 2, 64, device="cuda")
    n0 = dict(ops.LAUNCHES)
    with pytest.raises(ops.FlashShapeError, match="S=600"):
        ops.flash_attention(q, k, k, causal=False)
    assert ops.LAUNCHES == n0
