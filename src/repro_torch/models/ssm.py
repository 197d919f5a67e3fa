"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM, sLSTM).

Per-example gradient coverage: all projections (in/out, conv, gates, qkv)
are tapped denses/convs; the few parameters living *inside* the
recurrence (Mamba2's A_log/dt_bias/D, sLSTM's recurrent R and gate
biases) go through the generic ``local_vjp`` kind — the layer-local VJP
is re-run per example under ``torch.func.vmap``, which is cheap because
those parameter counts are tiny.

Each recurrence is a Python loop over time in ``lax.scan``'s order, in
float32, built from functional ops only (no in-place update of a carried
state, no ``.item()``, no branch on data), so that ``torch.func.vjp`` and
``vmap`` transform it as they find it.  No kernel of this repo computes
it: the JAX package runs it as a plain ``lax.scan`` too.  The loop is
bound by its launches (a few small kernels a step and layer), so what
does not depend on the carry is computed for every step at once before
it (the same elementwise ops on the same values, so the same numbers),
and each per-step input is one ``unbind`` over time, whose backward is
one ``stack``: an index a step would write a full-size zero gradient
and add it up, a step at a time.

On a model axis (``launch.sharding``) each block runs its recurrence on
the rank's heads, with every collective outside the time loop: the
column-sharded input projections (mLSTM's ``up``, sLSTM's ``wx``,
Mamba2's ``in_proj``) are gathered whole, each rank takes its channels
of the pieces they split into, the row-sharded ``wq`` / ``wk`` / ``wv`` /
``wif`` partial products are reduce-scattered to the rank's heads (with
``wif``'s replicated bias added once, after the sum), the RMSNorms over
a sliced width sum their sums of squares over ``model``, and the
row-sharded output projections are summed over ``model``.  The
replicated params a recurrence reads for the rank's heads only
(Mamba2's ``ssd``, sLSTM's gate bias) are ``model_partial`` leaves of
their ``local_vjp`` tap; sLSTM's ``R`` is sliced on heads.  A model
degree that does not divide the heads raises naming ROADMAP.md item 14
part 3.

Decode paths (``*_step``) carry explicit recurrent state and need no taps.
Params, init shapes, dtypes and logical axes are the JAX package's
(``repro.models.ssm``), so its parameters load unchanged.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core.tapper import Tapper
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm
from repro_torch.models.mlp import mlp_apply, mlp_init

HEADDIM = 64
F32 = torch.float32


def _rms_plain(y, eps: float = 1e-6):
    """RMSNorm without its scale, computed in f32, back in y's dtype."""
    yf = y.to(F32)
    return (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + eps)) \
        .to(y.dtype)


def _conv_step(state_conv, new, p_conv):
    """One causal depthwise conv step: the history (B, C, K-1) with the
    new column appended, against the (C, 1, K) weight -> (out, history)."""
    hist = torch.cat([state_conv, new[:, :, None].to(state_conv.dtype)], -1)
    w = p_conv["w"][:, 0, :]
    return torch.einsum("bck,ck->bc", hist, w) + p_conv["b"], hist


def _causal_depthwise(tp: Tapper, name: str, p_conv, x, d_conv: int):
    """The tapped causal depthwise conv over time of x (B, T, C)."""
    ci = F.pad(x.transpose(1, 2), (d_conv - 1, 0))          # (B, C, T+K-1)
    co = tp.conv(name, ci, p_conv["w"], p_conv["b"], groups=x.shape[-1])
    return co.transpose(1, 2)


def _heads_cut(name: str, n_heads: int, *pairs) -> bool:
    """Whether the block runs sliced over the active model group: each
    ``(local, full)`` pair of its params' sliced dimensions arrived
    sliced.  A degree that does not divide ``n_heads``, or params sliced
    in part (the spec rules keep a dimension they do not divide
    replicated), raise naming the deferred item."""
    ms = sh.active()
    if ms is None:
        return False
    if n_heads % ms.size:
        raise NotImplementedError(
            f"{name}: {n_heads} heads on a model axis of {ms.size} (a "
            f"degree that does not divide the heads) is {sh.DEFERRED}")
    cuts = {sh.split(local, full) for local, full in pairs}
    if len(cuts) > 1:
        raise NotImplementedError(
            f"{name}: params sliced over model in part (shapes "
            f"{pairs}) are {sh.DEFERRED}")
    return cuts == {True}


def _narrowed(fn, cuts: dict, params, *inputs):
    """``fn`` on ``params`` with each leaf named in ``cuts`` narrowed to
    ``(dim, start, length)`` first: a recurrence reading a replicated
    leaf for the rank's heads only (rank-local, so ``vmap`` takes it)."""
    return fn({k: v.narrow(*cuts[k]) if k in cuts else v
               for k, v in params.items()}, *inputs)


# ---------------------------------------------------------------------------
# Mamba2 (SSD): h_t = exp(dt·A) h_{t-1} + dt·(x_t ⊗ B_t);  y_t = h_t·C_t + D·x_t


def _ssd_scan(params, xh, Bm, Cm, dt_raw):
    """xh (B,T,nh,hd); Bm/Cm (B,T,ds); dt_raw (B,T,nh) -> y (B,T,nh,hd)."""
    A = -torch.exp(params["A_log"].to(F32))                        # (nh,)
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"].to(F32))    # (B,T,nh)
    decay = torch.exp(dt * A)                                      # (B,T,nh)
    B_, _, nh, hd = xh.shape
    ds = Bm.shape[-1]
    xf, bf, cf = xh.to(F32), Bm.to(F32), Cm.to(F32)
    dtx = dt[..., None] * xf                                    # (B,T,nh,hd)
    h = torch.zeros((B_, nh, hd, ds), dtype=F32, device=xh.device)
    ys = []
    for dec_t, u_t, b_t, c_t in zip(decay.unbind(1), dtx.unbind(1),
                                    bf.unbind(1), cf.unbind(1)):
        h = dec_t[:, :, None, None] * h + u_t[..., None] * b_t[:, None,
                                                                None, :]
        ys.append(torch.einsum("bnhs,bs->bnh", h, c_t))
    y = torch.stack(ys, 1)                                      # (B,T,nh,hd)
    y = y + params["D"].to(F32)[None, None, :, None] * xf
    return y.to(xh.dtype)


def mamba2_init(gen: torch.Generator, d_model, *, d_state, expand=2,
                d_conv=4, dtype=F32, device="cpu"):
    di = expand * d_model
    nh = di // HEADDIM
    conv_dim = di + 2 * d_state
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=F32, device=device)
    return {
        "in_proj": {"w": cm.mk(gen, (d_model, 2 * di + 2 * d_state + nh),
                               ("embed", "mlp"), **kw)},
        "conv": {"w": cm.mk(gen, (conv_dim, 1, d_conv),
                            ("mlp", None, "conv_k"),
                            scale=1.0 / math.sqrt(d_conv), **kw),
                 "b": cm.mk(gen, (conv_dim,), ("mlp",), dist="zeros", **kw)},
        "ssd": {"A_log": cm.mk(gen, (nh,), (None,), dist="zeros", **f32),
                "dt_bias": cm.mk(gen, (nh,), (None,), dist="zeros", **f32),
                "D": cm.mk(gen, (nh,), (None,), dist="ones", **f32)},
        "norm": {"g": cm.mk(gen, (di,), ("mlp",), dist="ones", **kw)},
        "out_proj": {"w": cm.mk(gen, (di, d_model), ("mlp", "embed"), **kw)},
    }


def mamba2_apply(tp: Tapper, name: str, p, x, *, d_state, expand=2,
                 d_conv=4):
    B, T, D = x.shape
    di = expand * D
    nh = di // HEADDIM
    if _heads_cut(name, nh, (p["in_proj"]["w"].shape[-1],
                             2 * di + 2 * d_state + nh),
                  (p["conv"]["b"].shape[0], di + 2 * d_state),
                  (p["out_proj"]["w"].shape[0], di)):
        return _mamba2_sliced(tp, name, p, x, d_state=d_state, d_conv=d_conv)
    zxbcdt = tp.dense(f"{name}/in_proj", x, p["in_proj"]["w"])
    z, xc, Bm, Cm, dt_raw = torch.split(
        zxbcdt, [di, di, d_state, d_state, nh], dim=-1)
    # causal depthwise conv over time on (xc, B, C)
    co = F.silu(_causal_depthwise(tp, f"{name}/conv", p["conv"],
                                  torch.cat([xc, Bm, Cm], -1), d_conv))
    xc, Bm, Cm = torch.split(co, [di, d_state, d_state], dim=-1)
    xh = xc.reshape(B, T, nh, HEADDIM)
    y = tp.local_vjp(f"{name}/ssd", _ssd_scan, p["ssd"], xh, Bm, Cm, dt_raw)
    y = y.reshape(B, T, di)
    y = cm.rmsnorm(tp, f"{name}/norm", p["norm"], y * F.silu(z))
    return tp.dense(f"{name}/out_proj", y, p["out_proj"]["w"])


def _mamba2_sliced(tp: Tapper, name: str, p, x, *, d_state, d_conv):
    """:func:`mamba2_apply` on this rank's SSD heads.  ``in_proj``'s
    column slice is gathered; the conv runs on the rank's contiguous
    slice of the (xc, B, C) channels, which need not fall on a head
    boundary (Zamba2-2.7B at model:2: 2624 of 5248 channels beside 40
    heads of 64, 2560 channels), and its output is gathered too; the
    scan takes the rank's heads of xc and dt with the whole B and C, and
    the replicated ``ssd`` params at those heads."""
    ms = sh.active()
    B, T, _ = x.shape
    di = p["out_proj"]["w"].shape[0] * ms.size
    nh = di // HEADDIM
    h0, h1 = ms.run(nh)
    zxbcdt = sh.gather_from_model(
        tp.dense(f"{name}/in_proj", sh.copy_to_model(x), p["in_proj"]["w"]),
        -1, sharded_consumer=True)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * d_state, nh], dim=-1)
    co = F.silu(_causal_depthwise(tp, f"{name}/conv", p["conv"],
                                  sh.own(xbc, -1), d_conv))
    co = sh.gather_from_model(co, -1, sharded_consumer=True)
    xc, Bm, Cm = torch.split(co, [di, d_state, d_state], dim=-1)
    xh = sh.own(xc, -1).reshape(B, T, h1 - h0, HEADDIM)
    fn = functools.partial(_narrowed, _ssd_scan,
                           {k: (0, h0, h1 - h0) for k in p["ssd"]})
    y = tp.local_vjp(f"{name}/ssd", fn, p["ssd"], xh, Bm, Cm,
                     sh.own(dt_raw, -1), model_partial=True)
    y = y.reshape(B, T, (h1 - h0) * HEADDIM)
    y = cm.rmsnorm(tp, f"{name}/norm", p["norm"], y * F.silu(sh.own(z, -1)),
                   width=di)
    return sh.reduce_from_model(
        tp.dense(f"{name}/out_proj", y, p["out_proj"]["w"]))


def mamba2_state(batch, d_model, *, d_state, expand=2, d_conv=4, dtype=F32,
                 device="cpu"):
    di = expand * d_model
    nh = di // HEADDIM
    conv_dim = di + 2 * d_state
    return {"h": torch.zeros((batch, nh, HEADDIM, d_state), dtype=F32,
                             device=device),
            "conv": torch.zeros((batch, conv_dim, d_conv - 1), dtype=dtype,
                                device=device)}


def mamba2_step(p, state, x_t, *, d_state, expand=2, d_conv=4):
    """x_t (B, D) -> (y_t, state).  O(1) per token."""
    B, D = x_t.shape
    di = expand * D
    nh = di // HEADDIM
    zxbcdt = x_t @ p["in_proj"]["w"]
    z, xc, Bm, Cm, dt_raw = torch.split(
        zxbcdt, [di, di, d_state, d_state, nh], dim=-1)
    co, hist = _conv_step(state["conv"], torch.cat([xc, Bm, Cm], -1),
                          p["conv"])
    xc, Bm, Cm = torch.split(F.silu(co), [di, d_state, d_state], dim=-1)
    xh = xc.reshape(B, nh, HEADDIM).to(F32)
    A = -torch.exp(p["ssd"]["A_log"].to(F32))
    dt = F.softplus(dt_raw.to(F32) + p["ssd"]["dt_bias"])
    dec = torch.exp(dt * A)
    h = dec[:, :, None, None] * state["h"] + \
        (dt[:, :, None] * xh)[..., None] * Bm.to(F32)[:, None, None, :]
    y = torch.einsum("bnhs,bs->bnh", h, Cm.to(F32))
    y = y + p["ssd"]["D"][None, :, None] * xh
    y = y.reshape(B, di).to(x_t.dtype)
    # gated rmsnorm
    y = _rms_plain(y * F.silu(z)) * p["norm"]["g"]
    y = y @ p["out_proj"]["w"]
    return y, {"h": h, "conv": hist[:, :, 1:]}


# ---------------------------------------------------------------------------
# xLSTM — mLSTM (matrix memory, parallelizable) & sLSTM (scalar memory,
# recurrent weights)


def mlstm_init(gen: torch.Generator, d_model, *, expand=2, d_conv=4,
               n_heads=4, dtype=F32, device="cpu"):
    di = expand * d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "up": {"w": cm.mk(gen, (d_model, 2 * di), ("embed", "mlp"), **kw)},
        "conv": {"w": cm.mk(gen, (di, 1, d_conv), ("mlp", None, "conv_k"),
                            scale=1.0 / math.sqrt(d_conv), **kw),
                 "b": cm.mk(gen, (di,), ("mlp",), dist="zeros", **kw)},
        "wq": {"w": cm.mk(gen, (di, di), ("mlp", "heads"), **kw)},
        "wk": {"w": cm.mk(gen, (di, di), ("mlp", "heads"), **kw)},
        "wv": {"w": cm.mk(gen, (di, di), ("mlp", "heads"), **kw)},
        "wif": {"w": cm.mk(gen, (di, 2 * n_heads), ("mlp", None), scale=0.1,
                           **kw),
                "b": cm.mk(gen, (2 * n_heads,), (None,), dist="zeros",
                           **kw)},
        "norm": {"g": cm.mk(gen, (di,), ("mlp",), dist="ones", **kw)},
        "down": {"w": cm.mk(gen, (di, d_model), ("mlp", "embed"), **kw)},
    }


def _mlstm_pre(k, v, f_pre):
    """What an mLSTM step takes that the carry does not touch: log
    sigmoid(f) and the outer product k ⊗ v (any leading axes)."""
    return -F.softplus(-f_pre), k[..., :, None] * v[..., None, :]


def _mlstm_cell(C, n, m, qt, kt, kv_t, it, logf):
    """One stabilized mLSTM step (f32) -> (C, n, m, h), given ``logf`` and
    ``kv_t`` from :func:`_mlstm_pre`."""
    lfm = logf + m
    m_new = torch.maximum(lfm, it)
    fg = torch.exp(lfm - m_new)
    ig = torch.exp(it - m_new)
    C = fg[..., None, None] * C + ig[..., None, None] * kv_t
    n = fg[..., None] * n + ig[..., None] * kt
    num = torch.einsum("bhkv,bhk->bhv", C, qt)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, qt).abs(), min=1.0)
    return C, n, m_new, num / den[..., None]


def _mlstm_scan(q, k, v, i_pre, f_pre):
    """Stabilized mLSTM recurrence.  q,k,v (B,T,H,hd); gates (B,T,H)."""
    B, _, H, hd = q.shape
    q, k, v, i_pre, f_pre = (a.to(F32) for a in (q, k, v, i_pre, f_pre))
    logf, kv = _mlstm_pre(k, v, f_pre)
    C = torch.zeros((B, H, hd, hd), dtype=F32, device=q.device)
    n = torch.zeros((B, H, hd), dtype=F32, device=q.device)
    m = torch.zeros((B, H), dtype=F32, device=q.device)
    hs = []
    for qt, kt, kv_t, it, lf in zip(q.unbind(1), k.unbind(1), kv.unbind(1),
                                    i_pre.unbind(1), logf.unbind(1)):
        C, n, m, h = _mlstm_cell(C, n, m, qt, kt, kv_t, it, lf)
        hs.append(h)
    return torch.stack(hs, 1)                # (B,T,H,hd)


def mlstm_apply(tp: Tapper, name: str, p, x, *, expand=2, d_conv=4,
                n_heads=4):
    B, T, D = x.shape
    di = expand * D
    hd = di // n_heads
    if _heads_cut(name, n_heads, (p["up"]["w"].shape[-1], 2 * di),
                  (p["wq"]["w"].shape[0], di), (p["wif"]["w"].shape[0], di),
                  (p["down"]["w"].shape[0], di)):
        return _mlstm_sliced(tp, name, p, x, di=di, d_conv=d_conv,
                             n_heads=n_heads)
    up = tp.dense(f"{name}/up", x, p["up"]["w"])
    xin, z = torch.chunk(up, 2, dim=-1)
    xc = F.silu(_causal_depthwise(tp, f"{name}/conv", p["conv"], xin,
                                  d_conv))
    q = tp.dense(f"{name}/wq", xc, p["wq"]["w"]).reshape(B, T, n_heads, hd)
    k = tp.dense(f"{name}/wk", xc, p["wk"]["w"]).reshape(B, T, n_heads, hd)
    k = k / math.sqrt(hd)
    v = tp.dense(f"{name}/wv", xin, p["wv"]["w"]).reshape(B, T, n_heads, hd)
    gates = tp.dense(f"{name}/wif", xin, p["wif"]["w"], p["wif"]["b"])
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)
    h = _mlstm_scan(q, k, v, i_pre, f_pre).reshape(B, T, di).to(x.dtype)
    h = cm.rmsnorm(tp, f"{name}/norm", p["norm"], h) * F.silu(z)
    return tp.dense(f"{name}/down", h, p["down"]["w"])


def _mlstm_sliced(tp: Tapper, name: str, p, x, *, di, d_conv, n_heads):
    """:func:`mlstm_apply` on this rank's heads, which are its
    contiguous ``di/M`` channels of ``xin`` and of the conv output.
    ``up``'s column slice is gathered (at M = 2 rank 0 holds all of
    ``xin``, rank 1 all of ``z``); the row-sharded ``wq`` / ``wk`` /
    ``wv`` / ``wif`` partial products are reduce-scattered to the rank's
    heads, ``wif``'s replicated bias added once after the sum."""
    ms = sh.active()
    B, T, _ = x.shape
    hd = di // n_heads
    H = n_heads // ms.size
    up = sh.gather_from_model(
        tp.dense(f"{name}/up", sh.copy_to_model(x), p["up"]["w"]), -1,
        sharded_consumer=True)
    xin, z = (sh.own(t, -1) for t in torch.chunk(up, 2, dim=-1))
    xc = F.silu(_causal_depthwise(tp, f"{name}/conv", p["conv"], xin,
                                  d_conv))

    def heads(n, inp):
        y = tp.dense(f"{name}/{n}", inp, p[n]["w"])
        return sh.reduce_scatter_from_model(y, -1).reshape(B, T, H, hd)
    q = heads("wq", xc)
    k = heads("wk", xc) / math.sqrt(hd)
    v = heads("wv", xin)
    i_pre, f_pre = _wif_gates(tp, name, p, xin, n_heads)
    h = _mlstm_scan(q, k, v, i_pre, f_pre).reshape(B, T, H * hd) \
        .to(x.dtype)
    h = cm.rmsnorm(tp, f"{name}/norm", p["norm"], h, width=di) * F.silu(z)
    return sh.reduce_from_model(tp.dense(f"{name}/down", h, p["down"]["w"]))


def _wif_gates(tp: Tapper, name: str, p, xin, n_heads: int):
    """The rank's heads' input and forget gate pre-activations: ``wif``'s
    row-sharded partial product reduce-scattered to the heads, and its
    replicated bias added once, after the sum."""
    B, T, _ = xin.shape
    g = tp.dense(f"{name}/wif", xin, p["wif"]["w"], p["wif"]["b"],
                 bias_after_sum=True)
    g = sh.reduce_scatter_from_model(g.reshape(B, T, 2, n_heads), -1)
    b = sh.copy_to_model(p["wif"]["b"], param=True).reshape(2, n_heads)
    return (g + sh.own(b, -1)).unbind(2)


def mlstm_state(batch, d_model, *, expand=2, d_conv=4, n_heads=4,
                dtype=F32, device="cpu"):
    di = expand * d_model
    hd = di // n_heads
    f32 = dict(dtype=F32, device=device)
    return {"C": torch.zeros((batch, n_heads, hd, hd), **f32),
            "n": torch.zeros((batch, n_heads, hd), **f32),
            "m": torch.zeros((batch, n_heads), **f32),
            "conv": torch.zeros((batch, di, d_conv - 1), dtype=dtype,
                                device=device)}


def mlstm_step(p, state, x_t, *, expand=2, d_conv=4, n_heads=4):
    B, D = x_t.shape
    di = expand * D
    hd = di // n_heads
    up = x_t @ p["up"]["w"]
    xin, z = torch.chunk(up, 2, dim=-1)
    co, hist = _conv_step(state["conv"], xin, p["conv"])
    xc = F.silu(co)
    q = (xc @ p["wq"]["w"]).reshape(B, n_heads, hd).to(F32)
    k = (xc @ p["wk"]["w"]).reshape(B, n_heads, hd).to(F32)
    k = k / math.sqrt(hd)
    v = (xin @ p["wv"]["w"]).reshape(B, n_heads, hd).to(F32)
    gates = (xin @ p["wif"]["w"] + p["wif"]["b"]).to(F32)
    it, ft = torch.chunk(gates, 2, dim=-1)
    logf, kv = _mlstm_pre(k, v, ft)
    C, n, m, h = _mlstm_cell(state["C"], state["n"], state["m"], q, k, kv,
                             it, logf)
    h = h.reshape(B, di).to(x_t.dtype)
    h = _rms_plain(h) * p["norm"]["g"] * F.silu(z)
    y = h @ p["down"]["w"]
    return y, {"C": C, "n": n, "m": m, "conv": hist[:, :, 1:]}


# -- sLSTM ------------------------------------------------------------------


def slstm_init(gen: torch.Generator, d_model, *, n_heads=4, dtype=F32,
               device="cpu"):
    hd = d_model // n_heads
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=F32, device=device)
    return {
        "wx": {"w": cm.mk(gen, (d_model, 4 * d_model), ("embed", "mlp"),
                          **kw)},
        "rec": {"R": cm.mk(gen, (4, n_heads, hd, hd),
                           (None, "heads", None, None),
                           scale=0.3 / math.sqrt(hd), **f32),
                "b": cm.mk(gen, (4, d_model), (None, "embed"), dist="zeros",
                           **f32)},
        "norm": {"g": cm.mk(gen, (d_model,), ("embed",), dist="ones", **kw)},
        "ffn": mlp_init(gen, d_model, _slstm_ff(d_model), "swiglu", **kw),
    }


def _slstm_cell(R, bias, c, n, h, m, gx_t):
    """One stabilized sLSTM step: gx_t (B,4,D) input-side pre-activations
    in f32, the recurrent R h_{t-1} and the bias added -> (c, n, h, m)."""
    B, _, D = gx_t.shape
    H = R.shape[1]
    rec = torch.einsum("ghkv,bhk->gbhv", R, h.reshape(B, H, D // H)) \
        .reshape(4, B, D)
    g = gx_t.transpose(0, 1) + rec + bias[:, None, :]
    i_, f_, z_, o_ = g.unbind(0)
    logf = -F.softplus(-f_)
    m_new = torch.maximum(logf + m, i_)
    ig = torch.exp(i_ - m_new)
    fg = torch.exp(logf + m - m_new)
    c = fg * c + ig * torch.tanh(z_)
    n = fg * n + ig
    h = torch.sigmoid(o_) * c / torch.clamp(n, min=1.0)
    return c, n, h, m_new


def _slstm_scan(params, gx):
    """gx (B,T,4,D) gate pre-activations from the input side.
    Recurrence: g = gx_t + R h_{t-1} + b, stabilized scalar memory."""
    R, bias = params["R"], params["b"]          # (4,H,hd,hd), (4,D)
    B, _, _, D = gx.shape
    gxf = gx.to(F32)
    zeros = torch.zeros((B, D), dtype=F32, device=gx.device)
    c = n = h = m = zeros
    hs = []
    for gx_t in gxf.unbind(1):
        c, n, h, m = _slstm_cell(R, bias, c, n, h, m, gx_t)
        hs.append(h)
    return torch.stack(hs, 1).to(gx.dtype)       # (B,T,D)


def slstm_apply(tp: Tapper, name: str, p, x, *, n_heads=4):
    B, T, D = x.shape
    if _heads_cut(name, n_heads, (p["wx"]["w"].shape[-1], 4 * D),
                  (p["rec"]["R"].shape[1], n_heads)):
        h = _slstm_sliced(tp, name, p, x)
    else:
        gx = tp.dense(f"{name}/wx", x, p["wx"]["w"]).reshape(B, T, 4, D)
        h = tp.local_vjp(f"{name}/rec", _slstm_scan, p["rec"], gx)
    h = cm.rmsnorm(tp, f"{name}/norm", p["norm"], h)
    return mlp_apply(tp, f"{name}/ffn", p["ffn"], h, "swiglu",
                     d_ff=_slstm_ff(D))


def _slstm_ff(d_model: int) -> int:
    return int(d_model * 4 / 3) // 8 * 8


def _slstm_sliced(tp: Tapper, name: str, p, x):
    """sLSTM's recurrence on this rank's heads -> h (B, T, D), gathered
    whole for the replicated norm and the FFN.  ``wx``'s column slice is
    gathered (at M = 2 rank 0 holds gates i and f, rank 1 z and o, for
    every head), and the scan takes the rank's channels of all four
    gates, its slice of ``R`` and the replicated ``b`` at its channels."""
    ms = sh.active()
    B, T, D = x.shape
    gx = sh.gather_from_model(
        tp.dense(f"{name}/wx", sh.copy_to_model(x), p["wx"]["w"]), -1,
        sharded_consumer=True)
    c0, c1 = ms.run(D)
    gx = sh.own(gx.reshape(B, T, 4, D), -1)
    fn = functools.partial(_narrowed, _slstm_scan, {"b": (1, c0, c1 - c0)})
    h = tp.local_vjp(f"{name}/rec", fn, p["rec"], gx, model_partial=("b",))
    return sh.gather_from_model(h, -1)


def slstm_state(batch, d_model, dtype=F32, device="cpu"):
    z = torch.zeros((batch, d_model), dtype=F32, device=device)
    return {"c": z, "n": z, "h": z, "m": z}


def slstm_step(p, state, x_t, *, n_heads=4):
    B, D = x_t.shape
    gx = (x_t @ p["wx"]["w"]).reshape(B, 4, D)
    c, n, h, m = _slstm_cell(p["rec"]["R"], p["rec"]["b"], state["c"],
                             state["n"], state["h"], state["m"], gx.to(F32))
    hn = _rms_plain(h.to(x_t.dtype)) * p["norm"]["g"]
    # ffn (plain, no taps on the decode path)
    gate = hn @ p["ffn"]["w_gate"]["w"]
    upv = hn @ p["ffn"]["w_up"]["w"]
    y = (F.silu(gate) * upv) @ p["ffn"]["w_down"]["w"]
    return y, {"c": c, "n": n, "h": h, "m": m}
