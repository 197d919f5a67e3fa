"""Attention: GQA (+RoPE, qk-norm, sliding window) over the ``attend``
dispatch (full softmax, chunked, or this repo's flash kernels), with the
KV cache that prefill and decode serve from.

All projections go through tapped denses, so per-example gradients cover
every attention parameter; serving passes an inactive ``Tapper``.  Cross
attention (ROADMAP.md item 12), MLA and the block-level ``dp_attn`` tap
(items 11d and 11b) raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.core.tapper import Tapper
from repro_torch.models import common as cm

NEG = -1e30
CHUNK_Q = 1024
AUTO_CHUNK_FROM = 8192
F32 = torch.float32


class FlashUnsupportedError(NotImplementedError):
    """``impl="flash"`` was requested for a feature combination the flash
    kernels do not implement (sliding window, cache offsets, valid-length
    masking)."""


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} comes with ROADMAP.md item {item}")


# ---------------------------------------------------------------------------
# Core softmax attention


def _sdpa(q, k, v, mask):
    """q (B,T,H,hd), k/v (B,S,H,hd), mask broadcastable to (B,H,T,S).
    Scores and softmax in f32; P enters P·V in v's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bthd,bshd->bhts", q.to(F32), k.to(F32)) * scale
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)


def _causal_mask(T, S, offset=0, window=0, device=None):
    """mask[t, s] = (s - offset) <= t  [and within window]."""
    t = torch.arange(T, device=device)[:, None]
    s = torch.arange(S, device=device)[None, :] - offset
    m = s <= t
    if window:
        m = m & (s > t - window)
    return m[None, None]


def sdpa_chunked(q, k, v, *, offset=0, window=0, chunk=CHUNK_Q,
                 valid_len=None):
    """Causal attention over query chunks — bounds the (T,S) score tensor
    to (chunk, S).  ``valid_len`` masks raw key slots >= valid_len."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    if T % chunk:
        raise ValueError(
            f"sdpa_chunked: query length {T} not divisible by chunk "
            f"{chunk}; pass chunk=min(chunk, T) or pad the sequence")
    outs = []
    sl = torch.arange(S, device=q.device)[None, :]
    for t0 in range(0, T, chunk):
        t = t0 + torch.arange(chunk, device=q.device)[:, None]
        m = (sl - offset) <= t
        if window:
            m = m & ((sl - offset) > t - window)
        if valid_len is not None:
            m = m & (sl < valid_len)
            if window:
                m = m & (sl >= valid_len - window)
        outs.append(_sdpa(q[:, t0:t0 + chunk], k, v, m[None, None]))
    return torch.cat(outs, dim=1)


def attend(q, k, v, *, causal=True, offset=0, window=0, impl="auto",
           valid_len=None):
    """Dispatch the attention implementation (the JAX package's rules).
    ``valid_len`` masks cache slots >= pos."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    if impl == "auto":
        impl = "chunked" if (T >= AUTO_CHUNK_FROM and causal and
                             valid_len is None and T % CHUNK_Q == 0) else "xla"
    if impl == "chunked":
        return sdpa_chunked(q, k, v, offset=offset, window=window,
                            valid_len=valid_len, chunk=min(CHUNK_Q, T))
    if impl == "flash":
        if window or offset or valid_len is not None:
            raise FlashUnsupportedError(
                f"impl='flash' supports plain causal/full attention only "
                f"(got window={window}, offset={offset}, "
                f"valid_len={'set' if valid_len is not None else None}); "
                f"use impl='chunked' or 'xla'")
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    if causal and T > 1:
        mask = _causal_mask(T, S, offset=offset, window=window,
                            device=q.device)
    else:
        mask = torch.ones((1, 1, T, S), dtype=torch.bool, device=q.device)
    if valid_len is not None:
        sl = torch.arange(S, device=q.device)[None, None, None, :]
        mask = mask & (sl < valid_len)
        if window:
            mask = mask & (sl >= valid_len - window)
    return _sdpa(q, k, v, mask)


def repeat_kv(k, n_rep: int):
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


# ---------------------------------------------------------------------------
# GQA attention layer


def gqa_init(gen: torch.Generator, d_model, n_heads, n_kv, head_dim, *,
             qk_norm=False, bias=False, dtype=F32, device="cpu"):
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": {"w": cm.mk(gen, (d_model, n_heads * head_dim),
                          ("embed", "heads"), **kw)},
        "wk": {"w": cm.mk(gen, (d_model, n_kv * head_dim),
                          ("embed", "kv"), **kw)},
        "wv": {"w": cm.mk(gen, (d_model, n_kv * head_dim),
                          ("embed", "kv"), **kw)},
        "wo": {"w": cm.mk(gen, (n_heads * head_dim, d_model),
                          ("heads", "embed"), **kw)},
    }
    if bias:
        for n in ("wq", "wk", "wv", "wo"):
            dim = p[n]["w"].value.shape[1]
            ax = p[n]["w"].axes[1]
            p[n]["b"] = cm.mk(gen, (dim,), (ax,), dist="zeros", **kw)
    if qk_norm:
        p["qn"] = {"g": cm.mk(gen, (head_dim,), (None,), dist="ones", **kw)}
        p["kn"] = {"g": cm.mk(gen, (head_dim,), (None,), dist="ones", **kw)}
    return p


def gqa_apply(tp: Tapper, name: str, p, x, *, n_heads, n_kv, head_dim,
              rope_theta=1e4, qk_norm=False, positions=None, causal=True,
              window=0, cache=None, x_kv=None, attn_impl="auto",
              use_rope=True, dp_attn=False):
    """Returns (attn_out, new_cache).  ``cache``: {"k", "v", "pos"} or
    None; K and V are repeated to all query heads before ``attend``, as in
    the JAX package.

    With a cache, the new tokens' K and V are written at ``pos`` (at
    ``pos mod S_max`` when a ``window`` is set and the cache holds no more
    than the window: a ring) into a copy of the cache, which is returned,
    and the queries attend to the valid slots with the plain softmax
    (``impl="xla"``, as the JAX package: the flash kernels take no offset
    or valid length)."""
    if x_kv is not None:
        raise _unported("cross attention (gqa_apply x_kv=)", "12")
    if dp_attn:
        raise _unported("the block-level 'attn' tap (dp_attn=True)", "11b")
    B, T, _ = x.shape
    q = tp.dense(f"{name}/wq", x, p["wq"]["w"], p["wq"].get("b"))
    k = tp.dense(f"{name}/wk", x, p["wk"]["w"], p["wk"].get("b"))
    v = tp.dense(f"{name}/wv", x, p["wv"]["w"], p["wv"].get("b"))
    q = q.reshape(B, T, n_heads, head_dim)
    k = k.reshape(B, T, n_kv, head_dim)
    v = v.reshape(B, T, n_kv, head_dim)
    if qk_norm:
        q = cm.rmsnorm(tp, f"{name}/qn", p["qn"], q)
        k = cm.rmsnorm(tp, f"{name}/kn", p["kn"], k)
    if use_rope:
        if positions is None:
            pos0 = cache["pos"] if cache is not None else 0
            positions = (torch.arange(T, device=x.device)[None, :] + pos0) \
                .expand(B, T)
        cos, sin = cm.rope_angles(positions, head_dim, rope_theta)
        q = cm.apply_rope(q, cos, sin)
        k = cm.apply_rope(k, cos, sin)
    rep = n_heads // n_kv
    new_cache = None
    if cache is not None:
        S_max = cache["k"].shape[1]
        ring = bool(window) and S_max <= window   # fixed-size rolling cache
        idx = cache["pos"] % S_max if ring else cache["pos"]
        ck = _updated(cache["k"], k, idx)
        cv = _updated(cache["v"], v, idx)
        new_cache = {"k": ck, "v": cv, "pos": cache["pos"] + T}
        out = attend(q, repeat_kv(ck, rep), repeat_kv(cv, rep),
                     causal=T > 1, offset=idx,
                     valid_len=min(new_cache["pos"], S_max), window=0,
                     impl="xla")
    else:
        out = attend(q, repeat_kv(k, rep), repeat_kv(v, rep), causal=causal,
                     window=window, impl=attn_impl)
    out = out.reshape(B, T, n_heads * head_dim)
    return (tp.dense(f"{name}/wo", out, p["wo"]["w"], p["wo"].get("b")),
            new_cache)


def _updated(buf, new, idx: int):
    """A copy of ``buf`` (B, S, ...) with ``new`` (B, T, ...) written at
    slots ``idx .. idx + T`` (``lax.dynamic_update_slice``: the start is
    clamped so the slice fits)."""
    idx = max(0, min(idx, buf.shape[1] - new.shape[1]))
    out = buf.clone()
    out[:, idx:idx + new.shape[1]] = new.to(buf.dtype)
    return out


def gqa_cache(batch, max_len, n_kv, head_dim, dtype=F32, device="cpu"):
    """An empty KV cache: zeros, ``pos`` 0 (a Python int: positions and
    masks are formed on the host, with no sync on the card)."""
    z = dict(dtype=dtype, device=device)
    return {"k": torch.zeros((batch, max_len, n_kv, head_dim), **z),
            "v": torch.zeros((batch, max_len, n_kv, head_dim), **z),
            "pos": 0}
