"""Attention: GQA (+RoPE, qk-norm, sliding window) over the ``attend``
dispatch (full softmax, chunked, or this repo's flash kernels), with the
KV cache that prefill and decode serve from, and DeepSeek-style MLA
(multi-head latent attention: a latent-compressed KV cache, a decoupled
rope head, and the absorbed decode that attends in the latent space).

All projections go through tapped denses, so per-example gradients cover
every attention parameter; serving passes an inactive ``Tapper``.  With
``dp_attn`` the whole block is tapped as one ``"attn"`` layer instead
(``core/kinds.py`` recovers each projection's captures and cotangents by
running the block again).  Cross attention (``gqa_apply(x_kv=)``) takes
K and V from a source sequence, with no RoPE, no mask and no cache.

On a model axis that slices the query heads (``"heads"``), ``wq`` is
column-sharded and ``wo`` row-sharded (its partial output summed over
``model``); ``wk`` / ``wv`` stay replicated (``"kv"`` maps to no mesh
axis) and each rank attends with the KV heads its local query heads
read, so their outputs' cotangent is summed over ``model`` before the
capture sees it.  MLA slices its per-head projections the same way
beside a replicated latent path (:func:`mla_apply`).  Cross attention
takes its K and V the same way, from the replicated ``wk`` / ``wv`` on
the source.  qk-norm: ``kn`` normalizes the replicated keys before
their copy to ``model``; ``qn`` normalizes the rank's query heads, so
its scale's per-example gradient is a partial sum over those heads,
which the ``scale`` kind sums over ``model`` each time a norm or a
contribution reads it (``Tapper.scale(model_partial=True)``).  Block taps (``dp_attn``) and a
cache beside sliced heads are ROADMAP.md item 14 part 3.
"""
from __future__ import annotations

import torch

from repro_torch.core.tapper import LayerMeta, Tapper
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm

NEG = -1e30
CHUNK_Q = 1024
AUTO_CHUNK_FROM = 8192
F32 = torch.float32


class FlashUnsupportedError(NotImplementedError):
    """``impl="flash"`` was requested for a feature combination the flash
    kernels do not implement (sliding window, cache offsets, valid-length
    masking, MLA's q/k head dim beside another v head dim)."""


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
    or valid length).

    ``x_kv`` (B, S, D): cross attention, K and V projected from that
    source (no cache, no causal mask, no RoPE on either side); under
    ``attn_impl="flash"`` the full-attention kernels run with key length
    S.

    ``dp_attn``: tap the whole block as one ``"attn"`` layer (see
    ``core/kinds.py``): per-example norms for wq/wk/wv/wo come from a
    layer-local recompute instead of per-projection captures, so the
    planner prices the block's ghost norm as a unit.  Falls back to
    per-projection taps under an inactive tapper (``multi``, serving), a
    cache, cross attention, a window, explicit positions and shared
    (``"~"``) call sites."""
    cut = sh.split(p["wq"]["w"].shape[-1], n_heads * head_dim)
    if sh.active() is not None and dp_attn and tp.active():
        raise NotImplementedError(
            f"{name}: block taps (dp_attn) on a model axis are "
            f"{sh.DEFERRED}")
    if cut:
        return _gqa_heads_sharded(tp, name, p, x, n_heads=n_heads,
                                  n_kv=n_kv, head_dim=head_dim,
                                  rope_theta=rope_theta, qk_norm=qk_norm,
                                  positions=positions, causal=causal,
                                  window=window, cache=cache, x_kv=x_kv,
                                  attn_impl=attn_impl, use_rope=use_rope)
    if (dp_attn and tp.active() and cache is None and x_kv is None
            and not window and positions is None
            and not name.startswith("~")):
        kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                  rope_theta=rope_theta, qk_norm=qk_norm, causal=causal,
                  attn_impl=attn_impl, use_rope=use_rope)

        def rebuild(inner_tp, psub, xin):
            return gqa_apply(inner_tp, "blk", psub, xin, **kw)[0]

        D = x.shape[-1]
        return _block_tap(tp, name, rebuild, p, x, qk_flops=n_heads * head_dim,
                          proj_dims=((D, n_heads * head_dim),
                                     (D, n_kv * head_dim),
                                     (D, n_kv * head_dim),
                                     (n_heads * head_dim, D)))
    B, T, _ = x.shape
    src = x if x_kv is None else x_kv
    S = src.shape[1]
    q = tp.dense(f"{name}/wq", x, p["wq"]["w"], p["wq"].get("b"))
    k = tp.dense(f"{name}/wk", src, p["wk"]["w"], p["wk"].get("b"))
    v = tp.dense(f"{name}/wv", src, p["wv"]["w"], p["wv"].get("b"))
    q = q.reshape(B, T, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if qk_norm:
        q = cm.rmsnorm(tp, f"{name}/qn", p["qn"], q)
        k = cm.rmsnorm(tp, f"{name}/kn", p["kn"], k)
    if use_rope and x_kv is None:
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
        out = attend(q, repeat_kv(k, rep), repeat_kv(v, rep),
                     causal=causal and x_kv is None, window=window,
                     impl=attn_impl)
    out = out.reshape(B, T, n_heads * head_dim)
    return (tp.dense(f"{name}/wo", out, p["wo"]["w"], p["wo"].get("b")),
            new_cache)


def _gqa_heads_sharded(tp: Tapper, name: str, p, x, *, n_heads, n_kv,
                       head_dim, rope_theta, qk_norm, positions, causal,
                       window, cache, x_kv, attn_impl, use_rope):
    """:func:`gqa_apply` on this rank's slice of the query heads: ``wq``
    column-sharded, ``wk`` / ``wv`` replicated (on ``x_kv`` for cross
    attention), ``wo`` row-sharded."""
    if cache is not None:
        raise NotImplementedError(f"{name}: a KV cache beside sliced heads "
                                  f"is {sh.DEFERRED}")
    if any("b" in p[n] for n in ("wq", "wk", "wv", "wo")):
        raise NotImplementedError(
            f"{name}: attention biases beside sliced heads are "
            f"{sh.DEFERRED}")
    ms = sh.active()
    B, T, _ = x.shape
    src = x if x_kv is None else x_kv
    S = src.shape[1]
    hl = n_heads // ms.size
    q = tp.dense(f"{name}/wq", sh.copy_to_model(x), p["wq"]["w"])
    k = tp.dense(f"{name}/wk", src, p["wk"]["w"])
    v = tp.dense(f"{name}/wv", src, p["wv"]["w"])
    q = q.reshape(B, T, hl, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if qk_norm:
        # qn reads the rank's heads only: its replicated scale's tap is
        # partial over model.
        q = tp.scale(f"{name}/qn", cm.rmsnorm(tp, f"{name}/qn", None, q),
                     p["qn"]["g"], model_partial=True)
        k = cm.rmsnorm(tp, f"{name}/kn", p["kn"], k)
    # The replicated keys and values (kn's output among them) see every
    # rank's partial use of their heads: the cotangent is summed over
    # model before a capture reads it.
    k, v = sh.copy_to_model(k), sh.copy_to_model(v)
    if use_rope and x_kv is None:
        if positions is None:
            positions = torch.arange(T, device=x.device)[None, :] \
                .expand(B, T)
        cos, sin = cm.rope_angles(positions, head_dim, rope_theta)
        q = cm.apply_rope(q, cos, sin)
        k = cm.apply_rope(k, cos, sin)
    # Local query head j is global head r*hl + j; it reads KV head
    # (r*hl + j) // rep: this rank's run of KV heads, each repeated to
    # its query heads.
    rep = n_heads // n_kv
    if hl % rep and rep % hl:
        raise NotImplementedError(
            f"{name}: {hl} query heads a rank beside {rep} query heads a "
            f"KV head: {sh.DEFERRED}")
    kv0 = ms.rank * hl // rep
    kv1 = ((ms.rank + 1) * hl - 1) // rep + 1
    r_l = hl // (kv1 - kv0)
    out = attend(q, repeat_kv(k[:, :, kv0:kv1], r_l),
                 repeat_kv(v[:, :, kv0:kv1], r_l),
                 causal=causal and x_kv is None, window=window,
                 impl=attn_impl)
    out = out.reshape(B, T, hl * head_dim)
    return (sh.reduce_from_model(tp.dense(f"{name}/wo", out, p["wo"]["w"])),
            None)


def _block_tap(tp: Tapper, name: str, rebuild, p, x, *, proj_dims,
               qk_flops):
    """The block's output under one ``"attn"`` tap capturing only ``x``;
    ``rebuild`` (the block under the fixed ``"blk"`` prefix) rides in the
    meta for the kind's recompute.  ``static`` holds what the planner
    prices: each projection's (Din, Dout) and the score width
    (heads x q/k head dim)."""
    y = rebuild(Tapper(), p, x)
    meta = LayerMeta("attn", tuple(name.split("/")),
                     static={"proj_dims": proj_dims, "qk_flops": qk_flops},
                     fn=rebuild)
    return tp.tap(name, y, {"x": x}, meta), None


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): latent-compressed KV, decoupled rope head


def mla_init(gen: torch.Generator, d_model, n_heads, *, q_lora_rank,
             kv_lora_rank, qk_nope_dim, qk_rope_dim, v_head_dim, dtype=F32,
             device="cpu"):
    kw = dict(dtype=dtype, device=device)
    qd = qk_nope_dim + qk_rope_dim
    p = {}
    if q_lora_rank:
        p["wq_a"] = {"w": cm.mk(gen, (d_model, q_lora_rank),
                                ("embed", "qrank"), **kw)}
        p["q_norm"] = {"g": cm.mk(gen, (q_lora_rank,), ("qrank",),
                                  dist="ones", **kw)}
        p["wq_b"] = {"w": cm.mk(gen, (q_lora_rank, n_heads * qd),
                                ("qrank", "heads"), **kw)}
    else:
        p["wq"] = {"w": cm.mk(gen, (d_model, n_heads * qd),
                              ("embed", "heads"), **kw)}
    p["wkv_a"] = {"w": cm.mk(gen, (d_model, kv_lora_rank + qk_rope_dim),
                             ("embed", "kvrank"), **kw)}
    p["kv_norm"] = {"g": cm.mk(gen, (kv_lora_rank,), ("kvrank",),
                               dist="ones", **kw)}
    p["wkv_b"] = {"w": cm.mk(gen, (kv_lora_rank,
                                   n_heads * (qk_nope_dim + v_head_dim)),
                             ("kvrank", "heads"), **kw)}
    p["wo"] = {"w": cm.mk(gen, (n_heads * v_head_dim, d_model),
                          ("heads", "embed"), **kw)}
    return p


def mla_apply(tp: Tapper, name: str, p, x, *, n_heads, q_lora_rank,
              kv_lora_rank, qk_nope_dim, qk_rope_dim, v_head_dim,
              rope_theta=1e4, positions=None, cache=None, attn_impl="auto",
              absorbed_decode: bool = False, dp_attn=False):
    """Returns (out, new_cache).  The cache stores the *latent* KV:
    {"ckv" (B, S, kv_lora_rank), "krope" (B, S, qk_rope_dim), "pos"}.

    With a cache, ``absorbed_decode`` folds ``wkv_b`` into the query and
    output sides, so attention runs in the latent space with no
    decompression of the whole cache (scores in f32, as the JAX
    package's ``preferred_element_type``); without it the cache is
    decompressed and attended with the plain softmax.  The flash kernels
    take one head dim for q, k and v, and MLA's q/k (``qk_nope_dim +
    qk_rope_dim``) differ from v's: ``attn_impl="flash"`` raises
    :class:`FlashUnsupportedError`.  ``dp_attn``: the block-level
    ``"attn"`` tap over the train path (see :func:`gqa_apply`).

    On a model axis that slices the heads, ``wq_b`` (or ``wq``) and
    ``wkv_b`` are column-sharded by heads and ``wo`` row-sharded (its
    partial output summed over ``model``); the latent path (``wq_a``,
    ``q_norm``, ``wkv_a``, ``kv_norm``) stays replicated.  The normed
    latents and the shared RoPE key feed every head, so each passes a
    :func:`~repro_torch.launch.sharding.copy_to_model` before the
    sliced projections: their cotangent on a rank covers its heads
    only."""
    if sh.active() is not None and (cache is not None
                                    or (dp_attn and tp.active())):
        what = ("a latent cache" if cache is not None
                else "block taps (dp_attn)")
        raise NotImplementedError(f"{name}: MLA with {what} on a model "
                                  f"axis is {sh.DEFERRED}")
    B, T, D = x.shape
    qd = qk_nope_dim + qk_rope_dim
    cut = sh.split(p["wkv_b"]["w"].shape[-1],
                   n_heads * (qk_nope_dim + v_head_dim))
    H = n_heads // sh.active().size if cut else n_heads
    if attn_impl == "flash":
        raise FlashUnsupportedError(
            f"MLA with attn_impl='flash': the flash kernels take one head "
            f"dim for q, k and v; MLA's q/k are {qd} wide "
            f"(qk_nope_dim + qk_rope_dim), its v {v_head_dim}; use "
            f"attn_impl='xla', 'chunked' or 'auto'")
    if (dp_attn and tp.active() and cache is None and positions is None
            and not name.startswith("~")):
        kw = dict(n_heads=n_heads, q_lora_rank=q_lora_rank,
                  kv_lora_rank=kv_lora_rank, qk_nope_dim=qk_nope_dim,
                  qk_rope_dim=qk_rope_dim, v_head_dim=v_head_dim,
                  rope_theta=rope_theta, attn_impl=attn_impl)

        def rebuild(inner_tp, psub, xin):
            return mla_apply(inner_tp, "blk", psub, xin, **kw)[0]

        q_dims = (((D, q_lora_rank), (q_lora_rank, n_heads * qd))
                  if q_lora_rank else ((D, n_heads * qd),))
        return _block_tap(
            tp, name, rebuild, p, x, qk_flops=n_heads * qd,
            proj_dims=q_dims + ((D, kv_lora_rank + qk_rope_dim),
                                (kv_lora_rank,
                                 n_heads * (qk_nope_dim + v_head_dim)),
                                (n_heads * v_head_dim, D)))

    copy = sh.copy_to_model if cut else (lambda t: t)
    if q_lora_rank:
        cq = tp.dense(f"{name}/wq_a", x, p["wq_a"]["w"])
        cq = cm.rmsnorm(tp, f"{name}/q_norm", p["q_norm"], cq)
        q = tp.dense(f"{name}/wq_b", copy(cq), p["wq_b"]["w"])
    else:
        q = tp.dense(f"{name}/wq", copy(x), p["wq"]["w"])
    q = q.reshape(B, T, H, qd)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]

    kv_a = tp.dense(f"{name}/wkv_a", x, p["wkv_a"]["w"])
    ckv, k_rope = kv_a[..., :kv_lora_rank], kv_a[..., kv_lora_rank:]
    ckv = cm.rmsnorm(tp, f"{name}/kv_norm", p["kv_norm"], ckv)

    pos0 = cache["pos"] if cache is not None else 0
    if positions is None:
        positions = (torch.arange(T, device=x.device)[None, :] + pos0) \
            .expand(B, T)
    cos, sin = cm.rope_angles(positions, qk_rope_dim, rope_theta)
    q_rope = cm.apply_rope(q_rope, cos, sin)
    k_rope = cm.apply_rope(k_rope[:, :, None, :], cos, sin)   # (B,T,1,dr)

    if cache is not None:
        ckv_c = _updated(cache["ckv"], ckv, pos0)
        kr_c = _updated(cache["krope"], k_rope[:, :, 0], pos0)
        new_cache = {"ckv": ckv_c, "krope": kr_c, "pos": pos0 + T}
        S = ckv_c.shape[1]
        valid = new_cache["pos"]
        if absorbed_decode:
            wkv_b = p["wkv_b"]["w"].reshape(kv_lora_rank, n_heads,
                                            qk_nope_dim + v_head_dim)
            wk_b, wv_b = wkv_b[..., :qk_nope_dim], wkv_b[..., qk_nope_dim:]
            q_lat = torch.einsum("bthd,chd->bthc", q_nope, wk_b)
            s = (torch.einsum("bthc,bsc->bhts", q_lat.to(F32),
                              ckv_c.to(F32))
                 + torch.einsum("bthr,bsr->bhts", q_rope.to(F32),
                                kr_c.to(F32))) * qd ** -0.5
            sl = torch.arange(S, device=x.device)
            mask = (sl < valid)[None, None, None, :]
            if T > 1:   # causal among the new tokens (prefill into cache)
                t_idx = pos0 + torch.arange(T, device=x.device)[:, None]
                mask = mask & (sl[None, :] <= t_idx)[None, None]
            s = torch.where(mask, s, NEG)
            pr = torch.softmax(s, dim=-1).to(ckv_c.dtype)
            o_lat = torch.einsum("bhts,bsc->bthc", pr, ckv_c)
            out = torch.einsum("bthc,chd->bthd", o_lat, wv_b)
        else:
            kv = torch.matmul(ckv_c, p["wkv_b"]["w"]).reshape(
                B, S, n_heads, qk_nope_dim + v_head_dim)
            k_nope, vfull = kv[..., :qk_nope_dim], kv[..., qk_nope_dim:]
            k_full = torch.cat([k_nope, kr_c[:, :, None, :].expand(
                B, S, n_heads, qk_rope_dim)], -1)
            qf = torch.cat([q_nope, q_rope], -1)
            out = attend(qf, k_full, vfull, causal=T > 1, offset=pos0,
                         valid_len=valid, impl="xla")
        out = out.reshape(B, T, n_heads * v_head_dim)
        return tp.dense(f"{name}/wo", out, p["wo"]["w"]), new_cache

    # train / prefill-style full pass
    kv = tp.dense(f"{name}/wkv_b", copy(ckv), p["wkv_b"]["w"]).reshape(
        B, T, H, qk_nope_dim + v_head_dim)
    k_nope, v = kv[..., :qk_nope_dim], kv[..., qk_nope_dim:]
    k_full = torch.cat([k_nope, copy(k_rope).expand(B, T, H, qk_rope_dim)],
                       -1)
    qf = torch.cat([q_nope, q_rope], -1)
    out = attend(qf, k_full, v, causal=True, impl=attn_impl)
    out = out.reshape(B, T, H * v_head_dim)
    out = tp.dense(f"{name}/wo", out, p["wo"]["w"])
    return (sh.reduce_from_model(out) if cut else out), None


def mla_cache(batch, max_len, kv_lora_rank, qk_rope_dim, dtype=F32,
              device="cpu"):
    """An empty latent cache: zeros, ``pos`` 0 (a Python int)."""
    z = dict(dtype=dtype, device=device)
    return {"ckv": torch.zeros((batch, max_len, kv_lora_rank), **z),
            "krope": torch.zeros((batch, max_len, qk_rope_dim), **z),
            "pos": 0}
