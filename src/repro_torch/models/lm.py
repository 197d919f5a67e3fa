"""Decoder-only language models for every LM family of the JAX package:
``dense``, ``moe``, ``vlm`` (an early-fusion backbone over token ids),
``ssm`` (xLSTM) and ``hybrid`` (Zamba2: Mamba2 + a weight-shared attention
block).  RMSNorm or LayerNorm (affine or not), GQA with RoPE and optional
qk-norm or MLA (``mla=True``: DeepSeek's latent attention, its cache the
latent KV), SwiGLU or a mixture of SwiGLU experts (``n_experts``:
:mod:`repro_torch.models.moe`, its per-example load-balance loss carried
through the layers and added to each example's loss as
``moe_lb_coef · lb / n_layers``), optionally tied embeddings.  With
``dp_attn`` each block's attention is tapped as one ``"attn"`` layer.

xLSTM (:mod:`repro_torch.models.ssm`) stacks super-blocks of
``slstm_every - 1`` mLSTM layers (an inner scan ``m``) and one sLSTM
(``s/...``), or plain mLSTM layers without ``slstm_every``.  Zamba2 scans
``n_layers // attn_every`` super-blocks, each an inner scan of
``attn_every`` Mamba2 layers (``mamba``) and then the shared block
(``params["shared"]``: ``~shared/ln1``, ``~shared/attn`` with the config's
sliding ``window``, ``~shared/ln2``, ``~shared/mlp``), whose taps keep their
absolute path, so every application folds into one group.

Training applies go through the tapper, so DP per-example gradients
cover every parameter: the embedding gather (``tok_emb``), every
scanned block's norms and projections (``blocks/...``, stacked with a
leading layer axis by :func:`~repro_torch.core.tapper.scan_with_taps`,
each block recomputed in the backward under ``remat=True``), the
parameters inside the recurrences (``local_vjp`` taps), the final norm
and the head — with tied embeddings the head is the transposed table,
tapped as ``"~tok_emb"`` so the two uses of one parameter form one group.
Params and tap names are the JAX package's.

On a model axis (``launch.sharding``) every family trains
tensor-sharded: the vocabulary-sharded ``tok_emb`` (looked up in each
rank's shard and summed over ``model``), head-sharded attention (GQA,
qk-norm, and MLA beside its replicated latent path), ``d_ff``-sharded
MLPs, expert-sharded MoE layers (``models/moe.py``), the recurrent
blocks on the rank's heads (``models/ssm.py``; Zamba2's shared block
head-sharded like a dense block), and a vocabulary-sharded head (tied
or not) whose logits feed the vocabulary-parallel cross entropy, never
gathered.  Every rank of a model slot routes alike, so the per-example
load-balance loss is whole on each and added once.  The enc-dec family
is ``models/encdec.py``'s.  Serving beside sliced heads (a KV, latent or
recurrent cache) is ROADMAP.md item 14 part 3.

Serving (``init_cache``, ``prefill``, ``decode_step``) takes the same
params and runs the blocks as a Python loop over the stack, under
``torch.no_grad()`` with an inactive ``Tapper``: against a KV cache for
the attention families; against recurrent states (and, for Zamba2, one
windowed KV cache a super-block, a ring when it holds no more than the
window) for ``ssm`` and ``hybrid``, whose prefill is one decode step a
prompt token, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tapper import Tapper, _leading, scan_with_taps
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ssm as ssmlib
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.tree import tree_map

ATTN_FAMILIES = ("dense", "moe", "vlm")
FAMILIES = ATTN_FAMILIES + ("ssm", "hybrid")


def _stack_trees(trees: list):
    """Per-layer trees (dicts of tensors) -> one tree, each leaf stacked
    with a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _zeros_stack(lead: tuple, one: dict):
    """``one`` (a state tree) as zeros with the leading axes ``lead``."""
    return tree_map(lambda a: torch.zeros(lead + tuple(a.shape),
                                          dtype=a.dtype, device=a.device),
                    one)


def _index(tree, i: int):
    return tree_map(lambda a: a[i], tree)


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"LM family {cfg.family!r}; the LM families "
                             f"are {FAMILIES}")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # init

    def _attn_init(self, gen, kw):
        c = self.cfg
        if c.mla:
            return attn.mla_init(
                gen, c.d_model, c.n_heads, q_lora_rank=c.q_lora_rank,
                kv_lora_rank=c.kv_lora_rank, qk_nope_dim=c.qk_nope_dim,
                qk_rope_dim=c.qk_rope_dim, v_head_dim=c.v_head_dim, **kw)
        return attn.gqa_init(gen, c.d_model, c.n_heads, c.n_kv, c.hd,
                             qk_norm=c.qk_norm, bias=c.attn_bias, **kw)

    def _block_init(self, gen, dev):
        c = self.cfg
        kw = dict(dtype=c.torch_dtype, device=dev)
        p = {"attn": self._attn_init(gen, kw),
             "ln1": cm.norm_init(gen, c.d_model, c.norm, **kw),
             "ln2": cm.norm_init(gen, c.d_model, c.norm, **kw)}
        if c.n_experts:
            p["moe"] = moe_init(gen, c.d_model, c.d_ff, c.n_experts,
                                n_shared=c.n_shared_experts, **kw)
        else:
            p["mlp"] = mlp_init(gen, c.d_model, c.d_ff, c.mlp, **kw)
        return {k: v for k, v in p.items() if v is not None}

    def init(self, key: int | torch.Generator = 0, *, device="cuda"):
        """-> (params, logical axes).  ``key`` seeds a CPU generator, so a
        seed gives the same weights on every device; or it is a generator,
        which may live on the card (its draws differ from a CPU seed's)."""
        dev = resolve_device(device)
        gen = key if isinstance(key, torch.Generator) \
            else torch.Generator().manual_seed(int(key))
        c = self.cfg
        kw = dict(dtype=c.torch_dtype, device=dev)
        tree = {"tok_emb": {"emb": cm.mk(
            gen, (c.padded_vocab, c.d_model), ("vocab", "embed"),
            scale=0.02, **kw)}}
        if c.family in ATTN_FAMILIES:
            tree["blocks"] = cm.stack_layers(
                gen, c.n_layers, lambda g: self._block_init(g, dev))
        elif c.family == "ssm":
            tree["blocks"] = self._xlstm_init(gen, kw)
        else:
            tree.update(self._zamba_init(gen, kw))
        fn = cm.norm_init(gen, c.d_model, c.norm, **kw)
        if fn is not None:
            tree["final_norm"] = fn
        if not c.tie_embeddings:
            tree["head"] = {"w": cm.mk(gen, (c.d_model, c.padded_vocab),
                                       ("embed", "vocab"), scale=0.02, **kw)}
        return cm.split_tree(tree)

    def _mlstm_layer_init(self, gen, kw):
        c = self.cfg
        return {"blk": ssmlib.mlstm_init(gen, c.d_model, expand=c.ssm_expand,
                                         d_conv=c.ssm_conv,
                                         n_heads=c.n_heads, **kw),
                "ln": cm.norm_init(gen, c.d_model, c.norm, **kw)}

    def _xlstm_init(self, gen, kw):
        c = self.cfg
        if not c.slstm_every:
            return cm.stack_layers(gen, c.n_layers,
                                   lambda g: self._mlstm_layer_init(g, kw))

        def super_init(g):
            return {"m": cm.stack_layers(
                        g, c.slstm_every - 1,
                        lambda gg: self._mlstm_layer_init(gg, kw)),
                    "s": {"blk": ssmlib.slstm_init(g, c.d_model,
                                                   n_heads=c.n_heads, **kw),
                          "ln": cm.norm_init(g, c.d_model, c.norm, **kw)}}
        return cm.stack_layers(gen, c.n_layers // c.slstm_every, super_init)

    def _zamba_init(self, gen, kw):
        c = self.cfg

        def mamba_init(g):
            return {"blk": ssmlib.mamba2_init(
                        g, c.d_model, d_state=c.ssm_state,
                        expand=c.ssm_expand, d_conv=c.ssm_conv, **kw),
                    "ln": cm.norm_init(g, c.d_model, c.norm, **kw)}
        blocks = cm.stack_layers(
            gen, c.n_layers // c.attn_every,
            lambda g: {"mamba": cm.stack_layers(g, c.attn_every,
                                                mamba_init)})
        shared = {"attn": attn.gqa_init(gen, c.d_model, c.n_heads, c.n_kv,
                                        c.hd, qk_norm=c.qk_norm, **kw),
                  "mlp": mlp_init(gen, c.d_model, c.d_ff, c.mlp, **kw),
                  "ln1": cm.norm_init(gen, c.d_model, c.norm, **kw),
                  "ln2": cm.norm_init(gen, c.d_model, c.norm, **kw)}
        return {"blocks": blocks, "shared": shared}

    # ------------------------------------------------------------------
    # shared pieces

    def _attn(self, tp, p, x, **kw):
        """The block's attention (GQA or MLA) -> (out, new cache)."""
        c = self.cfg
        if c.mla:
            return attn.mla_apply(
                tp, "attn", p, x, n_heads=c.n_heads,
                q_lora_rank=c.q_lora_rank, kv_lora_rank=c.kv_lora_rank,
                qk_nope_dim=c.qk_nope_dim, qk_rope_dim=c.qk_rope_dim,
                v_head_dim=c.v_head_dim, rope_theta=c.rope_theta, **kw)
        return attn.gqa_apply(tp, "attn", p, x, n_heads=c.n_heads,
                              n_kv=c.n_kv, head_dim=c.hd,
                              rope_theta=c.rope_theta, qk_norm=c.qk_norm,
                              **kw)

    def _head(self, tp, params, h):
        c = self.cfg
        if c.tie_embeddings:
            w = params["tok_emb"]["emb"]
            if sh.split(w.shape[0], c.padded_vocab):
                h = sh.copy_to_model(h)
            return tp.dense("~tok_emb", h, w, w_transposed=True,
                            param_key="emb")
        w = params["head"]["w"]
        if sh.split(w.shape[1], c.padded_vocab):
            h = sh.copy_to_model(h)
        return tp.dense("head", h, w)

    def _ffn(self, tp, p_l, x):
        """The block's feed-forward: (out, per-example load-balance loss
        of a MoE block, else None)."""
        c = self.cfg
        if c.n_experts:
            return moe_apply(tp, "moe", p_l["moe"], x, impl=c.moe_impl,
                             n_experts=c.n_experts, topk=c.topk,
                             capacity_factor=c.capacity_factor,
                             d_ff=c.d_ff, n_shared=c.n_shared_experts)
        return mlp_apply(tp, "mlp", p_l["mlp"], x, c.mlp, d_ff=c.d_ff), None

    def _ssm_kw(self):
        c = self.cfg
        if c.family == "hybrid":
            return dict(d_state=c.ssm_state, expand=c.ssm_expand,
                        d_conv=c.ssm_conv)
        return dict(expand=c.ssm_expand, d_conv=c.ssm_conv,
                    n_heads=c.n_heads)

    def _shared_attn(self, tp, name, p, x, **kw):
        """Zamba2's shared block's attention (plain GQA, sliding window)."""
        c = self.cfg
        return attn.gqa_apply(tp, name, p, x, n_heads=c.n_heads, n_kv=c.n_kv,
                              head_dim=c.hd, rope_theta=c.rope_theta,
                              qk_norm=c.qk_norm, window=c.window,
                              attn_impl=c.attn_impl, dp_attn=c.dp_attn, **kw)

    def _recurrent_train(self, params, h, tp: Tapper):
        c = self.cfg
        kw = self._ssm_kw()
        lb0 = torch.zeros((h.shape[0],), dtype=torch.float32,
                          device=h.device)

        def mlstm(stp, hh, pm):
            z = cm.apply_norm(stp, "ln", pm.get("ln"), hh, c.norm)
            return hh + ssmlib.mlstm_apply(stp, "blk", pm["blk"], z, **kw)

        if c.family == "ssm" and not c.slstm_every:
            def body(stp, carry, p_l):
                return mlstm(stp, carry[0], p_l), carry[1]
            return scan_with_taps(tp, "blocks", body, (h, lb0),
                                  params["blocks"], remat=c.remat)
        if c.family == "ssm":
            def body(stp, carry, p_l):
                hh = scan_with_taps(stp, "m", mlstm, carry[0], p_l["m"])
                z = cm.apply_norm(stp, "s/ln", p_l["s"].get("ln"), hh,
                                  c.norm)
                hh = hh + ssmlib.slstm_apply(stp, "s/blk", p_l["s"]["blk"],
                                             z, n_heads=c.n_heads)
                return hh, carry[1]
            return scan_with_taps(tp, "blocks", body, (h, lb0),
                                  params["blocks"], remat=c.remat)

        def mamba(stp, hh, pm):
            z = cm.apply_norm(stp, "ln", pm.get("ln"), hh, c.norm)
            return hh + ssmlib.mamba2_apply(stp, "blk", pm["blk"], z, **kw)

        def body(stp, carry, p_l, shared):
            hh = scan_with_taps(stp, "mamba", mamba, carry[0], p_l["mamba"])
            z = cm.apply_norm(stp, "~shared/ln1", shared.get("ln1"), hh,
                              c.norm)
            hh = hh + self._shared_attn(stp, "~shared/attn", shared["attn"],
                                        z)[0]
            z = cm.apply_norm(stp, "~shared/ln2", shared.get("ln2"), hh,
                              c.norm)
            return hh + mlp_apply(stp, "~shared/mlp", shared["mlp"], z,
                                  c.mlp, d_ff=c.d_ff), carry[1]
        return scan_with_taps(tp, "blocks", body, (h, lb0), params["blocks"],
                              remat=c.remat, shared_params=params["shared"])

    def _backbone_train(self, params, h, tp: Tapper):
        """-> (h, the load-balance loss summed over the layers, (B,))."""
        c = self.cfg
        if c.family not in ATTN_FAMILIES:
            return self._recurrent_train(params, h, tp)

        def body(stp, carry, p_l):
            hh, lb = carry
            a, _ = self._attn(
                stp, p_l["attn"],
                cm.apply_norm(stp, "ln1", p_l.get("ln1"), hh, c.norm),
                attn_impl=c.attn_impl, dp_attn=c.dp_attn)
            hh = hh + a
            x2 = cm.apply_norm(stp, "ln2", p_l.get("ln2"), hh, c.norm)
            m, lb_l = self._ffn(stp, p_l, x2)
            return hh + m, lb if lb_l is None else lb + lb_l

        lb0 = torch.zeros((h.shape[0],), dtype=torch.float32,
                          device=h.device)
        return scan_with_taps(tp, "blocks", body, (h, lb0),
                              params["blocks"], remat=c.remat)

    # ------------------------------------------------------------------
    # training apply: per-example losses

    def _logits_lb(self, params, tokens, tp: Tapper):
        c = self.cfg
        h = tp.embed("tok_emb", params["tok_emb"]["emb"], tokens,
                     n_rows=c.padded_vocab)
        h, lb = self._backbone_train(params, h, tp)
        h = cm.apply_norm(tp, "final_norm", params.get("final_norm"), h,
                          c.norm)
        return self._head(tp, params, h), lb

    def logits(self, params, tokens, tp: Tapper | None = None):
        """(B, T, V) logits of one causal forward over ``tokens`` (the
        training path, tapped through ``tp``)."""
        return self._logits_lb(params, tokens, tp or Tapper())[0]

    def apply(self, params, batch, tp: Tapper):
        c = self.cfg
        logits, lb = self._logits_lb(params, batch["tokens"], tp)
        losses = cm.per_example_xent(logits, batch["labels"],
                                     batch.get("mask"), vocab_valid=c.vocab,
                                     n_vocab=c.padded_vocab)
        if c.n_experts:
            losses = losses + c.moe_lb_coef * lb / max(c.n_layers, 1)
        return losses

    # ------------------------------------------------------------------
    # serving: cache, prefill, decode

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        """An empty cache and the number of positions written (``pos``, a
        Python int).  Attention families: per layer K and V (MLA: the
        latent ``ckv`` and ``krope``), stacked with a leading L.  ``ssm``:
        each layer's recurrent state (super-blocks: ``m`` stacked
        (n_super, slstm_every - 1), ``s`` (n_super,)).  ``hybrid``: each
        Mamba2 layer's state, (n_super, attn_every), and each shared-block
        application's KV cache of ``min(max_len, window)`` slots."""
        c = self.cfg
        dev = resolve_device(device)
        dt = c.torch_dtype
        if c.family in ATTN_FAMILIES:
            one = (attn.mla_cache(batch, max_len, c.kv_lora_rank,
                                  c.qk_rope_dim, dt, device=dev) if c.mla
                   else attn.gqa_cache(batch, max_len, c.n_kv, c.hd, dt,
                                       device=dev))
            pos = one.pop("pos")
            return {"layers": _zeros_stack((c.n_layers,), one), "pos": pos}
        kw = dict(self._ssm_kw(), dtype=dt, device=dev)
        if c.family == "ssm":
            m1 = ssmlib.mlstm_state(batch, c.d_model, **kw)
            if not c.slstm_every:
                return {"layers": _zeros_stack((c.n_layers,), m1), "pos": 0}
            n_super = c.n_layers // c.slstm_every
            s1 = ssmlib.slstm_state(batch, c.d_model, device=dev)
            return {"layers": {
                "m": _zeros_stack((n_super, c.slstm_every - 1), m1),
                "s": _zeros_stack((n_super,), s1)}, "pos": 0}
        n_super = c.n_layers // c.attn_every
        m1 = ssmlib.mamba2_state(batch, c.d_model, **kw)
        w = min(max_len, c.window) if c.window else max_len
        a1 = attn.gqa_cache(batch, w, c.n_kv, c.hd, dt, device=dev)
        a1.pop("pos")
        return {"layers": {"mamba": _zeros_stack((n_super, c.attn_every), m1),
                           "attn": _zeros_stack((n_super,), a1)}, "pos": 0}

    def _block_step(self, params_l, cache_l, h, pos, shared=None):
        """One layer (super-block) applied to new tokens h (B, T, D)
        against its cache; the recurrent families take one token,
        T = 1."""
        c = self.cfg
        if c.family not in ATTN_FAMILIES:
            return self._recurrent_step(params_l, cache_l, h, pos, shared)
        tp = Tapper()
        cl = dict(cache_l, pos=pos)
        z = cm.apply_norm(tp, "ln1", params_l.get("ln1"), h, c.norm)
        if c.mla:
            a, nc = self._attn(tp, params_l["attn"], z, cache=cl,
                               absorbed_decode=c.mla_absorbed_decode)
        else:
            a, nc = self._attn(tp, params_l["attn"], z, cache=cl, window=0,
                               attn_impl=c.attn_impl)
        h = h + a
        z = cm.apply_norm(tp, "ln2", params_l.get("ln2"), h, c.norm)
        nc.pop("pos")
        return h + self._ffn(tp, params_l, z)[0], nc

    def _recurrent_step(self, params_l, cache_l, h, pos, shared):
        c = self.cfg
        if sh.active() is not None:
            raise NotImplementedError(
                f"serving the {c.family} family on a model axis (a "
                f"recurrent state, and Zamba2's ring KV cache, beside "
                f"sliced heads) is {sh.DEFERRED}")
        kw = self._ssm_kw()
        x = h[:, 0]

        def inner(step, xx, ps, states):
            new = []
            for i in range(_leading(ps)):
                pm = _index(ps, i)
                z = _norm_plain(pm.get("ln"), xx, c.norm)
                y, ns = step(pm["blk"], _index(states, i), z, **kw)
                xx = xx + y
                new.append(ns)
            return xx, _stack_trees(new)

        if c.family == "ssm" and not c.slstm_every:
            z = _norm_plain(params_l.get("ln"), x, c.norm)
            y, ns = ssmlib.mlstm_step(params_l["blk"], cache_l, z, **kw)
            return (x + y)[:, None], ns
        if c.family == "ssm":
            x, ns_m = inner(ssmlib.mlstm_step, x, params_l["m"],
                            cache_l["m"])
            z = _norm_plain(params_l["s"].get("ln"), x, c.norm)
            y, ns_s = ssmlib.slstm_step(params_l["s"]["blk"], cache_l["s"],
                                        z, n_heads=c.n_heads)
            return (x + y)[:, None], {"m": ns_m, "s": ns_s}
        x, ns_m = inner(ssmlib.mamba2_step, x, params_l["mamba"],
                        cache_l["mamba"])
        hh = x[:, None]
        z = _norm_plain(shared.get("ln1"), hh, c.norm)
        a, nc = self._shared_attn(Tapper(), "attn", shared["attn"], z,
                                  cache=dict(cache_l["attn"], pos=pos))
        hh = hh + a
        z = _norm_plain(shared.get("ln2"), hh, c.norm)
        hh = hh + mlp_apply(Tapper(), "mlp", shared["mlp"], z, c.mlp)
        nc.pop("pos")
        return hh, {"mamba": ns_m, "attn": nc}

    def _layers(self, params, cache, h):
        """Every block in order (``lax.scan``'s) -> (h, the new layers)."""
        new = []
        for i in range(_leading(params["blocks"])):
            h, nc = self._block_step(
                _index(params["blocks"], i), _index(cache["layers"], i), h,
                cache["pos"], params.get("shared"))
            new.append(nc)
        return h, _stack_trees(new)

    def _last_logits(self, params, h):
        h = _norm_plain(params.get("final_norm"), h, self.cfg.norm)
        return self._head(Tapper(), params, h)[:, -1]

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """tokens (B,) -> (logits (B, V), new cache)."""
        h = params["tok_emb"]["emb"][tokens.long()][:, None, :]   # (B,1,D)
        h, layers = self._layers(params, cache, h)
        return self._last_logits(params, h), {"layers": layers,
                                              "pos": cache["pos"] + 1}

    @torch.no_grad()
    def prefill(self, params, tokens, max_len: int):
        """tokens (B, T_prompt) -> (last-token logits (B, V), cache).  The
        recurrent families run one decode step a prompt token, as the
        JAX package does."""
        B, T = tokens.shape
        cache = self.init_cache(B, max_len, device=tokens.device)
        if self.cfg.family not in ATTN_FAMILIES:
            for t in range(T):
                logits, cache = self.decode_step(params, cache, tokens[:, t])
            return logits, cache
        h = params["tok_emb"]["emb"][tokens.long()]
        h, layers = self._layers(params, cache, h)
        if self.cfg.prefill_last_only:
            # Head matmul on the last position only: the (T, V) logits
            # tensor drops to (1, V).
            h = h[:, -1:]
        return self._last_logits(params, h), {"layers": layers,
                                              "pos": cache["pos"] + T}


def _norm_plain(p, x, kind):
    """Norm without taps (serving paths)."""
    return cm.apply_norm(Tapper(), "n", p, x, kind)
