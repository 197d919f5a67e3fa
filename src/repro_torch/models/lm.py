"""Decoder-only language models, families ``dense``, ``moe`` and ``vlm``
(an early-fusion backbone over token ids): RMSNorm or LayerNorm (affine
or not), GQA with RoPE and optional qk-norm or MLA (``mla=True``:
DeepSeek's latent attention, its cache the latent KV), SwiGLU or a
mixture of SwiGLU experts (``n_experts``: :mod:`repro_torch.models.moe`,
its per-example load-balance loss carried through the layers and added
to each example's loss as ``moe_lb_coef · lb / n_layers``), optionally
tied embeddings.  With ``dp_attn`` each block's attention is tapped as
one ``"attn"`` layer.

Training applies go through the tapper, so DP per-example gradients
cover every parameter: the embedding gather (``tok_emb``), every
scanned block's norms and projections (``blocks/...``, stacked with a
leading layer axis by :func:`~repro_torch.core.tapper.scan_with_taps`,
each block recomputed in the backward under ``remat=True``), the final
norm and the head — with tied embeddings the head is the transposed
table, tapped as ``"~tok_emb"`` so the two uses of one parameter form one
group.  Params and tap names are the JAX package's.

Serving (``init_cache``, ``prefill``, ``decode_step``) takes the same
params, runs the layers as a Python loop over the stack against a KV
cache, under ``torch.no_grad()`` with an inactive ``Tapper``.

The SSM and hybrid families (ROADMAP.md item 12, part 2) raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tapper import Tapper, scan_with_taps
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.tree import tree_map


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} comes with ROADMAP.md item {item}")


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise _unported(f"LM family {cfg.family!r}", "12, part 2")
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
        tree["blocks"] = cm.stack_layers(
            gen, c.n_layers, lambda g: self._block_init(g, dev))
        fn = cm.norm_init(gen, c.d_model, c.norm, **kw)
        if fn is not None:
            tree["final_norm"] = fn
        if not c.tie_embeddings:
            tree["head"] = {"w": cm.mk(gen, (c.d_model, c.padded_vocab),
                                       ("embed", "vocab"), scale=0.02, **kw)}
        return cm.split_tree(tree)

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
            return tp.dense("~tok_emb", h, params["tok_emb"]["emb"],
                            w_transposed=True, param_key="emb")
        return tp.dense("head", h, params["head"]["w"])

    def _ffn(self, tp, p_l, x):
        """The block's feed-forward: (out, per-example load-balance loss
        of a MoE block, else None)."""
        c = self.cfg
        if c.n_experts:
            return moe_apply(tp, "moe", p_l["moe"], x, impl=c.moe_impl,
                             n_experts=c.n_experts, topk=c.topk,
                             capacity_factor=c.capacity_factor)
        return mlp_apply(tp, "mlp", p_l["mlp"], x, c.mlp), None

    def _backbone_train(self, params, h, tp: Tapper):
        """-> (h, the load-balance loss summed over the layers, (B,))."""
        c = self.cfg

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
        h = tp.embed("tok_emb", params["tok_emb"]["emb"], tokens)
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
                                     batch.get("mask"), vocab_valid=c.vocab)
        if c.n_experts:
            losses = losses + c.moe_lb_coef * lb / max(c.n_layers, 1)
        return losses

    # ------------------------------------------------------------------
    # serving: cache, prefill, decode

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        """An empty cache: per layer K and V (MLA: the latent ``ckv`` and
        ``krope``), stacked with a leading L, and the number of positions
        written (``pos``, a Python int)."""
        c = self.cfg
        dev = resolve_device(device)
        one = (attn.mla_cache(batch, max_len, c.kv_lora_rank, c.qk_rope_dim,
                              c.torch_dtype, device=dev) if c.mla
               else attn.gqa_cache(batch, max_len, c.n_kv, c.hd,
                                   c.torch_dtype, device=dev))
        pos = one.pop("pos")
        return {"layers": {k: torch.zeros((c.n_layers,) + v.shape,
                                          dtype=v.dtype, device=v.device)
                           for k, v in one.items()}, "pos": pos}

    def _block_step(self, params_l, cache_l, h, pos):
        """One layer applied to new tokens h (B, T, D) against its cache."""
        c = self.cfg
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

    def _layers(self, params, cache, h):
        """Every layer in order (``lax.scan``'s) -> (h, the new layers)."""
        new = []
        for i in range(self.cfg.n_layers):
            h, nc = self._block_step(
                tree_map(lambda a: a[i], params["blocks"]),
                tree_map(lambda a: a[i], cache["layers"]), h, cache["pos"])
            new.append(nc)
        return h, {k: torch.stack([n[k] for n in new]) for k in new[0]}

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
        """tokens (B, T_prompt) -> (last-token logits (B, V), cache)."""
        B, T = tokens.shape
        cache = self.init_cache(B, max_len, device=tokens.device)
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
