"""Decoder-only language model, family ``dense`` (Llama-style: RMSNorm,
GQA with RoPE, SwiGLU, optionally tied embeddings).

Training applies go through the tapper, so DP per-example gradients
cover every parameter: the embedding gather (``tok_emb``), every
scanned block's norms and projections (``blocks/...``, stacked with a
leading layer axis by :func:`~repro_torch.core.tapper.scan_with_taps`),
the final norm and the head — with tied embeddings the head is the
transposed table, tapped as ``"~tok_emb"`` so the two uses of one
parameter form one group.  Params and tap names are the JAX package's.

The other families (MoE, SSM, hybrid, VLM), MLA, ``remat=True`` and the
serving paths (``prefill``, ``decode_step``, ``init_cache``) come with
the rest of the LM slice (ROADMAP.md item 11) and raise
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


def _item11(what: str):
    return NotImplementedError(
        f"{what} comes with the rest of the LM slice (ROADMAP.md item 11)")


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise _item11(f"LM family {cfg.family!r}")
        if cfg.mla:
            raise _item11("MLA (multi-head latent attention)")
        if cfg.n_experts:
            raise _item11("MoE blocks")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # init

    def _block_init(self, gen, dev):
        c = self.cfg
        kw = dict(dtype=c.torch_dtype, device=dev)
        p = {"attn": attn.gqa_init(gen, c.d_model, c.n_heads, c.n_kv, c.hd,
                                   qk_norm=c.qk_norm, bias=c.attn_bias,
                                   **kw),
             "ln1": cm.norm_init(gen, c.d_model, c.norm, **kw),
             "ln2": cm.norm_init(gen, c.d_model, c.norm, **kw),
             "mlp": mlp_init(gen, c.d_model, c.d_ff, c.mlp, **kw)}
        return {k: v for k, v in p.items() if v is not None}

    def init(self, key: int | torch.Generator = 0, *, device="cuda"):
        """-> (params, logical axes).  ``key`` seeds a CPU generator (or is
        one), so a seed gives the same weights on every device."""
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

    def _attn_kw(self):
        c = self.cfg
        return dict(n_heads=c.n_heads, n_kv=c.n_kv, head_dim=c.hd,
                    rope_theta=c.rope_theta, qk_norm=c.qk_norm,
                    attn_impl=c.attn_impl, dp_attn=c.dp_attn)

    def _head(self, tp, params, h):
        c = self.cfg
        if c.tie_embeddings:
            return tp.dense("~tok_emb", h, params["tok_emb"]["emb"],
                            w_transposed=True, param_key="emb")
        return tp.dense("head", h, params["head"]["w"])

    def _backbone_train(self, params, h, tp: Tapper):
        c = self.cfg
        if c.remat:
            # The reference wraps each scanned block in jax.checkpoint;
            # running without it would change the memory a config was
            # sized for, so the knob is refused until it is served.
            raise NotImplementedError(
                "remat=True (per-layer torch.utils.checkpoint with the "
                "captures intact) comes with ROADMAP.md item 11c")

        def body(stp, hh, p_l):
            a, _ = attn.gqa_apply(
                stp, "attn", p_l["attn"],
                cm.apply_norm(stp, "ln1", p_l.get("ln1"), hh, c.norm),
                **self._attn_kw())
            hh = hh + a
            x2 = cm.apply_norm(stp, "ln2", p_l.get("ln2"), hh, c.norm)
            return hh + mlp_apply(stp, "mlp", p_l["mlp"], x2, c.mlp)

        return scan_with_taps(tp, "blocks", body, h, params["blocks"])

    # ------------------------------------------------------------------
    # training apply: per-example losses

    def apply(self, params, batch, tp: Tapper):
        c = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        h = tp.embed("tok_emb", params["tok_emb"]["emb"], tokens)
        h = self._backbone_train(params, h, tp)
        h = cm.apply_norm(tp, "final_norm", params.get("final_norm"), h,
                          c.norm)
        logits = self._head(tp, params, h)
        return cm.per_example_xent(logits, labels, batch.get("mask"),
                                   vocab_valid=c.vocab)

    # ------------------------------------------------------------------
    # serving

    def init_cache(self, batch: int, max_len: int):
        raise _item11("the KV cache (serving)")

    def prefill(self, *args, **kwargs):
        raise _item11("prefill (serving)")

    def decode_step(self, *args, **kwargs):
        raise _item11("decode_step (serving)")
