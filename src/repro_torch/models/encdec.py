"""Encoder-decoder LM (the SeamlessM4T-v2 backbone; the JAX package's
``repro.models.encdec``).

The speech/multimodal frontend is a stub, as in the JAX package: the
batch carries precomputed frame embeddings ``src_frames`` (B, T_src,
d_model); the transformer backbone (a bidirectional encoder, and a
causal decoder whose layers run self attention, cross attention over
the encoder's output and an MLP) is real and tapped everywhere for
per-example gradients.  Params and tap names are the JAX package's:
``enc/...`` and ``dec/...`` stacks (a leading layer axis, run by
:func:`~repro_torch.core.tapper.scan_with_taps`; the decoder's under
``remat``), the token embedding, the final norm and the head.

On a model axis (``launch.sharding.model_parallel``) the attention
heads, the MLPs' hidden width and the vocabulary are sliced, with the
dense LM's layout moves (``models/lm.py``): the embedding looked up in
the rank's rows, the head's input copied to ``model``, the cross
entropy over the sliced logits; cross attention's K and V come from the
replicated ``wk`` / ``wv`` on the encoder's output, whose cotangent is
so whole on every rank (``attention.gqa_apply``).  Serving beside
sliced heads is ROADMAP.md item 14 part 3.

Serving (``init_cache``, ``prefill``, ``decode_step``) runs the layers as
a Python loop over the stack under ``torch.no_grad()`` with an inactive
``Tapper``: the prefill encodes the source once, projects each decoder
layer's cross K/V from it once into the cache, and runs the prompt
through the decoder (teacher-forced); each decode step attends to the
self-attention cache and the cached cross K/V.

The JAX package's ``*_input_specs`` helpers (shape specs for its
dry-run) are left out: the port's planner and verifier take a real
batch, which ``launch.train.make_batch_fn`` makes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tapper import Tapper, scan_with_taps
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.tree import tree_map


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- init ----------------------------------------------------------
    def _enc_block(self, gen, kw):
        c = self.cfg
        return {"attn": attn.gqa_init(gen, c.d_model, c.n_heads, c.n_kv,
                                      c.hd, **kw),
                "mlp": mlp_init(gen, c.d_model, c.d_ff, c.mlp, **kw),
                "ln1": cm.norm_init(gen, c.d_model, c.norm, **kw),
                "ln2": cm.norm_init(gen, c.d_model, c.norm, **kw)}

    def _dec_block(self, gen, kw):
        c = self.cfg
        return {"self": attn.gqa_init(gen, c.d_model, c.n_heads, c.n_kv,
                                      c.hd, **kw),
                "cross": attn.gqa_init(gen, c.d_model, c.n_heads, c.n_kv,
                                       c.hd, **kw),
                "mlp": mlp_init(gen, c.d_model, c.d_ff, c.mlp, **kw),
                "ln1": cm.norm_init(gen, c.d_model, c.norm, **kw),
                "ln2": cm.norm_init(gen, c.d_model, c.norm, **kw),
                "ln3": cm.norm_init(gen, c.d_model, c.norm, **kw)}

    def init(self, key: int | torch.Generator = 0, *, device="cuda"):
        """-> (params, logical axes); ``key`` as ``TransformerLM.init``'s."""
        dev = resolve_device(device)
        gen = key if isinstance(key, torch.Generator) \
            else torch.Generator().manual_seed(int(key))
        c = self.cfg
        kw = dict(dtype=c.torch_dtype, device=dev)
        tree = {
            "tok_emb": {"emb": cm.mk(gen, (c.padded_vocab, c.d_model),
                                     ("vocab", "embed"), scale=0.02, **kw)},
            "enc": cm.stack_layers(gen, c.n_enc_layers,
                                   lambda g: self._enc_block(g, kw)),
            "dec": cm.stack_layers(gen, c.n_dec_layers,
                                   lambda g: self._dec_block(g, kw)),
            "final_norm": cm.norm_init(gen, c.d_model, c.norm, **kw),
            "head": {"w": cm.mk(gen, (c.d_model, c.padded_vocab),
                                ("embed", "vocab"), scale=0.02, **kw)},
        }
        if tree["final_norm"] is None:
            tree.pop("final_norm")
        return cm.split_tree(tree)

    def _attn_kw(self):
        c = self.cfg
        return dict(n_heads=c.n_heads, n_kv=c.n_kv, head_dim=c.hd,
                    rope_theta=c.rope_theta, attn_impl=c.attn_impl)

    # -- encode ----------------------------------------------------------
    def encode(self, params, src, tp: Tapper):
        """The bidirectional encoder over source frames (B, S, D)."""
        c = self.cfg

        def body(stp, h, p_l):
            z = cm.apply_norm(stp, "ln1", p_l.get("ln1"), h, c.norm)
            a, _ = attn.gqa_apply(stp, "attn", p_l["attn"], z, causal=False,
                                  **self._attn_kw())
            h = h + a
            z = cm.apply_norm(stp, "ln2", p_l.get("ln2"), h, c.norm)
            return h + mlp_apply(stp, "mlp", p_l["mlp"], z, c.mlp,
                                 d_ff=c.d_ff)

        return scan_with_taps(tp, "enc", body, src, params["enc"])

    # -- train -----------------------------------------------------------
    def logits(self, params, src, tokens, tp: Tapper | None = None):
        """(B, T, V) logits of one forward: the source encoded, the
        tokens decoded causally against it (the training path, tapped
        through ``tp``)."""
        c = self.cfg
        tp = tp or Tapper()
        enc_out = self.encode(params, src.to(c.torch_dtype), tp)
        h = tp.embed("tok_emb", params["tok_emb"]["emb"], tokens,
                     n_rows=c.padded_vocab)

        def body(stp, hh, p_l):
            z = cm.apply_norm(stp, "ln1", p_l.get("ln1"), hh, c.norm)
            a, _ = attn.gqa_apply(stp, "self", p_l["self"], z, causal=True,
                                  **self._attn_kw())
            hh = hh + a
            z = cm.apply_norm(stp, "ln2", p_l.get("ln2"), hh, c.norm)
            a, _ = attn.gqa_apply(stp, "cross", p_l["cross"], z,
                                  x_kv=enc_out, **self._attn_kw())
            hh = hh + a
            z = cm.apply_norm(stp, "ln3", p_l.get("ln3"), hh, c.norm)
            return hh + mlp_apply(stp, "mlp", p_l["mlp"], z, c.mlp,
                                  d_ff=c.d_ff)

        h = scan_with_taps(tp, "dec", body, h, params["dec"], remat=c.remat)
        h = cm.apply_norm(tp, "final_norm", params.get("final_norm"), h,
                          c.norm)
        w = params["head"]["w"]
        if sh.split(w.shape[1], c.padded_vocab):
            h = sh.copy_to_model(h)
        return tp.dense("head", h, w)

    def apply(self, params, batch, tp: Tapper):
        c = self.cfg
        return cm.per_example_xent(
            self.logits(params, batch["src_frames"], batch["tokens"], tp),
            batch["labels"], batch.get("mask"), vocab_valid=c.vocab,
            n_vocab=c.padded_vocab)

    # -- serve -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, src_len: int, *,
                   device="cuda"):
        """An empty cache: per decoder layer the self-attention K and V
        and the cross K and V (stacked with a leading L), and ``pos`` (a
        Python int)."""
        _no_sliced_caches()
        c = self.cfg
        dev = resolve_device(device)
        one = attn.gqa_cache(batch, max_len, c.n_kv, c.hd, c.torch_dtype,
                             device=dev)
        pos = one.pop("pos")
        L = c.n_dec_layers
        z = dict(dtype=c.torch_dtype, device=dev)
        return {
            "self": {k: torch.zeros((L,) + v.shape, **z)
                     for k, v in one.items()},
            "cross_k": torch.zeros((L, batch, src_len, c.n_kv, c.hd), **z),
            "cross_v": torch.zeros((L, batch, src_len, c.n_kv, c.hd), **z),
            "pos": pos,
        }

    def _cross_decode(self, p_l, z, k_l, v_l):
        c = self.cfg
        B, T, _ = z.shape
        q = torch.matmul(z, p_l["cross"]["wq"]["w"]).reshape(
            B, T, c.n_heads, c.hd)
        rep = c.n_heads // c.n_kv
        out = attn.attend(q, attn.repeat_kv(k_l, rep),
                          attn.repeat_kv(v_l, rep), causal=False, impl="xla")
        return torch.matmul(out.reshape(B, T, c.n_heads * c.hd),
                            p_l["cross"]["wo"]["w"])

    def _layers(self, params, cache, h):
        """Every decoder layer in order against the cache -> (h, the new
        self-attention cache)."""
        _no_sliced_caches()
        c = self.cfg
        tp = Tapper()
        new = []
        for i in range(c.n_dec_layers):
            p_l = tree_map(lambda a: a[i], params["dec"])
            cl = {k: v[i] for k, v in cache["self"].items()}
            cl["pos"] = cache["pos"]
            z = cm.apply_norm(tp, "ln1", p_l.get("ln1"), h, c.norm)
            a, nc = attn.gqa_apply(tp, "self", p_l["self"], z, cache=cl,
                                   **self._attn_kw())
            h = h + a
            z = cm.apply_norm(tp, "ln2", p_l.get("ln2"), h, c.norm)
            h = h + self._cross_decode(p_l, z, cache["cross_k"][i],
                                       cache["cross_v"][i])
            z = cm.apply_norm(tp, "ln3", p_l.get("ln3"), h, c.norm)
            h = h + mlp_apply(tp, "mlp", p_l["mlp"], z, c.mlp)
            nc.pop("pos")
            new.append(nc)
        return h, {k: torch.stack([n[k] for n in new]) for k in new[0]}

    def _last_logits(self, params, h):
        h = cm.apply_norm(Tapper(), "fn", params.get("final_norm"), h,
                          self.cfg.norm)
        return torch.matmul(h[:, -1], params["head"]["w"])

    @torch.no_grad()
    def prefill(self, params, src, tokens, max_len: int):
        """Encode + teacher-forced decoder prefill: src (B, S, D), tokens
        (B, T_prompt) -> (last-token logits (B, V), cache)."""
        c = self.cfg
        B, T = tokens.shape
        src = src.to(c.torch_dtype)
        enc_out = self.encode(params, src, Tapper())
        S = enc_out.shape[1]
        cache = self.init_cache(B, max_len, S, device=tokens.device)
        # per-layer cross K/V, computed once
        cross = params["dec"]["cross"]
        for k in ("k", "v"):
            cache[f"cross_{k}"] = torch.matmul(
                enc_out[None], cross[f"w{k}"]["w"][:, None]).reshape(
                c.n_dec_layers, B, S, c.n_kv, c.hd)
        h = params["tok_emb"]["emb"][tokens.long()]
        h, cache["self"] = self._layers(params, cache, h)
        if c.prefill_last_only:
            h = h[:, -1:]
        cache["pos"] = cache["pos"] + T
        return self._last_logits(params, h), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """tokens (B,) -> (logits (B, V), new cache)."""
        h = params["tok_emb"]["emb"][tokens.long()][:, None, :]
        h, layers = self._layers(params, cache, h)
        return self._last_logits(params, h), dict(
            cache, self=layers, pos=cache["pos"] + 1)


def _no_sliced_caches():
    if sh.active() is not None:
        raise NotImplementedError(
            f"the enc-dec family's self and cross caches beside sliced "
            f"heads are {sh.DEFERRED}")
