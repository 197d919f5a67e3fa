"""Deterministic synthetic datasets + Poisson subsampling for DP.

Examples are pure functions of (seed, index) — no state, no files — so any
host can materialize any shard and restarts are exactly reproducible; this
is the property a 1000-node data pipeline needs (the loader never
checkpoints data state, only the step counter).

DP-SGD's privacy amplification assumes Poisson sampling: each example is
included independently with rate q per step.  ``poisson_batch_indices``
implements that (deterministically per step), padding/truncating to a
fixed batch size for shape-stable jit with a mask for the padding.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=abs(hash((seed,) + salt))
                                                % (1 << 63)))


class SyntheticLMDataset:
    """Deterministic token streams with local n-gram structure (so loss can
    actually decrease) over ``vocab`` tokens."""

    def __init__(self, vocab: int, seq_len: int, n_examples: int = 1 << 16,
                 seed: int = 0):
        self.vocab, self.seq_len, self.n = vocab, seq_len, n_examples
        self.seed = seed

    def __len__(self):
        return self.n

    @property
    def _perm(self):
        if not hasattr(self, "_perm_cache"):
            self._perm_cache = _rng(self.seed, 12345).permutation(self.vocab)
        return self._perm_cache

    def example(self, idx: int) -> dict:
        g = _rng(self.seed, int(idx))
        # ε-noisy global bigram: next = perm[cur] w.p. 0.9, else uniform —
        # a learnable signal (optimal loss ≈ 0.1·lnV + H(0.1)) so training
        # tests can assert decrease.
        perm = self._perm
        toks = np.empty(self.seq_len + 1, np.int64)
        toks[0] = g.integers(0, self.vocab)
        noise = g.random(self.seq_len) < 0.1
        rand = g.integers(0, self.vocab, self.seq_len)
        for t in range(self.seq_len):
            toks[t + 1] = rand[t] if noise[t] else perm[toks[t]]
        return {"tokens": toks[:-1].astype(np.int32),
                "labels": toks[1:].astype(np.int32)}

    def batch(self, indices) -> dict:
        exs = [self.example(i) for i in indices]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}


class SyntheticImageDataset:
    """Class-conditional Gaussian blobs (CNN examples/benchmarks)."""

    def __init__(self, img_size: int = 32, n_classes: int = 10,
                 n_examples: int = 1 << 14, seed: int = 0):
        self.img, self.k, self.n, self.seed = img_size, n_classes, n_examples, seed
        g = _rng(seed, 999)
        self.protos = g.normal(0, 1, (n_classes, 3, img_size, img_size))

    def __len__(self):
        return self.n

    def example(self, idx: int) -> dict:
        g = _rng(self.seed, int(idx))
        y = int(g.integers(0, self.k))
        x = self.protos[y] + g.normal(0, 0.8, self.protos[y].shape)
        return {"img": x.astype(np.float32), "label": np.int32(y)}

    def batch(self, indices) -> dict:
        exs = [self.example(i) for i in indices]
        return {"img": np.stack([e["img"] for e in exs]),
                "label": np.stack([e["label"] for e in exs])}


def poisson_batch_indices(step: int, n_examples: int, rate: float,
                          fixed_batch: int, seed: int = 0):
    """Deterministic Poisson subsample for one step.

    Returns (indices (fixed_batch,), mask (fixed_batch,)): sampled examples
    padded (mask 0) or truncated to the fixed jit batch size.
    """
    g = _rng(seed, 7, step)
    draw = g.random(n_examples) < rate
    idx = np.nonzero(draw)[0]
    g.shuffle(idx)
    idx = idx[:fixed_batch]
    mask = np.zeros(fixed_batch, np.float32)
    mask[: len(idx)] = 1.0
    out = np.zeros(fixed_batch, np.int64)
    out[: len(idx)] = idx
    return out, mask
