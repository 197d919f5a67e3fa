"""Rényi differential privacy accountant for subsampled Gaussian mechanisms.

Implements the moments-accountant bound of Abadi et al. (2016) in its RDP
form (Mironov 2017; Mironov-Talwar-Zhang 2019 for the sampled Gaussian):
for integer orders α ≥ 2 and Poisson sampling rate q,

    RDP(α) = 1/(α−1) · log Σ_{k=0}^{α} C(α,k) (1−q)^{α−k} q^k
                           · exp(k(k−1)/(2σ²))

composed linearly over steps, then converted to (ε, δ) via
ε = min_α [ RDP_total(α) + log(1/δ)/(α−1) ].

Pure numpy — no jax dependency — so the accountant can run on the host
alongside a training loop.

Clipping-mode accounting notes
------------------------------
The accountant only assumes the mechanism's L2 sensitivity is the ``C``
the noise σC was calibrated against.

  * ``flat``      — each example's contribution is clipped to ‖·‖ ≤ C:
    sensitivity C, exactly.
  * ``per_layer`` — layer l clipped to C_l; an example's total
    contribution satisfies ‖·‖² = Σ_l ‖clip_l‖² ≤ Σ_l C_l², so the
    budget invariant Σ_l C_l² = C² (enforced by
    ``clipping.resolve_budgets`` and checked with
    :func:`clipping_sensitivity`) keeps the sensitivity at C with the
    same accountant.
  * ``stale``     — coefficients come from the *previous* step's norms,
    so this step's contribution is bounded by C only under the lagged
    norms, not unconditionally; the engine's bootstrap step is exact,
    and steady-state steps are "exactly-as-specified-stale" (the oracle
    suite pins that semantics).  Treat ε reported under stale clipping
    as conditional on the staleness assumption — this is the documented
    trade of Lee & Kifer-style reorganized clipping passes.
"""
from __future__ import annotations

import math

import numpy as np

DEFAULT_ORDERS = tuple(range(2, 64)) + tuple(range(64, 513, 8))


def clipping_sensitivity(budgets) -> float:
    """L2 sensitivity of a per-layer-clipped per-example contribution:
    ``sqrt(Σ_l C_l²)``.  The noise calibration σ·C stays valid exactly
    when this equals the configured ``C`` — the invariant every budget
    split must preserve (property-tested in tests/test_clip_modes.py)."""
    b = np.asarray(budgets, np.float64)
    return float(np.sqrt(np.sum(b * b)))


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def rdp_subsampled_gaussian(q: float, sigma: float,
                            orders=DEFAULT_ORDERS) -> np.ndarray:
    """Per-step RDP at each order."""
    if sigma <= 0:
        return np.full(len(orders), np.inf)
    out = []
    for a in orders:
        a = int(a)
        if q >= 1.0:
            out.append(a / (2 * sigma ** 2))
            continue
        if q == 0.0:
            out.append(0.0)
            continue
        terms = []
        for k in range(a + 1):
            lt = (_log_binom(a, k) + (a - k) * math.log1p(-q)
                  + k * math.log(q) + k * (k - 1) / (2 * sigma ** 2))
            terms.append(lt)
        m = max(terms)
        lse = m + math.log(sum(math.exp(t - m) for t in terms))
        out.append(lse / (a - 1))
    return np.asarray(out)


def eps_from_rdp(rdp_total: np.ndarray, orders, delta: float) -> float:
    orders = np.asarray(orders, dtype=np.float64)
    eps = rdp_total + math.log(1.0 / delta) / (orders - 1)
    return float(np.min(eps))


class LedgerMismatch(ValueError):
    """A restored ledger describes a different mechanism (q, σ, orders)
    than the live accountant — continuing would compose RDP curves of two
    different mechanisms under one ε, silently corrupting the guarantee."""


class PrivacyAccountant:
    """Tracks composition over training steps.

    The accountant's full state is its ledger — ``state_dict()`` /
    ``load_state_dict()`` round-trip it through checkpoints so a restart
    resumes the ε composition exactly where the checkpoint left it (the
    replayed steps re-run the *same* deterministic mechanism outputs, so
    they are not new releases and must not be double-counted)."""

    def __init__(self, sampling_rate: float, noise_multiplier: float,
                 orders=DEFAULT_ORDERS):
        self.q = float(sampling_rate)
        self.sigma = float(noise_multiplier)
        self.orders = tuple(orders)
        self._per_step = rdp_subsampled_gaussian(self.q, self.sigma,
                                                 self.orders)
        self.steps = 0

    def step(self, n: int = 1):
        self.steps += n

    # -- ledger (de)serialization ---------------------------------------

    def state_dict(self) -> dict:
        """JSON-able ledger: the composed step count plus the mechanism
        parameters it was composed under (so a restore can refuse to graft
        it onto a different mechanism)."""
        return {"steps": int(self.steps), "q": self.q, "sigma": self.sigma,
                "orders": [int(a) for a in self.orders]}

    def load_state_dict(self, state: dict):
        """Resume a checkpointed ledger.  Fails loudly (LedgerMismatch) if
        the checkpoint was accounted under different mechanism parameters
        — that is a privacy bug, not a resumable condition."""
        for field, mine in (("q", self.q), ("sigma", self.sigma)):
            theirs = float(state[field])
            if theirs != mine:
                raise LedgerMismatch(
                    f"checkpointed ledger has {field}={theirs}, this "
                    f"accountant runs {field}={mine}; refusing to resume "
                    f"a ledger accounted under a different mechanism")
        if "orders" in state and tuple(state["orders"]) != \
                tuple(int(a) for a in self.orders):
            raise LedgerMismatch(
                "checkpointed ledger used different RDP orders; refusing "
                "to resume (ε would be composed over mismatched curves)")
        self.steps = int(state["steps"])

    @classmethod
    def from_state(cls, state: dict) -> "PrivacyAccountant":
        acct = cls(sampling_rate=state["q"], noise_multiplier=state["sigma"],
                   orders=tuple(state.get("orders", DEFAULT_ORDERS)))
        acct.steps = int(state["steps"])
        return acct

    def reset(self):
        """Back to zero composed steps (a from-scratch in-process restart
        with no checkpoint to resume from)."""
        self.steps = 0

    def epsilon(self, delta: float = 1e-5) -> float:
        if self.sigma <= 0:
            return float("inf")
        return eps_from_rdp(self._per_step * self.steps, self.orders, delta)

    def report(self, delta: float = 1e-5) -> str:
        return (f"DP: steps={self.steps} q={self.q} sigma={self.sigma} "
                f"-> eps={self.epsilon(delta):.3f} at delta={delta}")
