"""PrivacyEngine: the DP-SGD public surface on one device.

Make-private-once, step-many: construct the engine once from the model's
``apply_fn``, the params, an example batch and a :class:`DPConfig`, then
call :meth:`PrivacyEngine.private_step` per step (gradient, per-example
clipping, noise and the optimizer update, with accountant bookkeeping).

This slice runs the fixed strategies (naive / multi / crb / ghost / bk)
with flat clipping.  ``strategy="auto"`` and plans, meshes and
calibration come with ROADMAP.md items 9, 13 and 14 and raise
``NotImplementedError`` here.

Noise: step ``n``'s noise is drawn from a ``torch.Generator`` on the
engine's device seeded from ``SeedSequence([run_seed, n])`` — a pure
function of (run_seed, n), so a replayed step re-adds the *same* noise
and the accountant's ledger stays the truth.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.clipping import (DPConfig, check_served, dp_gradient,
                                       resolve_microbatches)
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.device import resolve_device


class KeyProvenanceError(ValueError):
    """An explicit noise generator contradicts the engine's deterministic
    noise stream (the seed of ``(run_seed, step)``)."""


def _resolve_optimizer(optimizer) -> Callable:
    if callable(optimizer):
        return optimizer
    from repro_torch.optim import adamw_update, sgdm_update
    table = {"adamw": adamw_update, "sgdm": sgdm_update}
    try:
        return table[optimizer]
    except KeyError:
        raise ValueError(f"unknown optimizer {optimizer!r}; pass one of "
                         f"{sorted(table)} or an update callable") from None


def noise_seed(run_seed: int, step: int) -> int:
    """The 63-bit seed of step ``step``'s noise generator."""
    s = np.random.SeedSequence([int(run_seed), int(step)])
    return int(s.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


class PrivacyEngine:
    """DP-SGD driver bound to one (model, batch shape, config, device).

    Parameters:
      apply_fn:   ``apply_fn(params, batch, tapper) -> (B,) losses``.
      params:     parameter tree (only its structure is checked here).
      batch_spec: an example batch (kept for the JAX package's signature).
      dp:         :class:`DPConfig` with a fixed strategy.
      optimizer:  "adamw" | "sgdm" | ``update(grads, state, params, *, lr,
                  weight_decay) -> (params, state)``.
      lr:         learning rate, or ``lr(opt_step) -> lr``.
      sampling_rate / accountant: privacy accounting — the Poisson
                  sampling rate (an accountant is built) or an existing
                  :class:`PrivacyAccountant`.
      run_seed:   seed of the deterministic per-step noise stream
                  (:meth:`noise_key`); pass ``step=`` to the step methods.
      device:     where the step runs; ``"cuda"`` unless the caller asks
                  for ``"cpu"``.
      plan, mesh, calibration: not served yet (raise).
    """

    def __init__(self, apply_fn: Callable, params, batch_spec,
                 dp: DPConfig | None = None, *, optimizer="adamw",
                 lr=1e-3, weight_decay: float = 0.0,
                 sampling_rate: float | None = None,
                 accountant: PrivacyAccountant | None = None,
                 plan=None, mesh=None, calibration=None,
                 run_seed: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.dp = dp if dp is not None else DPConfig()
        if self.dp.strategy == "auto" or plan is not None:
            raise NotImplementedError(
                "strategy='auto' and injected plans need the planner "
                "(ROADMAP.md item 9); pass a fixed strategy "
                "(naive / multi / crb / ghost / bk)")
        if mesh is not None:
            raise NotImplementedError(
                "sharded execution comes with ROADMAP.md item 14")
        if calibration is not None:
            raise NotImplementedError(
                "calibration comes with ROADMAP.md item 13")
        if self.dp.clipping.mode != "flat":
            raise NotImplementedError(
                f"clipping mode {self.dp.clipping.mode!r} comes with the "
                f"planner slice (ROADMAP.md item 9)")
        check_served(self.dp)
        self.apply_fn = apply_fn
        self._update_fn = _resolve_optimizer(optimizer)
        self._lr = lr
        self._weight_decay = weight_decay
        if accountant is None and sampling_rate is not None:
            accountant = PrivacyAccountant(
                sampling_rate=sampling_rate,
                noise_multiplier=self.dp.noise_multiplier)
        self.accountant = accountant
        self.run_seed = run_seed

    def explain(self) -> str:
        return (f"PrivacyEngine: strategy={self.dp.strategy} "
                f"C={self.dp.l2_clip} sigma={self.dp.noise_multiplier} "
                f"clipping=flat microbatches={self.microbatches()} "
                f"device={self.device} norm={self.dp.norm} (fixed strategy: "
                f"no plan)")

    def microbatches(self) -> int:
        return resolve_microbatches(self.dp)

    # -- noise ---------------------------------------------------------------

    def noise_key(self, step: int) -> torch.Generator:
        """A fresh generator on the engine's device for step ``step``'s
        noise, seeded from (run_seed, step) alone."""
        if self.run_seed is None:
            raise ValueError(
                "engine has no noise stream; construct with run_seed=")
        g = torch.Generator(device=self.device)
        g.manual_seed(noise_seed(self.run_seed, step))
        return g

    def _check_key(self, key, step=None):
        if key is None and step is not None and self.run_seed is not None:
            return self.noise_key(step)
        if key is None:
            if self.dp.noise_multiplier > 0:
                raise ValueError(
                    "noise_multiplier > 0 requires a noise generator per "
                    "step (or construct the engine with run_seed= and pass "
                    "step=)")
            return None
        if step is not None:
            if self.run_seed is None:
                raise KeyProvenanceError(
                    f"key= passed with step={step} but the engine has no "
                    f"noise stream (construct with run_seed=)")
            if key.initial_seed() != noise_seed(self.run_seed, step):
                raise KeyProvenanceError(
                    f"key= was not seeded for step={step} of run_seed="
                    f"{self.run_seed}; replaying this step would draw "
                    f"different noise than the accounted run")
        return key

    # -- execution -----------------------------------------------------------

    def noisy_grad(self, params, batch, key=None, denom: int | None = None,
                   *, step: int | None = None):
        """(mean loss, noised clipped mean gradient, aux)."""
        return dp_gradient(self.apply_fn, params, batch, cfg=self.dp,
                           key=self._check_key(key, step), denom=denom)

    def private_step(self, params, opt, batch, key=None, *,
                     step: int | None = None):
        """One DP-SGD step: gradient + clip + noise + optimizer update, and
        one step on the accountant.  Returns (params, opt, loss, aux)."""
        loss, grad, aux = self.noisy_grad(params, batch, key, step=step)
        lr = self._lr(opt["step"]) if callable(self._lr) else self._lr
        params, opt = self._update_fn(grad, opt, params, lr=lr,
                                      weight_decay=self._weight_decay)
        if self.accountant is not None:
            self.accountant.step()
        return params, opt, loss, aux

    # -- accounting ----------------------------------------------------------

    def epsilon(self, delta: float | None = None) -> float:
        if self.accountant is None:
            raise ValueError("engine has no accountant; pass sampling_rate=")
        return self.accountant.epsilon(delta if delta is not None
                                       else self.dp.delta)

    def report(self, delta: float | None = None) -> str:
        if self.accountant is None:
            return "DP: no accountant attached"
        return self.accountant.report(delta if delta is not None
                                      else self.dp.delta)
