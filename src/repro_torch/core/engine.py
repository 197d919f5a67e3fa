"""PrivacyEngine: the plan-first DP-SGD public surface on one device.

Make-private-once, step-many: construct the engine once from the model's
``apply_fn``, the params, an example batch and a :class:`DPConfig`; the
per-layer :class:`~repro_torch.core.costmodel.ExecPlan` is then a
first-class value —

  * ``engine.plan()``          the frozen plan (built once, cached);
  * ``engine.explain()``       per-layer table of the chosen norm/sum
                               realizations with predicted FLOPs/bytes;
  * ``plan.to_json()``         the plan as JSON, keyed on
                               ``engine.fingerprint()`` (model + shapes +
                               knobs + the port's sources); an injected
                               ``plan=`` is checked against it;
  * ``engine.microbatches()``  plan-driven ``microbatches="auto"``;
  * ``engine.private_step()``  gradient + clip + noise + optimizer update,
                               with accountant bookkeeping.

Steady state executes exactly one forward and one backward per step for
``strategy="auto"`` (counters in :data:`repro_torch.core.tapper.STATS`).
Flat, per-layer and stale clipping thread their cross-step state here
(:meth:`clip_state_dict`).  :meth:`save_plan` writes the plans the
engine executes to the on-disk plan store (``costmodel.load_plan_store``
reads them back).  Plans are priced under the engine's calibration
(measured constants of its device, :mod:`repro_torch.calibrate`) or the
analytic table; :meth:`observe_step_time` feeds measured step times to
the mispredict loop, which retimes the calibration and re-plans when the
prediction is off.  Meshes come with ROADMAP.md item 14 and raise
``NotImplementedError``.

Noise: step ``n``'s noise is drawn from a ``torch.Generator`` on the
engine's device seeded from ``SeedSequence([run_seed, n])`` — a pure
function of (run_seed, n), so a replayed step re-adds the *same* noise
and the accountant's ledger stays the truth.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.clipping import (DPConfig, check_served, dp_gradient,
                                       resolve_budgets, resolve_microbatches)
from repro_torch.core.privacy import PrivacyAccountant, clipping_sensitivity
from repro_torch.core.tapper import TensorSpec, spec_of
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


class KeyProvenanceError(ValueError):
    """An explicit noise generator contradicts the engine's deterministic
    noise stream (the seed of ``(run_seed, step)``)."""


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One firing of the engine's mispredict loop: measured step time
    diverged from the calibrated prediction beyond the threshold, the
    calibration was retimed from the observation, and the plan was
    rebuilt under the new constants.  Surfaced in :meth:`explain` and
    (when a monitor is attached) in ``StepMonitor.replans``."""

    step: int                 # step the divergence was confirmed at (-1 unknown)
    ratio: float              # measured / predicted at trigger time
    predicted_s: float
    measured_s: float
    old_calibration: str      # digests
    new_calibration: str
    old_fingerprint: str
    new_fingerprint: str
    plan_changed: bool        # did any layer's realization actually flip


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
    """Plan-first DP-SGD engine bound to one (model, batch shape, config,
    device).

    Parameters:
      apply_fn:   ``apply_fn(params, batch, tapper) -> (B,) losses``.
      params:     parameter tree (only shapes and dtypes are retained).
      batch_spec: an example batch fixing the step's batch shapes.
      dp:         :class:`DPConfig`.
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
      plan:       inject a pre-built or deserialized ExecPlan (must match
                  the model, shapes, clipping mode, planner knobs and
                  calibration; validated up front with named-field errors
                  and again at execution).
      mesh:       not served yet (raises; ROADMAP.md item 14).
      calibration: measured cost constants for planning.  ``None`` takes
                  the calibration registered for the engine's device, if
                  any; ``"analytic"`` plans from the analytic constants;
                  a :class:`repro_torch.calibrate.Calibration` is
                  validated strictly against the device (named errors on
                  mismatch); a path loads a stored blob *softly* (an
                  unusable blob degrades to the analytic constants with a
                  ``CalibrationFallbackWarning``); ``"measure"`` runs the
                  harness once per device and process (full sizes on the
                  card, quick ones on the CPU).  The calibration the
                  engine plans under is registered for its device, so
                  its kernel sweep winners reach the kernel wrappers
                  (``ops.pe_conv_tile_rows``).
      mispredict_threshold: relative divergence of measured vs predicted
                  step time that triggers a re-plan (``0.5`` = beyond
                  ±50 %); ``None`` disables the loop.  Feed measured step
                  times to :meth:`observe_step_time`.
      monitor:    a ``runtime.StepMonitor`` to record re-plans in.
    """

    def __init__(self, apply_fn: Callable, params, batch_spec,
                 dp: DPConfig | None = None, *, optimizer="adamw",
                 lr=1e-3, weight_decay: float = 0.0,
                 sampling_rate: float | None = None,
                 accountant: PrivacyAccountant | None = None,
                 plan=None, mesh=None, calibration=None,
                 mispredict_threshold: float | None = 0.5, monitor=None,
                 run_seed: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.dp = dp if dp is not None else DPConfig()
        if mesh is not None:
            raise NotImplementedError(
                "sharded execution comes with ROADMAP.md item 14")
        self.apply_fn = apply_fn
        self._params_spec = tree_map(spec_of, params)
        self._batch_spec = tree_map(spec_of, batch_spec)
        self._update_fn = _resolve_optimizer(optimizer)
        self._lr = lr
        self._weight_decay = weight_decay
        if accountant is None and sampling_rate is not None:
            accountant = PrivacyAccountant(
                sampling_rate=sampling_rate,
                noise_multiplier=self.dp.noise_multiplier)
        self.accountant = accountant
        self._calibration = self._resolve_calibration_arg(calibration)
        self.mispredict_threshold = mispredict_threshold
        self._monitor = monitor
        self.replan_events: list[ReplanEvent] = []
        self._step_ema: float | None = None
        self._step_obs = 0
        if plan is not None and self.dp.strategy == "auto":
            # Fail loudly *now* on a stale injected plan, naming the
            # offending field (batch / clip mode / calibration /
            # fingerprint).
            costmodel.check_plan_matches(
                plan, batch_sig=costmodel._shape_sig(self._batch_spec),
                fingerprint=self.fingerprint(),
                clip_mode=self.dp.clipping.mode,
                calibration=self._calibration or "")
        self._plan = plan
        if self.dp.clipping.mode != "flat":
            # Refuse an unserved mode now, not at the first step.
            check_served(self.dp, self.plan().metas)
        self.run_seed = run_seed
        # Cross-step clipping state: stale mode's lagged norms (a device
        # tensor: no host sync on the stale path), and the per-layer
        # "auto" budget split tracked from observed norm quantiles.
        self._prev_norms_sq = None
        self._budgets = None
        self._budget_q = None

    # -- planning ------------------------------------------------------------

    def _resolve_calibration_arg(self, calibration):
        """See ``calibration`` in the class docstring."""
        from repro_torch import calibrate
        if calibration == "analytic":
            return None
        if calibration is None:
            calib = calibrate.lookup(self.device)
        elif isinstance(calibration, calibrate.Calibration):
            calibration.validate_for(
                calibrate.hardware_signature(self.device))
            calib = calibration
        elif calibration == "measure":
            calib = calibrate.get_or_measure(
                quick=self.device.type != "cuda", device=self.device)
        else:
            calib = calibrate.load_or_fallback(str(calibration),
                                               device=self.device)
        return None if calib is None else calibrate.register(calib)

    @property
    def calibration(self):
        """The calibration this engine plans under (``None`` = analytic
        fallback constants)."""
        return self._calibration

    def _planner_opts(self) -> dict:
        return dict(self.dp.planner_opts(),
                    calibration=self._calibration or "analytic")

    def fingerprint(self, calibration=None) -> str:
        """The plan fingerprint for this engine's (model, shapes, config,
        calibration); ``calibration=`` re-keys it under other constants
        (``"analytic"``: what identifies the mechanism alone, which a
        checkpoint pins, since a re-plan re-prices without changing what
        a step computes)."""
        opts = self._planner_opts()
        if calibration is not None:
            opts["calibration"] = calibration
        return costmodel.plan_fingerprint(
            self.apply_fn, self._params_spec, self._batch_spec, **opts)

    def plan(self) -> costmodel.ExecPlan:
        """The full-batch ExecPlan (built once; cache hits are free)."""
        if self._plan is None:
            self._plan = costmodel.get_plan(
                self.apply_fn, self._params_spec, self._batch_spec,
                **self._planner_opts())
        return self._plan

    # -- measured-cost feedback (the mispredict loop) ------------------------

    def predicted_step_seconds(self) -> float:
        """Calibrated prediction of one step's wall-clock under the
        current plan — what :meth:`observe_step_time` compares against."""
        return costmodel.predicted_step_seconds(
            self.plan(), self._calibration or "analytic")

    def observe_step_time(self, seconds: float,
                          step: int | None = None) -> ReplanEvent | None:
        """Record one executed step's measured wall-clock.  An EMA of the
        observations is compared against :meth:`predicted_step_seconds`;
        when the relative divergence exceeds ``mispredict_threshold``
        (after ≥ 2 observations, so one build-tainted step can't
        trigger), the calibration is retimed from the observation, the
        plan is rebuilt under the new constants, and the returned
        :class:`ReplanEvent` is appended to :attr:`replan_events` (and
        the attached monitor).  Returns ``None`` when no re-plan fired.
        Inert without a calibration, with ``mispredict_threshold=None``
        or under a fixed strategy."""
        if (self.mispredict_threshold is None or self._calibration is None
                or self.dp.strategy != "auto"):
            return None
        seconds = float(seconds)
        self._step_obs += 1
        self._step_ema = (seconds if self._step_ema is None
                          else 0.5 * self._step_ema + 0.5 * seconds)
        if self._step_obs < 2:
            return None
        predicted = self.predicted_step_seconds()
        ratio = self._step_ema / max(predicted, 1e-12)
        if abs(ratio - 1.0) <= self.mispredict_threshold:
            return None
        return self._replan(step, ratio, predicted, self._step_ema)

    def _replan(self, step, ratio, predicted_s, measured_s) -> ReplanEvent:
        """Retime the calibration from the observed divergence and
        rebuild the plan under the new constants."""
        from repro_torch import calibrate
        old = self._calibration
        old_plan = self.plan()
        new = calibrate.register(old.retimed(predicted_s=predicted_s,
                                             measured_s=measured_s))
        self._calibration = new
        self._plan = None
        self._step_ema = None
        self._step_obs = 0
        new_plan = self.plan()
        event = ReplanEvent(
            step=-1 if step is None else int(step), ratio=float(ratio),
            predicted_s=float(predicted_s), measured_s=float(measured_s),
            old_calibration=old.digest(), new_calibration=new.digest(),
            old_fingerprint=old_plan.fingerprint,
            new_fingerprint=new_plan.fingerprint,
            plan_changed=old_plan.realizations() != new_plan.realizations())
        self.replan_events.append(event)
        if self._monitor is not None:
            self._monitor.record_replan(event.step, event.ratio)
        return event

    def _explain_calibration(self) -> str:
        if self._calibration is None:
            lines = ["calibration: none — planning with the analytic "
                     "fallback constants (costmodel.ANALYTIC_FALLBACK)"]
        else:
            c = self._calibration
            lines = [
                f"calibration: {c.digest()} (source={c.source}, hw="
                f"{c.hardware}) flops/s={c.flops_per_second:.3g} "
                f"hbm={c.hbm_bytes_per_second / 1e9:.1f} GB/s",
                f"predicted step: {self.predicted_step_seconds() * 1e6:.0f}"
                f" us; mispredict threshold: "
                + (f"±{self.mispredict_threshold:g}"
                   if self.mispredict_threshold is not None
                   else "disabled")]
        for ev in self.replan_events:
            lines.append(
                f"re-plan @ step {ev.step}: measured/predicted = "
                f"{ev.ratio:.2f}x ({ev.measured_s * 1e6:.0f} us vs "
                f"{ev.predicted_s * 1e6:.0f} us), calibration "
                f"{ev.old_calibration} -> {ev.new_calibration}, plan "
                + ("changed" if ev.plan_changed else "unchanged")
                + f" ({ev.old_fingerprint} -> {ev.new_fingerprint})")
        return "\n".join(lines)

    def explain(self) -> str:
        """Human-readable per-layer plan table (see ExecPlan.explain)
        under a header with the engine's configuration and the
        calibration block: the active measured constants (or the analytic
        fallback), the predicted step time, the mispredict threshold, and
        every re-plan fired so far."""
        clip = self.dp.clipping
        header = (f"PrivacyEngine: strategy={self.dp.strategy} "
                  f"C={self.dp.l2_clip} sigma={self.dp.noise_multiplier} "
                  f"clipping={clip.mode}"
                  + (f"(budgets={clip.budgets})"
                     if clip.mode == "per_layer" else "")
                  + f" microbatches={self.microbatches()}"
                  + ("" if self.dp.microbatches != "auto" else " (auto)")
                  + f" device={self.device}")
        cal = self._explain_calibration()
        if self.dp.strategy != "auto":
            return (header + f"\nfixed strategy {self.dp.strategy!r}: the "
                    "planner is bypassed; plan below is advisory.\n"
                    + cal + "\n" + self.plan().explain())
        return header + "\n" + cal + "\n" + self.plan().explain()

    def save_plan(self, path: str):
        """Persist every plan this engine executes with (the full-batch
        plan and, when microbatching splits the step, the per-microbatch
        plan too), so a process that loads the store never probes."""
        plans = [self.plan()]
        exec_plan = self._exec_plan()
        if exec_plan is not None \
                and exec_plan.fingerprint != plans[0].fingerprint:
            plans.append(exec_plan)
        costmodel.save_plan_store(path, plans)

    def microbatches(self) -> int:
        """The resolved microbatch count (plan-driven for ``"auto"``)."""
        plan = self._plan
        if self.dp.microbatches == "auto" and self.dp.strategy == "auto":
            plan = self.plan()
        return resolve_microbatches(self.apply_fn, self._params_spec,
                                    self._batch_spec, self.dp, plan=plan)

    def _exec_plan(self) -> costmodel.ExecPlan | None:
        """The plan matching the shapes the step actually executes: the
        full-batch plan, or a per-microbatch-shape plan when splitting."""
        if self.dp.strategy != "auto":
            return None
        m = self.microbatches()
        if m == 1:
            return self.plan()
        mb_spec = {k: TensorSpec((s.shape[0] // m,) + tuple(s.shape[1:]),
                                 s.dtype)
                   for k, s in self._batch_spec.items()}
        return costmodel.get_plan(self.apply_fn, self._params_spec, mb_spec,
                                  **self._planner_opts())

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
        """(mean loss, noised clipped mean gradient, aux).  Cross-step
        clipping state (stale norms, auto budgets) is threaded exactly as
        in ``private_step``."""
        cfg = dataclasses.replace(self.dp, microbatches=self.microbatches())
        out = dp_gradient(self.apply_fn, params, batch, cfg=cfg,
                          key=self._check_key(key, step), denom=denom,
                          plan=self._exec_plan(),
                          clip_state=self._clip_state())
        self._absorb_clip_aux(out[2])
        return out

    # -- cross-step clipping state -------------------------------------------

    def clip_state_dict(self) -> dict:
        """Host-side snapshot of the cross-step clipping state — the stale
        lagged norms and the per-layer auto-budget split + tracked
        quantiles.  It belongs in every checkpoint: a stale-mode restart
        without ``prev_norms_sq`` would re-run the flat bootstrap, and an
        auto-budget restart without ``budget_q`` would re-split the budget
        from scratch — both change what the accounted mechanism
        released."""
        out = {}
        if self._prev_norms_sq is not None:
            out["prev_norms_sq"] = self._prev_norms_sq.cpu().numpy()
        if self._budgets is not None:
            out["budgets"] = self._budgets.cpu().numpy()
        if self._budget_q is not None:
            out["budget_q"] = np.asarray(self._budget_q)
        return out

    def load_clip_state(self, state: dict | None):
        """Install a :meth:`clip_state_dict` (missing keys reset to empty —
        a flat-mode checkpoint carries none)."""
        state = dict(state or {})

        def dev(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, np.float32), device=self.device)

        self._prev_norms_sq = dev(state.get("prev_norms_sq"))
        self._budgets = dev(state.get("budgets"))
        q = state.get("budget_q")
        self._budget_q = None if q is None else np.asarray(q, np.float64)

    def reset_clip_state(self):
        """Drop all cross-step clipping state (a from-scratch restart:
        stale mode re-bootstraps, auto budgets re-track)."""
        self.load_clip_state(None)

    def _group_keys(self) -> tuple:
        return tuple("/".join(str(p) for p in g.path)
                     for g in self.plan().groups)

    def _clip_state(self) -> dict:
        """The clip_state dict for the next step."""
        clip = self.dp.clipping
        if clip.mode == "stale" and self._prev_norms_sq is not None:
            return {"prev_norms_sq": self._prev_norms_sq}
        if clip.mode == "per_layer" and clip.budgets == "auto":
            if self._budgets is None:
                self._budgets = resolve_budgets(
                    clip, self.dp.l2_clip, self._group_keys(),
                    observed=self._budget_q, device=self.device)
            # The auto split must keep the clipped sum's sensitivity at C
            # (Σ C_l² = C²) or the σC noise calibration breaks.
            sens = clipping_sensitivity(self._budgets.cpu().numpy())
            if abs(sens - self.dp.l2_clip) > 1e-3 * self.dp.l2_clip:
                raise AssertionError(
                    f"auto budget split broke the sensitivity invariant: "
                    f"sqrt(sum C_l^2) = {sens} != C = {self.dp.l2_clip}")
            return {"budgets": self._budgets}
        return {}

    def _absorb_clip_aux(self, aux: dict):
        """Bookkeeping after a step: thread stale norms (on the device),
        update the per-layer norm quantile EMA driving ``budgets="auto"``
        (on the host)."""
        clip = self.dp.clipping
        if clip.mode == "stale":
            self._prev_norms_sq = aux["clip_state"]["prev_norms_sq"]
        elif clip.mode == "per_layer" and clip.budgets == "auto":
            q = np.quantile(aux["per_layer_norms"].cpu().numpy()
                            .astype(np.float64), clip.quantile, axis=1)
            q = np.maximum(q, 1e-12)
            if self._budget_q is None:
                self._budget_q = q
            else:
                self._budget_q = clip.ema * self._budget_q \
                    + (1.0 - clip.ema) * q
            self._budgets = resolve_budgets(
                clip, self.dp.l2_clip, self._group_keys(),
                observed=self._budget_q, device=self.device)

    def private_step(self, params, opt, batch, key=None, *,
                     step: int | None = None):
        """One DP-SGD step: gradient + clip + noise + optimizer update, and
        one step on the accountant.  Returns (params, opt, loss, aux).

        Non-flat clipping modes thread state across steps: ``stale``
        feeds this step's norms to the next step's coefficients (the
        first step bootstraps with exact flat clipping); ``per_layer``
        with ``budgets="auto"`` re-splits the budget from the tracked
        per-layer norm quantiles after every step."""
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
