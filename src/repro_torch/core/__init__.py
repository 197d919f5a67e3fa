"""Per-example gradient computation (naive / multi / crb of Rochette et al.
2019, plus the ghost & book-keeping extensions) and the DP-SGD machinery
built on it.  :class:`PrivacyEngine` is the public entry point."""
from repro_torch.core.clipping import (ClipPolicy, DPConfig, NormCfg,
                                       add_noise, dp_gradient,
                                       resolve_budgets, resolve_microbatches)
from repro_torch.core.costmodel import (ExecPlan, check_plan_matches,
                                        code_fingerprint, get_plan,
                                        plan_fingerprint)
from repro_torch.core.engine import KeyProvenanceError, PrivacyEngine
from repro_torch.core.privacy import (LedgerMismatch, PrivacyAccountant,
                                      clipping_sensitivity,
                                      rdp_subsampled_gaussian)
from repro_torch.core.strategies import (STRATEGIES, check_coverage,
                                         clip_coefficients, clipped_grad_sum,
                                         clipped_grad_sum_detailed,
                                         crb_per_example_grads,
                                         multi_per_example_grads,
                                         naive_per_example_grads,
                                         per_layer_clip_coefficients,
                                         planned_clipped_sum)
from repro_torch.core.tapper import (STATS, LayerMeta, Tapper,
                                     capture_backward, probe)

__all__ = [
    "ClipPolicy", "DPConfig", "NormCfg", "KeyProvenanceError",
    "PrivacyEngine", "add_noise", "dp_gradient", "resolve_budgets",
    "resolve_microbatches", "ExecPlan", "check_plan_matches",
    "code_fingerprint", "get_plan", "plan_fingerprint", "LedgerMismatch",
    "PrivacyAccountant", "clipping_sensitivity", "rdp_subsampled_gaussian",
    "STRATEGIES", "check_coverage", "clip_coefficients", "clipped_grad_sum",
    "clipped_grad_sum_detailed", "crb_per_example_grads",
    "multi_per_example_grads", "naive_per_example_grads",
    "per_layer_clip_coefficients", "planned_clipped_sum", "STATS",
    "LayerMeta", "Tapper", "capture_backward", "probe",
]
