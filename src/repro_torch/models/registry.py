"""Model registry: config -> model object (the paper's CNNs, and the
``dense`` and ``vlm`` LM families; MoE, SSM, hybrid and enc-dec come with
ROADMAP.md item 12)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.family == "cnn":
        from repro_torch.models.cnn import CNN
        return CNN(cfg)
    if cfg.family in ("dense", "vlm"):
        from repro_torch.models.lm import TransformerLM
        return TransformerLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} comes with ROADMAP.md item 12; the "
        f"port serves families 'cnn', 'dense' and 'vlm'")
