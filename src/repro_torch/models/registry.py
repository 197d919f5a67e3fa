"""Model registry: config -> model object (the paper's CNNs in this
slice; the LM families come with ROADMAP.md item 11)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.family == "cnn":
        from repro_torch.models.cnn import CNN
        return CNN(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} comes with the LM slice (ROADMAP.md "
        f"item 11); the port serves family 'cnn'")
