"""Model registry: config -> model object (the paper's CNNs, and the
``dense`` LM family; the other LM families come with ROADMAP.md item
11)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.family == "cnn":
        from repro_torch.models.cnn import CNN
        return CNN(cfg)
    if cfg.family == "dense":
        from repro_torch.models.lm import TransformerLM
        return TransformerLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} comes with the rest of the LM slice "
        f"(ROADMAP.md item 11); the port serves families 'cnn' and 'dense'")
