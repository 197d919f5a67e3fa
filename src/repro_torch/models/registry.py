"""Model registry: config -> model object (the paper's CNNs, the
decoder-only LM families ``dense``, ``moe``, ``vlm``, ``ssm`` and
``hybrid``, and the ``encdec`` backbone)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.family == "cnn":
        from repro_torch.models.cnn import CNN
        return CNN(cfg)
    if cfg.family in ("dense", "moe", "vlm", "ssm", "hybrid"):
        from repro_torch.models.lm import TransformerLM
        return TransformerLM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")
