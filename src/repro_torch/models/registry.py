"""Model registry: config -> model object (the paper's CNNs, the
``dense``, ``moe`` and ``vlm`` LM families and the ``encdec`` backbone;
SSM and hybrid come with ROADMAP.md item 12, part 2)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.family == "cnn":
        from repro_torch.models.cnn import CNN
        return CNN(cfg)
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.lm import TransformerLM
        return TransformerLM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} comes with ROADMAP.md item 12, part "
        f"2; the port serves families 'cnn', 'dense', 'moe', 'vlm' and "
        f"'encdec'")
