"""The paper's own CNN configs (AlexNet, VGG16).

The language-model configs of the JAX package come with the port's LM
slice (ROADMAP.md, "Modules to port" item 11); asking for one here
raises ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

ARCH_IDS = [
    "olmo-1b", "stablelm-12b", "glm4-9b", "llama3.2-1b", "xlstm-125m",
    "seamless-m4t-large-v2", "zamba2-2.7b", "chameleon-34b",
    "granite-moe-1b-a400m", "deepseek-v3-671b",
]
PAPER_IDS = ["alexnet", "vgg16"]


def get_config(arch: str) -> ModelConfig:
    import importlib
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"{arch!r} is a language model; the port serves only the "
            f"paper's CNNs {PAPER_IDS} until the LM slice (ROADMAP.md "
            f"item 11)")
    if arch not in PAPER_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {PAPER_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


__all__ = ["ARCH_IDS", "PAPER_IDS", "SHAPES", "ModelConfig", "ShapeSpec",
           "get_config"]
