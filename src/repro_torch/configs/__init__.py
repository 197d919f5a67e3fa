"""The paper's own CNN configs (AlexNet, VGG16) and the first language
model of the port, Llama-3.2-1B.

The JAX package's other language-model configs come with the rest of
the LM slice (ROADMAP.md, "Modules to port" item 11); asking for one
here raises ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

ARCH_IDS = [
    "olmo-1b", "stablelm-12b", "glm4-9b", "llama3.2-1b", "xlstm-125m",
    "seamless-m4t-large-v2", "zamba2-2.7b", "chameleon-34b",
    "granite-moe-1b-a400m", "deepseek-v3-671b",
]
PAPER_IDS = ["alexnet", "vgg16"]
# The LM ids the port serves, and the module of each.
SERVED_LM = {"llama3.2-1b": "llama32_1b"}


def get_config(arch: str) -> ModelConfig:
    import importlib
    if arch in SERVED_LM:
        return importlib.import_module(
            f"repro_torch.configs.{SERVED_LM[arch]}").CONFIG
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"{arch!r} is a language model the port does not serve yet; "
            f"it serves {PAPER_IDS + sorted(SERVED_LM)} until the rest of "
            f"the LM slice (ROADMAP.md item 11)")
    if arch not in PAPER_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{PAPER_IDS + sorted(SERVED_LM)}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


__all__ = ["ARCH_IDS", "PAPER_IDS", "SERVED_LM", "SHAPES", "ModelConfig",
           "ShapeSpec", "get_config"]
