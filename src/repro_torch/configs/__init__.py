"""The paper's own CNN configs (AlexNet, VGG16) and the JAX package's ten
language models: the dense Llama-3.2-1B, OLMo-1B, GLM-4-9B and
StableLM-2-12B, Chameleon-34B (family ``vlm``, an early-fusion backbone
over token ids), the MoE Granite-3.0-1B-A400M and DeepSeek-V3-671B (MLA +
MoE), the enc-dec SeamlessM4T-large-v2 backbone, the SSM xLSTM-125M and
the hybrid Zamba2-2.7B (Mamba2 + a shared attention block).
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
SERVED_LM = {"llama3.2-1b": "llama32_1b", "olmo-1b": "olmo_1b",
             "glm4-9b": "glm4_9b", "stablelm-12b": "stablelm_12b",
             "chameleon-34b": "chameleon_34b",
             "granite-moe-1b-a400m": "granite_moe_1b_a400m",
             "deepseek-v3-671b": "deepseek_v3_671b",
             "seamless-m4t-large-v2": "seamless_m4t_large_v2",
             "xlstm-125m": "xlstm_125m", "zamba2-2.7b": "zamba2_2p7b"}


def get_config(arch: str) -> ModelConfig:
    import importlib
    if arch in SERVED_LM:
        return importlib.import_module(
            f"repro_torch.configs.{SERVED_LM[arch]}").CONFIG
    if arch not in PAPER_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{PAPER_IDS + sorted(SERVED_LM)}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


__all__ = ["ARCH_IDS", "PAPER_IDS", "SERVED_LM", "SHAPES", "ModelConfig",
           "ShapeSpec", "get_config"]
