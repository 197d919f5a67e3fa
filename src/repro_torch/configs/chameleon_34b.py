"""Chameleon-34B [arXiv:2405.09818; unverified] — early-fusion VLM.

VQ image tokens share the 65536 vocab, so backbone inputs are token ids;
the VQ tokenizer frontend is a stub per the assignment.  QK-norm on.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv=8, d_ff=22016, vocab=65536, head_dim=128,
    norm="layernorm", mlp="swiglu", qk_norm=True, rope_theta=1e4,
    dtype="bfloat16", remat=True, fsdp=True, dp_strategy="bk",
    prefill_last_only=True)
