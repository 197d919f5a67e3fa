"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 + weight-shared attn block.

54 Mamba2 layers in 9 super-blocks of 6, one *shared* full attention+MLP
block applied after each super-block (Zamba's parameter-sharing trick; the
per-depth LoRA of Zamba2 is omitted, as in the JAX package).
Sliding-window attention (window=4096) keeps it sub-quadratic for
long_500k decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv=32, d_ff=10240, vocab=32000, head_dim=80,
    norm="rmsnorm", mlp="swiglu", ssm_state=64, ssm_expand=2, ssm_conv=4,
    attn_every=6, window=4096, rope_theta=1e4, dtype="bfloat16", remat=True,
    subquadratic=True, dp_strategy="bk", prefill_last_only=True)
