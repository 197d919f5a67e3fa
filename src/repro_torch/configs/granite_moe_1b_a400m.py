"""Granite-3.0-1B-A400M [hf:ibm-granite; hf] — MoE 32 experts top-8.

d_ff=512 is the per-expert hidden size.  Vocab 49155 padded to 49280.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv=8, d_ff=512, vocab=49155, head_dim=64, norm="rmsnorm",
    mlp="swiglu", n_experts=32, topk=8, capacity_factor=2.0,
    rope_theta=1e4, dtype="bfloat16", moe_impl="gather", dp_strategy="ghost",
    prefill_last_only=True)
