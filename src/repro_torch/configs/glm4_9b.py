"""GLM-4-9B [hf:THUDM/glm-4-9b; hf] — dense, GQA kv=2, RoPE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096, n_heads=32,
    n_kv=2, d_ff=13696, vocab=151552, head_dim=128, norm="rmsnorm",
    mlp="swiglu", rope_theta=1e4, dtype="bfloat16", remat=True, fsdp=True,
    dp_strategy="bk", prefill_last_only=True)
