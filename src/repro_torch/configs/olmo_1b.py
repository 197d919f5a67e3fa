"""OLMo-1B [arXiv:2402.00838; hf] — dense, non-parametric LayerNorm, tied."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv=16, d_ff=8192, vocab=50304, head_dim=128, norm="layernorm_np",
    mlp="swiglu", tie_embeddings=True, rope_theta=1e4, dtype="bfloat16",
    remat=False, dp_strategy="bk", prefill_last_only=True)
