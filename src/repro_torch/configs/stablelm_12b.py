"""StableLM-2-12B [hf:stabilityai; hf] — dense GQA kv=8, FSDP at 12B."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv=8, d_ff=13824, vocab=100352, head_dim=160,
    norm="layernorm", mlp="swiglu", rope_theta=1e4, dtype="bfloat16",
    remat=True, fsdp=True, dp_strategy="bk", prefill_last_only=True)
