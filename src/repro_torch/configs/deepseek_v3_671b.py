"""DeepSeek-V3-671B [arXiv:2412.19437; hf] — MLA + 256-expert MoE top-8.

MLA: q_lora 1536, kv_lora 512, rope 64, nope 128, v 128 over 128 heads.
1 shared + 256 routed experts (top-8), per-expert hidden 2048.  The
JAX package's config, field for field: MLA + MoE blocks (family
``moe``).  One card holds one full-width layer of it, not the model:
its DP step needs the experts sharded over a model axis (the ``expert``
rule, which ``models/moe.py`` executes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv=128, d_ff=2048, vocab=129280, norm="rmsnorm",
    mlp="swiglu", n_experts=256, n_shared_experts=1, topk=8,
    capacity_factor=2.0, mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128, rope_theta=1e4,
    dtype="bfloat16", remat=True, fsdp=True, moe_impl="gather",
    dp_strategy="ghost", prefill_last_only=True)
