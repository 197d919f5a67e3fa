"""xLSTM-125M [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

d_ff=0 per the assignment: blocks carry their own projection factor.
slstm_every=4: one sLSTM block per 4 (3 mLSTM + 1 sLSTM), 12 layers total.
Sub-quadratic (recurrent state) -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv=4, d_ff=0, vocab=50304, norm="rmsnorm", slstm_every=4,
    ssm_expand=2, ssm_conv=4, dtype="bfloat16", subquadratic=True,
    dp_strategy="bk", prefill_last_only=True)
