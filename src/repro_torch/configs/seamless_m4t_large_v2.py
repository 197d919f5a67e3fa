"""SeamlessM4T-large-v2 backbone [arXiv:2308.11596; hf] — enc-dec.

24L read as 12 encoder + 12 decoder; the speech frontend is a stub
(the batch carries precomputed frame embeddings), as in the JAX
package.  Vocab 256206 padded to 256256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    n_enc_layers=12, n_dec_layers=12, d_model=1024, n_heads=16, n_kv=16,
    d_ff=8192, vocab=256206, head_dim=64, norm="layernorm", mlp="gelu",
    rope_theta=1e4, frontend="frames", dtype="bfloat16", remat=True,
    dp_strategy="bk", prefill_last_only=True)
