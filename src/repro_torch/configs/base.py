"""Model / shape / run configuration schema."""
from __future__ import annotations

import dataclasses

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # attention
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 5e5
    qk_norm: bool = False
    attn_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np
    mlp: str = "swiglu"            # swiglu | gelu
    attn_impl: str = "auto"        # auto | xla | chunked | flash
    dp_attn: bool = False          # block-level "attn" DP tap (kinds.py)
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    capacity_factor: float = 2.0
    moe_impl: str = "einsum"       # einsum | gather
    # mla (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    mla_absorbed_decode: bool = False
    # ssm / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0            # zamba: shared attn block every k ssm layers
    slstm_every: int = 0           # xlstm: one sLSTM per k-block (else mLSTM)
    window: int = 0                # sliding-window attention (long-context)
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    frontend: str = "none"         # "frames": inputs are embeddings (stub)
    # cnn (paper models)
    cnn_arch: str = ""             # alexnet | vgg16 | toy
    cnn_channels: tuple = ()
    cnn_kernel: int = 3
    img_size: int = 224
    n_classes: int = 1000
    # serving
    prefill_last_only: bool = False   # head matmul on last position only
    # numerics / distribution hints
    dtype: str = "float32"
    remat: bool = False
    fsdp: bool = False
    vocab_pad_to: int = 128
    dp_strategy: str = "ghost"
    moe_lb_coef: float = 0.01
    # long-context applicability: full-attention archs skip long_500k
    subquadratic: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, self.vocab_pad_to)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 * max(1, self.attn_every or 0) or 2),
            d_model=64, n_heads=4, n_kv=min(self.n_kv, 2) or 2,
            d_ff=96 if self.n_experts else 128,
            vocab=512, head_dim=16, dtype="float32", remat=False, fsdp=False)
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 4
        if self.slstm_every:
            kw["slstm_every"] = 2
            kw["n_layers"] = 4
        if self.n_experts:
            kw["n_experts"] = 4
            kw["topk"] = 2
        if self.mla:
            kw.update(q_lora_rank=32, kv_lora_rank=32, qk_rope_dim=8,
                      qk_nope_dim=16, v_head_dim=16)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2, n_dec_layers=2, n_layers=4)
        if self.ssm_state:
            kw["ssm_state"] = 16
        if self.family == "cnn":
            kw = dict(cnn_arch="toy", cnn_channels=(8, 16), cnn_kernel=3,
                      img_size=32, n_classes=10)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
