"""Model configuration (counterpart of ``specdec_tpu/core/config.py``).

Same fields and defaults as the JAX ``ModelConfig``; ``dtype`` is a
``torch.dtype``. Unknown values of the string options raise at
construction.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    # () | ("linear", factor) | ("llama3", factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings); see core/rope.py
    rope_scaling: tuple = ()
    # fraction of head_dim that is rotated (gpt-neox ``rotary_pct``)
    rotary_pct: float = 1.0
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    act: str = "silu"  # "silu" | "gelu" | "gelu_tanh"
    gated_mlp: bool = True
    parallel_residual: bool = False  # gpt-neox: x + attn(ln1 x) + mlp(ln2 x)
    attn_qkv_bias: bool = False  # qwen2, gpt-neox
    attn_out_bias: bool = False  # gpt-neox
    mlp_bias: bool = False  # gpt-neox
    qk_norm: bool = False  # qwen3: per-head RMSNorm on q and k
    tie_embeddings: bool = False
    # multiplier on the embedding output only (gemma: sqrt(hidden_size))
    embed_scale: float = 1.0
    dtype: torch.dtype = torch.float32
    # logit soft-capping (gemma2-style); 0 disables
    logit_softcap: float = 0.0
    # slotted-cache attention: "xla" is the plain PyTorch attention, "flash"
    # the flash-decode kernel (ops/decode_attention.py) unless the model
    # soft-caps its logits or has a head_dim the kernel does not take
    # (core/model.py::kernel_route); the paged forward takes its own kernel
    # under the same rule
    attention_impl: str = "xla"
    # "none" | "int8": int8 K/V with a per-(position, head) f32 scale
    # (QuantKVCache, QuantPagedKVCache), in every cache the model allocates
    kv_quant: str = "none"

    def __post_init__(self):
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {self.kv_quant!r}")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def rotary_dim(self) -> int:
        d = int(self.head_dim * self.rotary_pct)
        return d - (d % 2)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(vocab_size: int = 256, **kw) -> ModelConfig:
    """A minimal config for unit tests."""
    base = dict(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_position_embeddings=512,
    )
    base.update(kw)
    return ModelConfig(**base)
