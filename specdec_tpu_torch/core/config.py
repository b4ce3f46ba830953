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

    # latent attention and experts: none here (``LatentMoEConfig``)
    kv_lora_rank = 0
    n_routed_experts = 0

    @property
    def rotary_dim(self) -> int:
        d = int(self.head_dim * self.rotary_pct)
        return d - (d % 2)

    @property
    def cache_dims(self) -> tuple:
        """(KV heads, K width, V width) a cached position holds."""
        return self.num_kv_heads, self.head_dim, self.head_dim

    def is_moe_layer(self, i: int) -> bool:
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LatentMoEConfig(ModelConfig):
    """deepseek_v2's architecture (``core/mla.py``, ``core/moe.py``): a
    ``ModelConfig`` with multi-head latent attention and DeepSeekMoE. The
    JAX package has neither, so they extend the port's ``ModelConfig``
    rather than change its fields.

    Latent attention: q is qk_nope + qk_rope wide a head (``head_dim``),
    v is v_head_dim wide, and the cache holds a position's normed latent
    (kv_lora_rank) and the rotated rope key every head shares (qk_rope):
    one stream and no V. The scores' scale is ``attn_scale``; rope
    rotates interleaved pairs.

    Experts: layers from first_k_dense_replace on route each token over a
    softmax of the routed experts to its num_experts_per_tok best,
    weighted by their probabilities times routed_scaling_factor, beside
    n_shared_experts shared
    experts fused as one SwiGLU; every expert is moe_intermediate_size
    wide."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    attn_scale: float = 0.0
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0

    @property
    def rotary_dim(self) -> int:
        return self.qk_rope_head_dim

    @property
    def cache_dims(self) -> tuple:
        return 1, self.kv_lora_rank + self.qk_rope_head_dim, 0

    def is_moe_layer(self, i: int) -> bool:
        return self.n_routed_experts > 0 and i >= self.first_k_dense_replace


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
