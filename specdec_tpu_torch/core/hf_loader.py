"""HuggingFace checkpoint -> the port's params (counterpart of
``specdec_tpu/core/hf_loader.py``).

``config_from_hf`` reads a parsed ``config.json``: a dict, or any object
with the same attributes (a ``transformers`` config), so the streamed
safetensors path (``core/stream_loader.py``) needs no ``transformers``.
A key that ``config.json`` may leave out takes the default of the
family's ``transformers`` config class, as ``AutoConfig`` would fill it.

Supported families: llama/mistral/tinyllama, qwen2 (qkv bias), qwen3
(qk-norm), gemma (explicit head_dim, sqrt(hidden) embedding scale, (1+w)
norms folded into the weights, tanh-GeGLU, tied head), gpt-neox
(pythia) and deepseek_v2 (latent attention, experts, YaRN; its layers are
a list of per-layer dicts, layer 0 dense and the rest expert layers).
``load_hf_model`` (every family, the whole state dict at once) imports
``transformers`` when called; the llama lineage streams through
``core/stream_loader.py`` instead.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.config import LatentMoEConfig, ModelConfig
from specdec_tpu_torch.core.rope import yarn_attention_factor, yarn_mscale

Params = Dict[str, Any]

# defaults of the keys a family's config.json may omit: those of its
# transformers config class
_FAMILY_DEFAULTS = {
    "llama": dict(rms_norm_eps=1e-6, rope_theta=10000.0,
                  max_position_embeddings=2048, tie_word_embeddings=False),
    "mistral": dict(rms_norm_eps=1e-6, rope_theta=10000.0,
                    max_position_embeddings=4096 * 32,
                    tie_word_embeddings=False),
    "qwen2": dict(rms_norm_eps=1e-6, rope_theta=10000.0,
                  max_position_embeddings=32768, tie_word_embeddings=False),
    "qwen3": dict(rms_norm_eps=1e-6, rope_theta=10000.0,
                  max_position_embeddings=32768, tie_word_embeddings=False,
                  head_dim=128),
    "gemma": dict(rms_norm_eps=1e-6, rope_theta=10000.0,
                  max_position_embeddings=8192, tie_word_embeddings=True,
                  head_dim=256, hidden_act="gelu_pytorch_tanh"),
    # the JAX loader's fallbacks where transformers' config lacks the key
    "gpt_neox": dict(layer_norm_eps=1e-5, rotary_emb_base=10000.0,
                     rotary_pct=1.0, use_parallel_residual=True,
                     attention_bias=True, tie_word_embeddings=False,
                     max_position_embeddings=2048),
    "deepseek_v2": dict(rms_norm_eps=1e-6, rope_theta=10000.0,
                        max_position_embeddings=2048,
                        tie_word_embeddings=False, first_k_dense_replace=0,
                        routed_scaling_factor=1.0),
}


def _get(hf_cfg, key: str, default=None):
    """``hf_cfg[key]`` for a dict, ``hf_cfg.key`` otherwise; ``default``
    where it is absent."""
    if isinstance(hf_cfg, dict):
        return hf_cfg.get(key, default)
    return getattr(hf_cfg, key, default)


def _model_type(hf_cfg) -> str:
    return _get(hf_cfg, "model_type", "llama")


def _cfg_value(hf_cfg, key: str, default=None):
    """A config value, else the family default, else ``default``."""
    v = _get(hf_cfg, key)
    if v is None:
        v = _FAMILY_DEFAULTS.get(_model_type(hf_cfg), {}).get(key, default)
    return v


def _rope_scaling_from_hf(hf_cfg, yarn: bool = False) -> tuple:
    """HF ``rope_scaling`` -> the hashable ModelConfig tuple: llama3,
    linear, default/none, and with ``yarn`` (deepseek_v2, whose YaRN the
    tests hold to transformers') YaRN; any other type (dynamic, longrope,
    YaRN elsewhere) raises rather than rotating with the wrong
    frequencies."""
    rs = _get(hf_cfg, "rope_scaling")
    if not rs:
        return ()
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind in ("default", None):
        return ()
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]), float(rs["low_freq_factor"]),
                float(rs["high_freq_factor"]),
                float(rs["original_max_position_embeddings"]))
    if kind == "yarn" and yarn:
        factor = float(rs["factor"])
        af = rs.get("attention_factor")
        if af is None:
            af = yarn_attention_factor(factor, rs.get("mscale") or 0.0,
                                       rs.get("mscale_all_dim") or 0.0)
        return ("yarn", factor, float(
            rs.get("original_max_position_embeddings")
            or _get(hf_cfg, "max_position_embeddings")),
            float(rs.get("beta_fast") or 32), float(rs.get("beta_slow") or 1),
            float(af))
    raise ValueError(f"unsupported rope_scaling type: {kind!r}")


def _deepseek_v2(hf_cfg, common: dict) -> ModelConfig:
    """deepseek_v2: multi-head latent attention without a q low-rank
    (``q_lora_rank`` null), interleaved YaRN rope, DeepSeekMoE with greedy
    softmax routing after ``first_k_dense_replace`` dense layers. Keys of
    variants the port does not implement raise, naming the key. The
    softmax scale carries YaRN's mscale(factor, mscale_all_dim) squared,
    as DeepSeek's own code (and transformers' deepseek_v3) applies it."""
    def want(key, ok, value):
        if not ok(value):
            raise ValueError(f"deepseek_v2: {key}={value!r} is not "
                             "implemented")
    want("q_lora_rank", lambda v: v is None, _get(hf_cfg, "q_lora_rank"))
    want("topk_method", lambda v: v in (None, "greedy"),
         _get(hf_cfg, "topk_method"))
    want("n_group", lambda v: v is None or v <= 1, _get(hf_cfg, "n_group"))
    want("scoring_func", lambda v: v in (None, "softmax"),
         _get(hf_cfg, "scoring_func"))
    want("moe_layer_freq", lambda v: v in (None, 1),
         _get(hf_cfg, "moe_layer_freq"))
    want("attention_bias", lambda v: not v, _get(hf_cfg, "attention_bias"))
    want("norm_topk_prob", lambda v: not v, _get(hf_cfg, "norm_topk_prob"))
    nope = _get(hf_cfg, "qk_nope_head_dim")
    rope = _get(hf_cfg, "qk_rope_head_dim")
    scaling = _rope_scaling_from_hf(hf_cfg, yarn=True)
    scale = (nope + rope) ** -0.5
    rs = _get(hf_cfg, "rope_scaling") or {}
    if scaling and scaling[0] == "yarn" and rs.get("mscale_all_dim"):
        m = yarn_mscale(scaling[1], rs["mscale_all_dim"])
        scale = scale * m * m
    H = common["num_heads"]
    return LatentMoEConfig(
        **common, num_kv_heads=H, head_dim=nope + rope,
        rope_theta=_cfg_value(hf_cfg, "rope_theta"), rope_scaling=scaling,
        norm_eps=_cfg_value(hf_cfg, "rms_norm_eps"), norm_type="rmsnorm",
        act="silu", gated_mlp=True,
        tie_embeddings=bool(_cfg_value(hf_cfg, "tie_word_embeddings")),
        kv_lora_rank=_get(hf_cfg, "kv_lora_rank"), qk_nope_head_dim=nope,
        qk_rope_head_dim=rope, v_head_dim=_get(hf_cfg, "v_head_dim"),
        attn_scale=float(scale),
        n_routed_experts=_get(hf_cfg, "n_routed_experts") or 0,
        n_shared_experts=_get(hf_cfg, "n_shared_experts") or 0,
        num_experts_per_tok=_get(hf_cfg, "num_experts_per_tok") or 0,
        moe_intermediate_size=_get(hf_cfg, "moe_intermediate_size"),
        first_k_dense_replace=_cfg_value(hf_cfg, "first_k_dense_replace"),
        routed_scaling_factor=float(_cfg_value(hf_cfg,
                                               "routed_scaling_factor")))


def config_from_hf(hf_cfg, dtype=torch.float32) -> ModelConfig:
    """The ModelConfig of a parsed HF config (dict or attributes)."""
    mt = _model_type(hf_cfg)
    H = _get(hf_cfg, "num_attention_heads")
    D = _get(hf_cfg, "hidden_size")
    common = dict(
        vocab_size=_get(hf_cfg, "vocab_size"), hidden_size=D,
        intermediate_size=_get(hf_cfg, "intermediate_size"),
        num_layers=_get(hf_cfg, "num_hidden_layers"), num_heads=H,
        max_position_embeddings=_cfg_value(hf_cfg, "max_position_embeddings"),
        dtype=dtype)
    if mt in ("llama", "mistral", "qwen2", "qwen3"):
        return ModelConfig(
            **common,
            num_kv_heads=_get(hf_cfg, "num_key_value_heads") or H,
            head_dim=_cfg_value(hf_cfg, "head_dim") or D // H,
            rope_theta=_cfg_value(hf_cfg, "rope_theta"),
            rope_scaling=_rope_scaling_from_hf(hf_cfg),
            norm_eps=_cfg_value(hf_cfg, "rms_norm_eps"),
            norm_type="rmsnorm", act="silu", gated_mlp=True,
            attn_qkv_bias=(mt == "qwen2"), qk_norm=(mt == "qwen3"),
            tie_embeddings=bool(_cfg_value(hf_cfg, "tie_word_embeddings")))
    if mt == "gemma":
        # gemma2 (post-norms, attention softcap, sliding window) is not
        # supported
        act = (_get(hf_cfg, "hidden_activation")
               or _cfg_value(hf_cfg, "hidden_act"))
        return ModelConfig(
            **common,
            num_kv_heads=_get(hf_cfg, "num_key_value_heads") or H,
            head_dim=_cfg_value(hf_cfg, "head_dim"),
            rope_theta=_cfg_value(hf_cfg, "rope_theta"),
            rope_scaling=_rope_scaling_from_hf(hf_cfg),
            norm_eps=_cfg_value(hf_cfg, "rms_norm_eps"),
            norm_type="rmsnorm",
            act="gelu_tanh" if act == "gelu_pytorch_tanh" else act,
            gated_mlp=True,
            tie_embeddings=bool(_cfg_value(hf_cfg, "tie_word_embeddings")),
            embed_scale=float(D) ** 0.5)
    if mt == "gpt_neox":
        bias = _cfg_value(hf_cfg, "attention_bias")
        return ModelConfig(
            **common, num_kv_heads=H, head_dim=D // H,
            rope_theta=_cfg_value(hf_cfg, "rotary_emb_base"),
            rotary_pct=_cfg_value(hf_cfg, "rotary_pct"),
            norm_eps=_cfg_value(hf_cfg, "layer_norm_eps"),
            norm_type="layernorm", act="gelu", gated_mlp=False,
            parallel_residual=_cfg_value(hf_cfg, "use_parallel_residual"),
            attn_qkv_bias=bias, attn_out_bias=bias, mlp_bias=True,
            tie_embeddings=bool(_cfg_value(hf_cfg, "tie_word_embeddings")))
    if mt == "deepseek_v2":
        return _deepseek_v2(hf_cfg, common)
    raise ValueError(f"unsupported model_type: {mt}")


def _np(t) -> np.ndarray:
    """A state-dict value as a float32 numpy array."""
    if isinstance(t, np.ndarray):
        return t
    return t.detach().to("cpu").float().numpy()


def _stack(sd: Dict[str, np.ndarray], pattern: str, L: int,
           transpose: bool = False) -> np.ndarray:
    out = np.stack([sd[pattern.format(i)] for i in range(L)], axis=0)
    return np.swapaxes(out, -1, -2) if transpose else out


def _cast(a: np.ndarray, cfg: ModelConfig, device) -> torch.Tensor:
    """f32 numpy -> a tensor of ``cfg.dtype`` on ``device`` (round to
    nearest even, as ``jnp.asarray(a, dtype)``)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        cfg.dtype).to(device)


def params_from_hf(hf_model, cfg: ModelConfig, device=None) -> Params:
    """An HF torch model's state dict -> the port's params on ``device``."""
    sd = {k: _np(v) for k, v in hf_model.state_dict().items()}
    mt = hf_model.config.model_type
    if mt in ("llama", "mistral", "qwen2", "qwen3", "gemma"):
        return _params_from_llama_sd(sd, cfg, mt, device)
    if mt == "gpt_neox":
        return _params_from_neox_sd(sd, cfg, device)
    if mt == "deepseek_v2":
        return _params_from_deepseek_sd(sd, cfg, device)
    raise ValueError(f"unsupported model_type: {mt}")


def _params_from_llama_sd(sd, cfg: ModelConfig, mt: str,
                          device=None) -> Params:
    device = resolve_device(device)
    L = cfg.num_layers
    p = "model.layers.{}."

    def c(a):
        return _cast(a, cfg, device)

    def lin(name):  # torch Linear stores [out, in] -> [in, out]
        return c(_stack(sd, p + name, L, transpose=True))

    layers: Params = {
        "attn_norm_w": c(_stack(sd, p + "input_layernorm.weight", L)),
        "mlp_norm_w": c(_stack(sd, p + "post_attention_layernorm.weight", L)),
        "wq": lin("self_attn.q_proj.weight"),
        "wk": lin("self_attn.k_proj.weight"),
        "wv": lin("self_attn.v_proj.weight"),
        "wo": lin("self_attn.o_proj.weight"),
        "w_gate": lin("mlp.gate_proj.weight"),
        "w_up": lin("mlp.up_proj.weight"),
        "w_down": lin("mlp.down_proj.weight"),
    }
    if cfg.attn_qkv_bias:
        for k in ("q", "k", "v"):
            layers[f"b{k}"] = c(_stack(sd, p + f"self_attn.{k}_proj.bias", L))
    if cfg.qk_norm:
        for k in ("q", "k"):
            layers[f"{k}_norm_w"] = c(_stack(
                sd, p + f"self_attn.{k}_norm.weight", L))
    params: Params = {
        "embed": c(sd["model.embed_tokens.weight"]),
        "layers": layers,
        "final_norm_w": c(sd["model.norm.weight"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = c(np.swapaxes(sd["lm_head.weight"], 0, 1))
    if mt == "gemma":
        # gemma's RMSNorm scales by (1 + weight): the +1 is folded here, in
        # the model's dtype, so the model's rms_norm stays generic
        for key in ("attn_norm_w", "mlp_norm_w"):
            layers[key] = layers[key] + 1.0
        params["final_norm_w"] = params["final_norm_w"] + 1.0
    return params


def _params_from_neox_sd(sd, cfg: ModelConfig, device=None) -> Params:
    device = resolve_device(device)
    L, D = cfg.num_layers, cfg.hidden_size
    H, Dh = cfg.num_heads, cfg.head_dim
    p = "gpt_neox.layers.{}."

    def c(a):
        return _cast(a, cfg, device)

    # fused qkv rows laid out per head as [q(Dh), k(Dh), v(Dh)]
    qkv_w = _stack(sd, p + "attention.query_key_value.weight",
                   L).reshape(L, H, 3, Dh, D)
    qkv_b = _stack(sd, p + "attention.query_key_value.bias",
                   L).reshape(L, H, 3, Dh)

    def split_w(j):  # -> [L, D, H*Dh]
        return np.swapaxes(qkv_w[:, :, j].reshape(L, H * Dh, D), 1, 2)

    def split_b(j):  # -> [L, H*Dh]
        return qkv_b[:, :, j].reshape(L, H * Dh)

    def lin(name):
        return c(_stack(sd, p + name, L, transpose=True))

    def vec(name):
        return c(_stack(sd, p + name, L))

    layers: Params = {
        "attn_norm_w": vec("input_layernorm.weight"),
        "attn_norm_b": vec("input_layernorm.bias"),
        "mlp_norm_w": vec("post_attention_layernorm.weight"),
        "mlp_norm_b": vec("post_attention_layernorm.bias"),
        "wq": c(split_w(0)), "wk": c(split_w(1)), "wv": c(split_w(2)),
        "bq": c(split_b(0)), "bk": c(split_b(1)), "bv": c(split_b(2)),
        "wo": lin("attention.dense.weight"),
        "bo": vec("attention.dense.bias"),
        "w_up": lin("mlp.dense_h_to_4h.weight"),
        "b_up": vec("mlp.dense_h_to_4h.bias"),
        "w_down": lin("mlp.dense_4h_to_h.weight"),
        "b_down": vec("mlp.dense_4h_to_h.bias"),
    }
    params: Params = {
        "embed": c(sd["gpt_neox.embed_in.weight"]),
        "layers": layers,
        "final_norm_w": c(sd["gpt_neox.final_layer_norm.weight"]),
        "final_norm_b": c(sd["gpt_neox.final_layer_norm.bias"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = c(np.swapaxes(sd["embed_out.weight"], 0, 1))
    return params


def _params_from_deepseek_sd(sd, cfg: ModelConfig, device=None) -> Params:
    """deepseek_v2's state dict -> params whose ``layers`` is a list of
    per-layer dicts (``core/mla.py``, ``core/moe.py`` name the tensors):
    every projection [in, out]; the routed experts stacked [E, in, out];
    the router dense [D, E]; kv_b's absorbed weights ``w_uk``/``w_uv`` in
    float32."""
    from specdec_tpu_torch.core.mla import absorbed_weights

    device = resolve_device(device)

    def c(a):
        return _cast(a, cfg, device)

    def lin(key):
        return c(np.swapaxes(sd[key], -1, -2))

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        lay = {"attn_norm_w": c(sd[p + "input_layernorm.weight"]),
               "mlp_norm_w": c(sd[p + "post_attention_layernorm.weight"]),
               "kv_norm_w": c(sd[a + "kv_a_layernorm.weight"]),
               "wq": lin(a + "q_proj.weight"),
               "w_kva": lin(a + "kv_a_proj_with_mqa.weight"),
               "w_kvb": lin(a + "kv_b_proj.weight"),
               "wo": lin(a + "o_proj.weight")}
        lay["w_uk"], lay["w_uv"] = absorbed_weights(cfg, lay["w_kvb"])
        m = p + "mlp."
        if cfg.is_moe_layer(i):
            lay["router"] = lin(m + "gate.weight")
            for name in ("gate", "up", "down"):
                lay[f"shared_{name}"] = lin(
                    m + f"shared_experts.{name}_proj.weight")
                lay[f"experts_{name}"] = c(np.stack([
                    np.swapaxes(sd[m + f"experts.{e}.{name}_proj.weight"],
                                0, 1)
                    for e in range(cfg.n_routed_experts)]))
        else:
            for name in ("gate", "up", "down"):
                lay[f"w_{name}"] = lin(m + f"{name}_proj.weight")
        layers.append(lay)
    params: Params = {"embed": c(sd["model.embed_tokens.weight"]),
                      "layers": layers,
                      "final_norm_w": c(sd["model.norm.weight"])}
    if not cfg.tie_embeddings:
        params["lm_head"] = lin("lm_head.weight")
    return params


def import_transformers():
    """``transformers``, or an ImportError that names it and what needs
    it."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            "transformers is not installed: it is needed to load a "
            "checkpoint's tokenizer and checkpoints that are not llama-"
            "lineage safetensors (core/stream_loader.py loads those without "
            "it)") from e
    return transformers


def load_hf_model(path: str, dtype=torch.bfloat16,
                  device=None) -> Tuple[ModelConfig, Params]:
    """Load a local HF checkpoint (no network) through ``transformers``'s
    torch model, whole, and convert it to the port's params on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    transformers = import_transformers()
    hf_cfg = transformers.AutoConfig.from_pretrained(path)
    cfg = config_from_hf(hf_cfg, dtype=dtype)
    model = transformers.AutoModelForCausalLM.from_pretrained(
        path, torch_dtype=torch.float32)
    params = params_from_hf(model, cfg, device)
    del model
    return cfg, params
