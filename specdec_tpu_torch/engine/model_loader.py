"""Model and tokenizer loading for the benchmark harness (counterpart of
``specdec_tpu/engine/model_loader.py``).

A model spec is one of:

- ``synthetic:<preset>``: a model of a public model's shape
  (``SYNTHETIC_PRESETS``) with random weights seeded by ``zlib.crc32`` of
  the preset's name, and the byte-level ``SyntheticTokenizer``;
  ``synthetic:<preset>-ls<k>`` damps the residual outputs of layers >= k
  to 0.08, the LayerSkip structure ``bench.py`` measures; a quantized
  preset, damped or not, is built directly in quantized form one layer at
  a time (``quant/core.py::init_quantized_params``);
- a local checkpoint directory: its ``config.json`` decides the family;
  llama-lineage safetensors checkpoints stream layer by layer
  (``core/stream_loader.py``, no ``transformers``), others load whole
  through ``transformers`` (``core/hf_loader.py::load_hf_model``); the
  tokenizer of a checkpoint directory is ``transformers.AutoTokenizer``'s;
- ``trained:<preset>[@<steps>]``: the preset's shapes PRETRAINED at load
  on the order-1 Markov stream (``engine/pretrain.py``; 2000 steps by
  default, batch 32 of 128 tokens, learning rate 1e-3, the stream and the
  training seeded by ``crc32`` of the preset and of the spec as in JAX),
  then quantized; the bundle carries ``stream_spec`` and
  ``pretrain_nll``. A 4-bit K that no container holds (not a multiple of
  64) is refused before training (``check_kernel_shapes``);
- drafter only: ``layerskip:<k>``, the target's first k layers as views of
  its (quantized) containers, sharing its embedding, final norm and head;
  ``eagle:<depth>[@<steps>]``, an EAGLE head (``core/eagle.py``) seeded by
  ``crc32("eagle:<target>:<depth>")``, trained on the loaded target for
  ``steps`` on-policy steps (``engine/eagle_train.py``; EAGLE_TRAIN_BATCH
  8, EAGLE_TRAIN_SEQ 128, EAGLE_ROLLOUT 3) and saved to the directory
  EAGLE_SAVE names, if set; ``eagle:<dir>``, a head saved by
  ``engine/checkpoint.py`` (a spec holding ``/`` or naming a directory),
  its depth read from ``layers.wo``'s leading axis.

A T5 or mT5 checkpoint directory loads as a codec model
(``core/codec_model.py::load_codec_checkpoint``, the port's own
safetensors reader) into ``{"cfg", "params", "codec": True}``, dense at
``dtype``: a codec target or drafter with a quantization, and a
``layerskip:`` or ``eagle:`` drafter over a codec target, are refused
before anything is read; ``kv_quant`` does not apply to it.

``mesh`` (``parallel/mesh.py``) shards the target after loading and
replicates the drafter, as the JAX loader does: every rank loads the whole
model, keeps its shard (``shard_params``) and returns the local config
(``local_config``); a drafter, LayerSkip views and EAGLE heads included,
is copied whole on every rank. ``device=None`` means the card (the mesh's
device under a mesh).
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, Optional

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import init_params, layer_views
from specdec_tpu_torch.quant.core import (
    check_kernel_shapes, init_quantized_params, quantize_params,
)

# shapes of public models (weights random: used where no checkpoint is)
SYNTHETIC_PRESETS: Dict[str, dict] = {
    "llama-1b": dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                     num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64,
                     max_position_embeddings=2048),
    "llama-8b": dict(vocab_size=128256, hidden_size=4096,
                     intermediate_size=14336, num_layers=32, num_heads=32,
                     num_kv_heads=8, head_dim=128,
                     max_position_embeddings=8192, rope_theta=500000.0),
    "llama-160m": dict(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                       num_layers=12, num_heads=12, num_kv_heads=12, head_dim=64,
                       max_position_embeddings=2048),
    "llama-70m": dict(vocab_size=32000, hidden_size=512, intermediate_size=1376,
                      num_layers=6, num_heads=8, num_kv_heads=8, head_dim=64,
                      max_position_embeddings=2048),
    "pythia-70m": dict(vocab_size=50304, hidden_size=512, intermediate_size=2048,
                       num_layers=6, num_heads=8, num_kv_heads=8, head_dim=64,
                       max_position_embeddings=2048, norm_type="layernorm",
                       act="gelu", gated_mlp=False, parallel_residual=True,
                       rotary_pct=0.25, attn_qkv_bias=True, attn_out_bias=True,
                       mlp_bias=True),
    "pythia-410m": dict(vocab_size=50304, hidden_size=1024,
                        intermediate_size=4096, num_layers=24, num_heads=16,
                        num_kv_heads=16, head_dim=64,
                        max_position_embeddings=2048, norm_type="layernorm",
                        act="gelu", gated_mlp=False, parallel_residual=True,
                        rotary_pct=0.25, attn_qkv_bias=True,
                        attn_out_bias=True, mlp_bias=True),
    "tiny": dict(vocab_size=2048, hidden_size=256, intermediate_size=704,
                 num_layers=4, num_heads=8, num_kv_heads=4, head_dim=32,
                 max_position_embeddings=1024),
}

LAYERSKIP_DAMP = 0.08


def _seed(text: str) -> int:
    # zlib.crc32, not hash(): str hashes change per process
    return zlib.crc32(text.encode()) % (2 ** 31)


class SyntheticTokenizer:
    """Deterministic byte-level tokenizer for synthetic models: token id =
    byte value + 3 (0 = pad, 1 = eos, 2 = bos)."""

    PAD, EOS, BOS = 0, 1, 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.pad_token_id = self.PAD
        self.eos_token_id = self.EOS
        self.chat_template = None

    def encode(self, text: str):
        return [self.BOS] + [3 + b for b in text.encode("utf-8")][:2000]

    def decode(self, ids, skip_special_tokens: bool = True):
        data = bytes(max(0, min(255, int(t) - 3)) for t in ids if int(t) >= 3)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text, **kw):
        return {"input_ids": self.encode(text)}


def _synthetic(name: str, dtype, quantization: str = "none",
               device=None) -> Dict[str, Any]:
    """A ``synthetic:<preset>[-ls<k>]`` bundle on ``device``."""
    device = resolve_device(device)
    preset = name.split(":", 1)[1] if ":" in name else name
    damp_from = None
    base = preset
    if "-ls" in preset:
        base, _, k = preset.rpartition("-ls")
        damp_from = int(k)
    if base not in SYNTHETIC_PRESETS:
        raise ValueError(f"unknown synthetic preset {base!r}; "
                         f"choose from {sorted(SYNTHETIC_PRESETS)}")
    cfg = ModelConfig(dtype=dtype, **SYNTHETIC_PRESETS[base])
    seed = _seed(base)
    scales = None
    if damp_from is not None:
        if not 0 < damp_from < cfg.num_layers:
            raise ValueError(
                f"-ls{damp_from} needs 1..{cfg.num_layers - 1} for "
                f"{base!r} ({cfg.num_layers} layers)")
        scales = [1.0 if i < damp_from else LAYERSKIP_DAMP
                  for i in range(cfg.num_layers)]
    if quantization != "none":
        # one layer at a time: an 8B bf16 stack would be 16 GB dense
        return {"cfg": cfg, "quantized": quantization,
                "params": init_quantized_params(
                    cfg, seed=seed, kind=quantization, scale=0.02,
                    layer_out_scales=scales, device=device)}
    params = init_params(cfg, seed=seed, scale=0.02, device=device)
    if scales is not None:
        sv = torch.tensor(scales, dtype=torch.float32, device=device)
        layers = dict(params["layers"])
        for nm in ("wo", "w_down"):
            layers[nm] = (layers[nm].to(torch.float32)
                          * sv[:, None, None]).to(cfg.dtype)
        params = dict(params, layers=layers)
    return {"cfg": cfg, "params": params}


def _trained(name: str, dtype, quantization: str = "none",
             device=None) -> Dict[str, Any]:
    """A ``trained:<preset>[@<steps>]`` bundle on ``device``: the JAX
    loader's stream and training settings, quantized after training."""
    from specdec_tpu_torch.engine.pretrain import (
        MarkovSpec, build_trained_target,
    )

    device = resolve_device(device)
    preset, _, steps = name.split(":", 1)[1].partition("@")
    if preset not in SYNTHETIC_PRESETS:
        raise ValueError(f"unknown preset {preset!r} in {name!r}; "
                         f"choose from {sorted(SYNTHETIC_PRESETS)}")
    cfg = ModelConfig(dtype=dtype, **SYNTHETIC_PRESETS[preset])
    check_kernel_shapes(cfg, quantization)
    stream = MarkovSpec(vocab_size=cfg.vocab_size,
                        num_states=min(cfg.vocab_size, 8192), branching=8,
                        zipf_s=1.2, order=1, seed=_seed(preset))
    params, nll = build_trained_target(
        cfg, stream, steps=int(steps or 2000), batch_size=32, seq_len=128,
        learning_rate=1e-3, seed=_seed(name), device=device)
    out = {"cfg": cfg, "params": params, "stream_spec": stream,
           "pretrain_nll": nll}
    if quantization != "none":
        out["params"] = quantize_params(params, kind=quantization, fuse=True,
                                        cfg=cfg)
        out["quantized"] = quantization
    return out


def _eagle(spec: str, target_path: str, target: Dict[str, Any],
           device) -> Dict[str, Any]:
    """The ``eagle:<...>`` drafter of ``spec`` (what follows ``eagle:``)
    for the loaded ``target``."""
    from specdec_tpu_torch.core.eagle import init_eagle_params
    from specdec_tpu_torch.engine.checkpoint import load_params, save_params

    t_cfg = target["cfg"]
    if "/" in spec or os.path.isdir(spec):
        e_params = load_params(spec, device)
        e_cfg = t_cfg.replace(num_layers=int(e_params["layers"]["wo"]
                                             .shape[0]))
        return {"cfg": e_cfg, "params": e_params, "eagle": True}
    depth, _, steps = spec.partition("@")
    depth, steps = int(depth), int(steps or 0)
    if not 0 < depth < t_cfg.num_layers:
        raise ValueError(
            f"eagle:{depth} needs 1..{t_cfg.num_layers - 1} layers")
    e_cfg = t_cfg.replace(num_layers=depth)
    seed = _seed(f"eagle:{target_path}:{depth}")
    e_params = init_eagle_params(e_cfg, seed=seed, device=device)
    if steps > 0:
        from specdec_tpu_torch.engine.eagle_train import train_eagle

        e_params, acc = train_eagle(
            t_cfg, target["params"], e_cfg, e_params, steps=steps,
            batch_size=int(os.getenv("EAGLE_TRAIN_BATCH", "8")),
            seq_len=int(os.getenv("EAGLE_TRAIN_SEQ", "128")),
            # HASS-style multi-step alignment: deployed acceptance is
            # rollout acceptance
            rollout_steps=int(os.getenv("EAGLE_ROLLOUT", "3")),
            seed=seed + 1, device=device)
        print(f"eagle drafter trained {steps} steps: teacher-forced "
              f"acceptance proxy {acc:.3f}")
        save_dir = os.getenv("EAGLE_SAVE", "")
        if save_dir:
            print("eagle drafter saved to "
                  f"{save_params(save_dir, e_params, overwrite=True)}")
    return {"cfg": e_cfg, "params": e_params, "eagle": True}


CODEC_TYPES = ("t5", "mt5")


def _is_codec(path: Optional[str]) -> bool:
    """Whether ``path`` is a checkpoint directory of an encoder-decoder
    (its ``config.json`` names a T5-family model type)."""
    config = os.path.join(path or "", "config.json")
    if not os.path.isfile(config):
        return False
    from specdec_tpu_torch.core.stream_loader import read_config
    return read_config(path).get("model_type", "") in CODEC_TYPES


def _refuse_for_codec(target_path, drafter_path, quantization,
                      drafter_quantization):
    """Raise ValueError for what a codec model cannot take, before any
    weight is read: codec models load dense (neither package has a
    quantized codec forward), and a ``layerskip:`` or ``eagle:`` drafter
    needs a decoder-only target."""
    drafter_path = drafter_path or ""
    derived = drafter_path.startswith(("layerskip:", "eagle:"))
    if _is_codec(target_path):
        if quantization != "none":
            raise ValueError(
                f"{target_path!r} is an encoder-decoder (T5) checkpoint: "
                f"codec models load dense, not quantization={quantization!r}")
        if derived:
            raise ValueError(
                f"drafter {drafter_path!r} needs a decoder-only target; "
                f"{target_path!r} is an encoder-decoder (T5) checkpoint "
                "(codec models load dense, from their own checkpoints)")
    if not derived and _is_codec(drafter_path) and \
            drafter_quantization != "none":
        raise ValueError(
            f"{drafter_path!r} is an encoder-decoder (T5) checkpoint: codec "
            f"models load dense, not drafter_quantization="
            f"{drafter_quantization!r}")


def _load_tokenizer(path: str):
    """A checkpoint directory's tokenizer (``transformers``), with the pad
    token falling back to EOS."""
    from specdec_tpu_torch.core.hf_loader import import_transformers

    tokenizer = import_transformers().AutoTokenizer.from_pretrained(path)
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.eos_token
    return tokenizer


def _end_tokens(tokenizer) -> list:
    """EOS plus the chat-turn terminators in the vocabulary: Qwen's
    ``<|im_end|>`` and gemma's ``<end_of_turn>``."""
    end_tokens = []
    if tokenizer.eos_token_id is not None:
        end_tokens.append(int(tokenizer.eos_token_id))
    for turn_end in ("<|im_end|>", "<end_of_turn>"):
        try:
            tid = tokenizer.convert_tokens_to_ids(turn_end)
            # unknown tokens map to unk on many tokenizers: require real
            # vocabulary membership
            if (tid is not None and tid >= 0 and tid not in end_tokens
                    and turn_end in tokenizer.get_vocab()):
                end_tokens.append(int(tid))
        except Exception:
            pass
    return end_tokens


def load_models(
    target_model_path: str,
    drafter_model_path: Optional[str] = None,
    dtype=torch.bfloat16,
    quantization: str = "none",          # none | int8 | int4 | nf4 | fp4
    drafter_quantization: str = "none",
    kv_quant: str = "none",              # none | int8 (KV-cache format)
    device=None,
    mesh=None,
) -> Dict[str, Any]:
    """Load the target (and the drafter, if any) and the tokenizer onto
    ``device`` (``None``: the card). Returns the JAX loader's bundle:
    ``{"target", "drafter", "tokenizer", "end_tokens", "pad_token_id"}``,
    each model a dict with ``cfg`` and ``params`` (``quantized`` for a
    quantized one, ``eagle`` for an EAGLE head, ``codec`` for a T5-family
    encoder-decoder). Under ``mesh`` the target's ``params`` are this
    rank's shard and its ``cfg`` the local config."""
    device = resolve_device(device if device is not None or mesh is None
                            else mesh.device)
    _refuse_for_codec(target_model_path, drafter_model_path, quantization,
                      drafter_quantization)
    if mesh is not None and _is_codec(target_model_path):
        raise ValueError("encoder-decoder (T5) models take no mesh")

    def load_one(path, quant="none"):
        if path.startswith("synthetic"):
            return _synthetic(path, dtype, quant, device), None
        if path.startswith("trained"):
            return _trained(path, dtype, quant, device), None
        from specdec_tpu_torch.core.stream_loader import (
            STREAMED_TYPES, load_hf_streamed, read_config,
        )
        mt = read_config(path).get("model_type", "")
        if mt in CODEC_TYPES:
            from specdec_tpu_torch.core.codec_model import (
                load_codec_checkpoint,
            )
            cfg, params = load_codec_checkpoint(path, dtype=dtype,
                                                device=device)
            return ({"cfg": cfg, "params": params, "codec": True},
                    _load_tokenizer(path))
        tokenizer = _load_tokenizer(path)
        if mt in STREAMED_TYPES and any(os.path.exists(os.path.join(
                path, f)) for f in ("model.safetensors",
                                    "model.safetensors.index.json")):
            cfg, params = load_hf_streamed(path, dtype=dtype,
                                           quantization=quant, fuse=True,
                                           device=device)
            out = {"cfg": cfg, "params": params}
            if quant != "none":
                out["quantized"] = quant
            return out, tokenizer
        from specdec_tpu_torch.core.hf_loader import load_hf_model
        cfg, params = load_hf_model(path, dtype=dtype, device=device)
        check_kernel_shapes(cfg, quant)
        return {"cfg": cfg, "params": params}, tokenizer

    drafter_spec = drafter_model_path or ""
    layerskip = drafter_spec.startswith("layerskip:")
    eagle = drafter_spec.startswith("eagle:")

    target, tokenizer = load_one(target_model_path, quant=quantization)
    if kv_quant != "none" and not target.get("codec"):
        # reaches every decode loop and scheduler through init_cache(cfg)
        target["cfg"] = target["cfg"].replace(kv_quant=kv_quant)
    drafter = None
    if drafter_model_path and not (layerskip or eagle):
        drafter, d_tokenizer = load_one(drafter_model_path,
                                        quant=drafter_quantization)
        if kv_quant != "none" and not drafter.get("codec"):
            drafter["cfg"] = drafter["cfg"].replace(kv_quant=kv_quant)
        tokenizer = tokenizer or d_tokenizer
    if tokenizer is None:
        tokenizer = SyntheticTokenizer(target["cfg"].vocab_size)

    # synthetic models are built quantized; checkpoints loaded whole
    # quantize here
    if quantization != "none" and "quantized" not in target:
        target["params"] = quantize_params(target["params"],
                                           kind=quantization, fuse=True,
                                           cfg=target["cfg"])
    if (drafter is not None and drafter_quantization != "none"
            and "quantized" not in drafter):
        drafter["params"] = quantize_params(drafter["params"],
                                            kind=drafter_quantization,
                                            fuse=True, cfg=drafter["cfg"])

    t_cfg = target["cfg"]
    if layerskip:
        # self-speculative drafting: the target's first k layers (views of
        # its containers, taken after quantization) and its final norm and
        # head, the pair bench.py measures
        k = int(drafter_spec.split(":", 1)[1])
        if not 0 < k < t_cfg.num_layers:
            raise ValueError(f"layerskip:{k} needs 1..{t_cfg.num_layers - 1}"
                             " layers")
        drafter = {"cfg": t_cfg.replace(num_layers=k),
                   "params": dict(target["params"], layers=layer_views(
                       target["params"]["layers"], k))}
        if "quantized" in target:
            drafter["quantized"] = target["quantized"]
    if eagle:
        drafter = _eagle(drafter_spec.split(":", 1)[1], target_model_path,
                         target, device)

    if drafter is not None and drafter["cfg"].vocab_size != t_cfg.vocab_size:
        raise ValueError("drafter and target must share a vocabulary")
    if mesh is not None:
        from specdec_tpu_torch.parallel.mesh import local_config, shard_params
        target["params"] = shard_params(target["params"], t_cfg, mesh)
        target["cfg"] = local_config(t_cfg, mesh)
        if drafter is not None:
            drafter["params"] = shard_params(drafter["params"],
                                             drafter["cfg"], mesh,
                                             replicated=True)
    return {
        "target": target,
        "drafter": drafter,
        "tokenizer": tokenizer,
        "end_tokens": _end_tokens(tokenizer),
        "pad_token_id": int(getattr(tokenizer, "pad_token_id", 0) or 0),
    }
