"""vLLM-tier configuration facade (counterpart of
``specdec_tpu/engine/vllm_compat.py``).

The reference's second engine tier is vLLM, configured by ``VLLM_*``
environment variables. Here, as in the JAX package, the native continuous
batcher is that engine: ``VLLMConfig`` keeps vLLM's fields and
``create_vllm_config_from_env`` its variables, and ``VLLMEngineManager``
serves on the default paged engine (``PagedContinuousBatcher``; prefix
caching and chunked prefill when asked), the slotted one under
``SPECDEC_SERVE_ENGINE=slotted``, or the EAGLE batcher for an ``eagle:``
drafter. ``KV_QUANT`` (the runner's variable) sets the KV format.

A ``tensor_parallel_size`` above 1 serves on a pure-TP mesh
(``parallel/``) over a world of that many processes, one per card, joined
from torchrun's or the JAX runner's variables
(``parallel/distributed.py``); pipeline stages fold into tensor
parallelism where the world allows it and are ignored with a warning where
it does not, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

import torch

from specdec_tpu_torch import resolve_device


@dataclasses.dataclass
class VLLMConfig:
    """Field parity with the reference's ``VLLMConfig``."""

    model: str = ""
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    gpu_memory_utilization: float = 0.85  # accepted, unused
    max_model_len: int = 4096
    max_num_seqs: int = 128
    max_num_batched_tokens: Optional[int] = None
    dtype: str = "bfloat16"
    quantization: Optional[str] = None
    enable_prefix_caching: bool = False
    disable_log_stats: bool = True
    speculative_config: Optional[Dict[str, Any]] = None  # {model, num_speculative_tokens}


def create_vllm_config_from_env() -> VLLMConfig:
    """The reference's ``VLLM_*`` variables."""
    spec = None
    if os.getenv("VLLM_ENABLE_SPECULATIVE", "false").lower() == "true":
        spec = {
            "model": os.getenv("DRAFTER_MODEL", ""),
            "num_speculative_tokens": int(
                os.getenv("VLLM_NUM_SPECULATIVE_TOKENS",
                          os.getenv("GAMMA_VALUE", "5"))),
        }
    dtype = os.getenv("VLLM_DTYPE", "bfloat16")
    if dtype in ("half", "float16"):
        dtype = "bfloat16"
    return VLLMConfig(
        model=os.getenv("TARGET_MODEL", ""),
        tensor_parallel_size=int(os.getenv("VLLM_TENSOR_PARALLEL_SIZE", "1")),
        pipeline_parallel_size=int(os.getenv("VLLM_PIPELINE_PARALLEL_SIZE", "1")),
        gpu_memory_utilization=float(
            os.getenv("VLLM_GPU_MEMORY_UTILIZATION", "0.85")),
        max_model_len=int(os.getenv("VLLM_MAX_MODEL_LEN", "4096")),
        max_num_seqs=int(os.getenv("VLLM_MAX_NUM_SEQS", "128")),
        max_num_batched_tokens=(
            int(os.environ["VLLM_MAX_NUM_BATCHED_TOKENS"])
            if os.getenv("VLLM_MAX_NUM_BATCHED_TOKENS") else None),
        dtype=dtype,
        quantization=os.getenv("VLLM_QUANTIZATION") or None,
        enable_prefix_caching=os.getenv("VLLM_ENABLE_PREFIX_CACHING",
                                        "false").lower() == "true",
        disable_log_stats=os.getenv("VLLM_DISABLE_LOG_STATS",
                                    "true").lower() == "true",
        speculative_config=spec,
    )


def _world_size(device: torch.device) -> int:
    """The ranks of the world this process joins (1 without one)."""
    import torch.distributed as dist

    from specdec_tpu_torch.parallel import init_distributed

    return dist.get_world_size() if init_distributed(device=device) else 1


class VLLMEngineManager:
    """The reference manager's API over the port's continuous batchers, on
    ``device`` (``None``: the card)."""

    def __init__(self, config: VLLMConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.batcher = None
        self.tokenizer = None
        self._end_tokens: List[int] = []

    def initialize(self, num_slots: Optional[int] = None,
                   max_new_tokens: Optional[int] = None):
        from specdec_tpu_torch.engine.model_loader import load_models
        from specdec_tpu_torch.serve.scheduler import ContinuousBatcher

        tp = self.config.tensor_parallel_size
        world = _world_size(self.device)
        if self.config.pipeline_parallel_size > 1:
            # the JAX engine serves decode tensor-parallel and folds the
            # requested stages into TP where the devices allow it
            folded = tp * self.config.pipeline_parallel_size
            if world >= folded:
                warnings.warn(
                    "pipeline_parallel_size > 1: serving decode uses tensor "
                    f"parallelism; folding stages into TP (tp {tp} -> "
                    f"{folded})", stacklevel=2)
                tp = folded
            else:
                warnings.warn(
                    f"pipeline_parallel_size > 1 ignored: tp x pp = {folded} "
                    f"exceeds a world of {world} rank(s); keeping tp={tp}",
                    stacklevel=2)
        mesh = None
        if tp > 1:
            from specdec_tpu_torch.parallel import build_mesh
            if world != tp:
                raise ValueError(
                    f"tensor_parallel_size {tp} needs a world of {tp} "
                    f"processes, one per card (this one has {world}); "
                    "launch with torchrun --nproc-per-node "
                    f"{tp} (or set COORDINATOR_ADDRESS, NUM_PROCESSES and "
                    "PROCESS_ID)")
            mesh = build_mesh(tp=tp, dp=1, device=self.device)

        spec = self.config.speculative_config or {}
        drafter_path = spec.get("model") or os.getenv("DRAFTER_MODEL")
        gamma = int(spec.get("num_speculative_tokens", 5))
        dtype = (torch.bfloat16 if self.config.dtype == "bfloat16"
                 else torch.float32)
        bundle = load_models(self.config.model, drafter_path, dtype=dtype,
                             quantization=self.config.quantization or "none",
                             kv_quant=os.getenv("KV_QUANT", "none").lower(),
                             device=self.device, mesh=mesh)
        self.tokenizer = bundle["tokenizer"]
        self._end_tokens = bundle["end_tokens"]
        drafter = bundle["drafter"] or bundle["target"]  # self-draft
        target = bundle["target"]
        common = dict(
            num_slots=num_slots or min(self.config.max_num_seqs, 8),
            gamma=gamma,
            max_prompt_len=min(self.config.max_model_len, 2048),
            max_new_tokens=(max_new_tokens
                            or int(os.getenv("MAX_TOKENS", "256"))),
            eos_tokens_id=self._end_tokens, device=self.device)
        models = (drafter["cfg"], drafter["params"], target["cfg"],
                  target["params"])
        if (bundle["drafter"] or {}).get("eagle"):
            # an eagle: drafter is a head on the target, not a model
            from specdec_tpu_torch.serve.eagle_scheduler import (
                EagleContinuousBatcher,
            )
            self.batcher = EagleContinuousBatcher(
                *models, pad_token_id=bundle["pad_token_id"], **common)
            if self.config.enable_prefix_caching:
                warnings.warn("enable_prefix_caching is only implemented in "
                              "the paged engine; ignored for the EAGLE "
                              "batcher", stacklevel=2)
        elif (self.config.enable_prefix_caching
              or self.config.max_num_batched_tokens):
            # vLLM's prefix caching and chunked prefill live in its paged
            # engine; max_num_batched_tokens bounds an admission slice
            from specdec_tpu_torch.serve.paged_scheduler import (
                PagedContinuousBatcher,
            )
            chunk = self.config.max_num_batched_tokens
            self.batcher = PagedContinuousBatcher(
                *models, prefix_caching=self.config.enable_prefix_caching,
                prefill_chunk=(min(chunk, common["max_prompt_len"])
                               if chunk else None),
                **common)
        elif os.getenv("SPECDEC_SERVE_ENGINE", "paged") == "slotted":
            self.batcher = ContinuousBatcher(*models, **common)
        else:
            # the default engine is paged, as vLLM's
            from specdec_tpu_torch.serve.paged_scheduler import (
                PagedContinuousBatcher,
            )
            self.batcher = PagedContinuousBatcher(*models, **common)
        return True

    def _check_initialized(self):
        if self.batcher is None:
            raise RuntimeError("call initialize() first")

    def generate(self, prompt: str, max_tokens: int = 100) -> str:
        """One request, run to completion."""
        self._check_initialized()
        ids = self.tokenizer.encode(prompt)
        rid = self.batcher.submit(ids, max_new_tokens=max_tokens)
        while rid not in self.batcher.completed:
            self.batcher.step()
        out = self.batcher.completed[rid].output_ids
        return self.tokenizer.decode(out, skip_special_tokens=True)

    def generate_batch(self, prompts: Sequence[str],
                       max_tokens: int = 100) -> List[str]:
        """Every prompt submitted at once and served concurrently."""
        self._check_initialized()
        rids = [self.batcher.submit(self.tokenizer.encode(p),
                                    max_new_tokens=max_tokens)
                for p in prompts]
        self.batcher.run()
        return [self.tokenizer.decode(self.batcher.completed[r].output_ids,
                                      skip_special_tokens=True)
                for r in rids]


def is_vllm_available() -> bool:
    """The native engine is always available."""
    return True
