"""Benchmark entry point (counterpart of ``specdec_tpu/cli/benchmark.py``):
``python -m specdec_tpu_torch.cli.benchmark``, configured by the
environment (``engine/benchmark_runner.py``).

INFERENCE_ENGINE keeps the reference's two-tier switch: "transformers" and
"vllm" both run the port's native engine on the card (the VLLM_*
variables map onto it). The entry point always runs on the card: without
CUDA it raises (``resolve_device``) and never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os

from specdec_tpu_torch import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Speculative decoding benchmark (PyTorch/CUDA port)")
    ap.add_argument("--target-model", default=None,
                    help="target model: a checkpoint directory or "
                         "synthetic:<preset> (overrides TARGET_MODEL)")
    ap.add_argument("--drafter-model", default=None,
                    help="drafter model: a checkpoint directory, "
                         "synthetic:<preset>, layerskip:<k> or eagle:<depth> "
                         "(overrides DRAFTER_MODEL)")
    args = ap.parse_args(argv)
    device = resolve_device(None)

    engine = os.getenv("INFERENCE_ENGINE", "transformers").lower()
    if engine not in ("transformers", "vllm", "native", "cuda"):
        print(f"warning: unknown INFERENCE_ENGINE {engine!r}; using native")
    if engine == "vllm":
        print("INFERENCE_ENGINE=vllm: the VLLM_* variables configure the "
              "native engine (no separate vLLM process)")

    from specdec_tpu_torch.engine.benchmark_runner import BenchmarkRunner
    return BenchmarkRunner(target_model=args.target_model,
                           drafter_model=args.drafter_model, device=device)


if __name__ == "__main__":
    main()
