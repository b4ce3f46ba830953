"""Benchmark runner: environment -> models -> load loop -> reports
(counterpart of ``specdec_tpu/engine/benchmark_runner.py``).

The JAX runner's environment surface: GAMMA_VALUE, GENERATION_LENGTH,
INFERENCE_METHOD (speculative | target_ar | ngram), ENABLE_BATCH,
BATCH_SIZE, MAX_BATCH_LENGTH, NUM_PROMPTS, AUTO_RATE, AUTO_DURATION,
PROMPT_MIN_LENGTH, PROMPT_MAX_LENGTH, MAX_LOAD_LINES, SHAREGPT_DIR,
OUTPUT_FILE, ENABLE_GPU_MONITOR, GPU_MONITOR_INTERVAL, TARGET_MODEL,
DRAFTER_MODEL, QUANTIZATION, KV_QUANT, MODEL_DTYPE, NGRAM_N, NGRAM_DEVICE,
NGRAM_DEVICE_CAPACITY, RESET_IN_BETWEEN, FILLER_TOP_K, BENCH_SEED; the same
results files: ``<base>.json`` (every method's results and the telemetry),
``<base>_<method>.json`` (``_target`` for target_ar) and ``<base>_gpu.json``.

``device`` ``None`` means the card. TP_SIZE (or
VLLM_TENSOR_PARALLEL_SIZE) and DP_SIZE build a ('data', 'model') mesh
(``parallel/``) over a world of one process per card, joined from torchrun's
or the JAX runner's variables (``parallel/distributed.py``); a process
launched as one rank of a world with neither set builds a pure-TP mesh over
the world. Every rank runs the same loop, the stop of a timed run is rank
0's, and only rank 0 writes the results files. A request's sampling draws come
from ``request_generator()``, a ``torch.Generator`` seeded from BENCH_SEED
and the request index (the JAX runner folds the index into a key); its
prompt is chosen by Python's ``random`` seeded with BENCH_SEED + index, so
both runners choose the same prompts.
"""
from __future__ import annotations

import json
import os
import random
import time
from typing import Optional

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.engine.benchmark_executor import execute_benchmark_loop
from specdec_tpu_torch.engine.dataset import load_sharegpt_multi
from specdec_tpu_torch.engine.metrics import (
    BenchmarkResults, print_benchmark_summary,
)
from specdec_tpu_torch.engine.monitor import (
    TelemetryMonitor, print_power_summary,
)
from specdec_tpu_torch.sampling.processors import GreedyProcessor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.bfloat16}


class BenchmarkRunner:
    def __init__(self, target_model: Optional[str] = None,
                 drafter_model: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        print("Speculative Decoding Performance Benchmark "
              f"({self.device.type})")
        print("=" * 70)
        self.target_model_arg = target_model
        self.drafter_model_arg = drafter_model
        self._load_config()
        self._load_models()
        self._load_sharegpt_data()
        self.processor = GreedyProcessor()
        self._run_benchmark()

    @staticmethod
    def _suffixed(base: str, suffix: str) -> str:
        if base.endswith(".json"):
            return base[:-len(".json")] + f"_{suffix}.json"
        return f"{base}_{suffix}.json"

    # ------------------------------------------------------------------ config
    def _load_config(self):
        self.gamma = int(os.getenv("GAMMA_VALUE", "4"))
        self.gen_len = int(os.getenv("GENERATION_LENGTH", "100"))

        method = os.getenv("INFERENCE_METHOD", "speculative").lower()
        if method not in ("speculative", "target_ar", "ngram"):
            print(f"warning: unknown INFERENCE_METHOD {method!r}, "
                  "defaulting to 'speculative'")
            method = "speculative"
        self.inference_method_name = method
        self.spec = method in ("speculative", "ngram")
        self.target_gen = method == "target_ar"

        self.debug = os.getenv("ENABLE_DEBUG", "false").lower() == "true"
        self.enable_batch = os.getenv("ENABLE_BATCH", "false").lower() == "true"
        self.batch_size = int(os.getenv("BATCH_SIZE", "4"))
        self.max_batch_length = int(os.getenv("MAX_BATCH_LENGTH", "512"))

        self.num_prompts = int(os.getenv("NUM_PROMPTS", "0"))
        self.auto_rate = float(os.getenv("AUTO_RATE", "1.0"))
        self.auto_duration = float(os.getenv("AUTO_DURATION", "300"))
        self.prompt_min_length = int(os.getenv("PROMPT_MIN_LENGTH", "10"))
        self.prompt_max_length = int(os.getenv("PROMPT_MAX_LENGTH", "500"))
        self.max_load_lines = int(os.getenv("MAX_LOAD_LINES", "10000"))

        self.sharegpt_dir = os.getenv("SHAREGPT_DIR", "sharegpt_gpt4")
        self.sharegpt_paths = [
            os.path.join(self.sharegpt_dir, "sharegpt_gpt4.jsonl"),
            os.path.join(self.sharegpt_dir, "sharegpt_V3_format.jsonl"),
            os.path.join(self.sharegpt_dir, "sharegpt_zh_38K_format.jsonl"),
        ]

        self.base_output_file = os.getenv("OUTPUT_FILE",
                                          "benchmark_results.json")
        suffix = {"target_ar": "target"}.get(self.inference_method_name,
                                             self.inference_method_name)
        self.output_file = self._suffixed(self.base_output_file, suffix)

        self.enable_monitor = os.getenv("ENABLE_GPU_MONITOR",
                                        "true").lower() == "true"
        self.monitor_interval = float(os.getenv("GPU_MONITOR_INTERVAL", "1.0"))

        self.quantization = os.getenv("QUANTIZATION", "none").lower()
        self.kv_quant = os.getenv("KV_QUANT", "none").lower()
        self.dtype = DTYPES[os.getenv("MODEL_DTYPE", "bfloat16")]
        self.tp_size = int(os.getenv("TP_SIZE",
                                     os.getenv("VLLM_TENSOR_PARALLEL_SIZE", "0")))
        self.dp_size = int(os.getenv("DP_SIZE", "0"))
        self.mesh = None

        self.chat = True
        self.reset_in_between = os.getenv("RESET_IN_BETWEEN",
                                          "false").lower() == "true"
        self.filler_top_k = int(os.getenv("FILLER_TOP_K", "3"))
        self.ngram = None
        self.base_seed = int(os.getenv("BENCH_SEED", "42"))
        self._request_index = 0

    # ------------------------------------------------------------------ models
    def _build_mesh(self):
        """The mesh TP_SIZE / DP_SIZE ask for, or pure TP over a launched
        world; None for a single process."""
        import torch.distributed as dist

        from specdec_tpu_torch.parallel import build_mesh, init_distributed

        launched = init_distributed(device=self.device)
        if self.tp_size > 1 or self.dp_size > 1:
            if not launched:
                raise ValueError(
                    f"TP_SIZE={self.tp_size}, DP_SIZE={self.dp_size}: a mesh "
                    "runs one process per card; launch with torchrun "
                    "--nproc-per-node N (or set COORDINATOR_ADDRESS, "
                    "NUM_PROCESSES and PROCESS_ID)")
            mesh = build_mesh(tp=self.tp_size or None,
                              dp=self.dp_size or None, device=self.device)
        elif launched and dist.get_world_size() > 1:
            mesh = build_mesh(device=self.device)
        else:
            return None
        print(f"mesh: {mesh.shape}, rank {mesh.rank}")
        return mesh

    def _load_models(self):
        from specdec_tpu_torch.engine.model_loader import load_models

        self.mesh = self._build_mesh()

        target_path = self.target_model_arg or os.getenv(
            "TARGET_MODEL", "synthetic:llama-1b")
        drafter_path = self.drafter_model_arg or os.getenv(
            "DRAFTER_MODEL", "synthetic:llama-70m")
        if self.inference_method_name == "ngram":
            drafter_path = None

        bundle = load_models(target_path, drafter_path, dtype=self.dtype,
                             quantization=self.quantization,
                             kv_quant=self.kv_quant, device=self.device,
                             mesh=self.mesh)
        self.target_cfg = bundle["target"]["cfg"]
        self.target_params = bundle["target"]["params"]
        if bundle["drafter"] is not None:
            self.drafter_cfg = bundle["drafter"]["cfg"]
            self.drafter_params = bundle["drafter"]["params"]
        else:
            self.drafter_cfg = self.drafter_params = None
        # an EAGLE drafter (DRAFTER_MODEL=eagle:<depth>) sends the
        # speculative method through engine/eagle_batch.py
        self.eagle_drafter = bool((bundle["drafter"] or {}).get("eagle"))
        self.tokenizer = bundle["tokenizer"]
        self.end_tokens = bundle["end_tokens"]
        self.pad_token_id = bundle["pad_token_id"]

        if self.inference_method_name == "ngram":
            n = int(os.getenv("NGRAM_N", "3"))
            if os.getenv("NGRAM_DEVICE", "false").lower() == "true":
                # the device-resident table, carried across requests
                from specdec_tpu_torch.ngram import init_device_table
                self.ngram = init_device_table(
                    n, int(os.getenv("NGRAM_DEVICE_CAPACITY", str(1 << 16))),
                    self.device)
            else:
                from specdec_tpu_torch.ngram import NGramStorage
                self.ngram = NGramStorage(
                    n=n, vocab_size=self.target_cfg.vocab_size)

    # ------------------------------------------------------------------ data
    def _load_sharegpt_data(self):
        try:
            parts = load_sharegpt_multi(
                self.sharegpt_paths, max_lines=self.max_load_lines,
                min_len=self.prompt_min_length, max_len=self.prompt_max_length)
            self.sharegpt_parts = parts
            flat = [p for part in parts for p in part]
            self.sharegpt_data = flat or None
            print(f"loaded {len(flat)} prompts from ShareGPT")
        except Exception as e:
            print(f"error loading ShareGPT data: {e}")
            self.sharegpt_parts = []
            self.sharegpt_data = None

    def _get_random_prompt(self):
        if not self.sharegpt_data:
            return "Tell me a story about artificial intelligence."
        non_empty = [p for p in self.sharegpt_parts if p]
        if non_empty:
            return random.choice(random.choice(non_empty))
        return random.choice(self.sharegpt_data)

    # --------------------------------------------------------------- rng hooks
    def set_request_index(self, idx: int):
        self._request_index = idx
        random.seed(self.base_seed + idx)

    def request_generator(self) -> torch.Generator:
        """The current request's generator on the runner's device: seeded
        from BENCH_SEED and the request index, distinct per request and
        reproducible."""
        return torch.Generator(device=self.device).manual_seed(
            self.base_seed * 1_000_003 + self._request_index)

    # ------------------------------------------------------------------- run
    def _run_benchmark(self):
        if self.num_prompts <= 0 and (self.auto_duration <= 0 or
                                      self.auto_rate <= 0):
            print("invalid benchmark parameters: AUTO_DURATION and AUTO_RATE "
                  "must be > 0 when NUM_PROMPTS=0")
            return

        print("\nStarting Benchmark")
        if self.num_prompts > 0:
            print(f"  Total Prompts: {self.num_prompts}")
        else:
            print(f"  Rate: {self.auto_rate:.2f} prompts/s for "
                  f"{self.auto_duration:.1f}s")
        print(f"  Batch mode: {self.enable_batch} (size {self.batch_size})")
        print(f"  Method: {self.inference_method_name}  gamma={self.gamma}  "
              f"gen_len={self.gen_len}  quant={self.quantization}")
        print("=" * 70)

        method = self.inference_method_name
        if self.spec:
            spec_results = BenchmarkResults(
                method="speculative" if method != "ngram" else "ngram")
            target_results = None
        else:
            spec_results = None
            target_results = BenchmarkResults(method="target_ar")

        monitor = None
        if self.enable_monitor:
            def perf_callback():
                res = spec_results or target_results
                total = res.total_tokens if res else 0
                acc = 0
                if spec_results and spec_results.avg_acceptance_rate > 0:
                    acc = int(total * spec_results.avg_acceptance_rate)
                return {"total_tokens": total, "accepted_tokens": acc}

            try:
                monitor = TelemetryMonitor(interval_s=self.monitor_interval,
                                           perf_callback=perf_callback)
                monitor.start()
            except Exception as e:
                print(f"warning: could not start telemetry monitor: {e}")

        start = time.time()
        for res in (spec_results, target_results):
            if res is not None:
                res.start_time = start

        execute_benchmark_loop(self, spec_results, target_results)

        monitor_results = monitor.stop() if monitor else None

        for res in (spec_results, target_results):
            if res is not None:
                res.end_time = time.time()
                res.total_batches = len(res.batches)

        print("\n" + "=" * 70)
        print("Benchmark Complete")
        combined = {}
        method_results = spec_results or target_results
        if spec_results:
            print_benchmark_summary(spec_results)
            combined[spec_results.method] = spec_results.to_dict()
        if target_results:
            print_benchmark_summary(target_results)
            combined["target_ar"] = target_results.to_dict()
        if monitor_results:
            print_power_summary(monitor_results)
            if self.mesh is None or self.mesh.rank == 0:
                monitor_results.save_json(
                    self._suffixed(self.base_output_file, "gpu"))
            combined["gpu_monitoring"] = monitor_results.to_dict()

        if self.mesh is not None and self.mesh.rank != 0:
            combined = method_results = None  # rank 0 writes the files
        if method_results:
            with open(self.output_file, "w") as f:
                json.dump(method_results.to_dict(), f, indent=2)
        if combined:
            with open(self.base_output_file, "w") as f:
                json.dump(combined, f, indent=2)
            print(f"results saved to {self.base_output_file} "
                  f"(+ {self.output_file})")
        self.spec_results = spec_results
        self.target_results = target_results
        self.monitor_results = monitor_results
