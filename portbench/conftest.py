"""Fixtures of the benchmark's CPU tests: a checkout-shaped directory
that holds the benchmark's files plus one tiny configuration, one tiny
mix, one tiny cell and, where asked, one extra metric, all added as new
files and entries without editing an existing file."""
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# the CPU rehearsals' steps must fit their slices when tests run side by
# side: a few threads each, not every core each
torch.set_num_threads(2)

# tiny widths of each family (the 4-bit kernels' K: multiples of 256)
TINY = {
    "qwen3": ("qwen3-8b-ls8.json",
              dict(hidden_size=256, intermediate_size=512,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                   num_hidden_layers=3, vocab_size=1024)),
    "gpt_neox": ("pythia-6.9b-ls8.json",
                 dict(hidden_size=256, intermediate_size=1024,
                      num_attention_heads=4, num_hidden_layers=3,
                      vocab_size=512)),
}

ARRIVALS = {"poisson": {"kind": "poisson", "rate_per_s": 6.0,
                        "preroll_s": 1.0},
            "backlog": {"kind": "backlog", "requests": 64}}


def tiny_config(family: str) -> dict:
    name, widths = TINY[family]
    cfg = json.loads((ROOT / "portbench" / "configs" / name).read_text())
    cfg.update(widths)
    cfg["drafter"]["exit_layer"] = 1
    # logits of about the published models' spread at these widths
    cfg["weights"]["init_scale"] = 0.08
    # between the tiny readings over 8 seeds: program 0-0.044, the float8
    # control 0.45-0.84
    cfg["check"]["max_logit_gap"] = 0.2
    return cfg


def tiny_mix(arrivals: str) -> dict:
    return {"arrivals": dict(ARRIVALS[arrivals]),
            "prompt_len": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                           "min": 4, "max": 48},
            "output_len": {"dist": "uniform", "min": 6, "max": 20},
            "block": 8,
            "engine": {"num_slots": 4, "gamma": 3, "windows_per_sync": 2,
                       "max_prompt_len": 48, "max_new_tokens": 20}}


def make_root(tmp: Path, family: str = "qwen3", arrivals: str = "poisson",
              metric: str = None) -> Path:
    """A copy of the benchmark with the tiny cell ``tiny.<arrivals>`` added
    (and, given ``metric`` source, ``metrics/tiny_metric.py`` listed as a
    per-layer metric of it)."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(tiny_config(family)))
    (tmp / "portbench" / "traffic" / f"tiny_{arrivals}.json").write_text(
        json.dumps(tiny_mix(arrivals)))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = f"tiny.{arrivals}"
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": "tiny",
                              "traffic": f"tiny_{arrivals}", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    if metric is not None:
        (tmp / "portbench" / "metrics" / "tiny_metric.py").write_text(metric)
        spec["per_layer"].append({
            "name": "tiny_metric", "unit": "%", "better": "higher",
            "source": "program_counter", "layer": "serving engine",
            "moves": "out_tok_s", "workloads": [cell]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return lambda **kw: make_root(tmp_path, **kw)
