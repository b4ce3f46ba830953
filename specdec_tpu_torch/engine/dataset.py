"""ShareGPT prompt loading (counterpart of ``specdec_tpu/engine/dataset.py``,
pure Python, copied; ref: engine/dataset.py:6-45).

Same filtering semantics: keep ``conversations[].from == "human"`` turns whose
character length lies in [min_len, max_len], reading at most ``max_lines``
JSONL lines per file; multi-file variant returns one list per path (missing
files yield empty lists) for proportional sampling.
"""
from __future__ import annotations

import json
import random
from typing import List, Optional, Sequence


def load_sharegpt_prompts(path: str, max_lines: int = 10000, min_len: int = 10,
                          max_len: int = 500) -> List[str]:
    prompts: List[str] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                if i >= max_lines:
                    break
                try:
                    data = json.loads(line.strip())
                except json.JSONDecodeError:
                    continue
                conv = data.get("conversations")
                if not conv:
                    continue
                for turn in conv:
                    if turn.get("from") == "human" and turn.get("value"):
                        text = turn["value"].strip()
                        if min_len <= len(text) <= max_len:
                            prompts.append(text)
        print(f"loaded {len(prompts)} prompts from {path}")
    except FileNotFoundError:
        print(f"ShareGPT file not found: {path}")
    return prompts


def load_sharegpt_multi(paths: Sequence[str], max_lines: int = 10000,
                        min_len: int = 10, max_len: int = 500) -> List[List[str]]:
    return [load_sharegpt_prompts(p, max_lines=max_lines, min_len=min_len,
                                  max_len=max_len) for p in paths]


FALLBACK_PROMPT = "Tell me a story about a robot learning to paint."


def random_prompt(prompt_lists: Sequence[Sequence[str]],
                  rng: Optional[random.Random] = None) -> str:
    """Uniform over non-empty files, then uniform within the file, with a
    hardcoded fallback (ref: engine/benchmark_runner.py:152-162)."""
    rng = rng or random
    non_empty = [pl for pl in prompt_lists if pl]
    if not non_empty:
        return FALLBACK_PROMPT
    return rng.choice(rng.choice(non_empty))
