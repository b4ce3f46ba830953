"""Colored debug visualization of decode steps (counterpart of
``specdec_tpu/utils/printing.py``, pure Python, copied; ref:
utils/printing.py:20-49).

Works from host-side token arrays after a window completes (the device loop
never syncs per token), coloring accepted drafts green, rejected red, and
resampled tokens blue.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

_GREEN = "\033[92m"
_RED = "\033[91m"
_BLUE = "\033[94m"
_END = "\033[0m"


def _decode(tokenizer, ids: Sequence[int]) -> str:
    if tokenizer is None:
        return " ".join(str(int(t)) for t in ids)
    return tokenizer.decode(list(ids), skip_special_tokens=False)


def initial_step(token: int, tokenizer=None):
    print(f"{_BLUE}{_decode(tokenizer, [token])}{_END}", end=" ")


def end_token_found(location: int):
    print(f"\n{_RED}[EOS] found at draft position {location}{_END}")


def speculative_step(tokenizer, drafts: Sequence[int], n_accepted: int,
                     resampled: Optional[int]):
    """Visualize one window: green accepted prefix, red rejected tail,
    blue resampled/bonus token."""
    acc = _decode(tokenizer, drafts[:n_accepted])
    rej = _decode(tokenizer, drafts[n_accepted:])
    parts = []
    if acc:
        parts.append(f"{_GREEN}{acc}{_END}")
    if rej:
        parts.append(f"{_RED}{rej}{_END}")
    if resampled is not None:
        parts.append(f"{_BLUE}{_decode(tokenizer, [resampled])}{_END}")
    print(" ".join(parts))


def beam_search_step(scores: Sequence[float], sequences: List[Sequence[int]],
                     step: int, tokenizer=None):
    print(f"--- beam step {step} ---")
    for s, seq in zip(scores, sequences):
        print(f"  {s:10.4f}  {_decode(tokenizer, seq)}")
