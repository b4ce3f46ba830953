"""Autoregressive baseline generation
(counterpart of ``specdec_tpu/sampling/base_decoding.py::autoregressive_generate``).

The JAX version is one jitted ``lax.while_loop``; here the loop is eager
Python over device tensors. Tokens stay on the device: the loop reads the
host only once per token when an EOS set is given (to stop), and otherwise
only once, at the end.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step
from specdec_tpu_torch.sampling.processors import GreedyProcessor, LogitsProcessor
from specdec_tpu_torch.sampling.utils import eos_mask, normalize_eos, pad_to_bucket


def autoregressive_generate(
    inputs: Sequence[int],
    cfg: ModelConfig,
    params,
    max_gen_len: int = 40,
    logits_processor: Optional[LogitsProcessor] = None,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    use_cache: bool = True,  # API parity; the slotted cache is always used
    debug: bool = False,
    device=None,
) -> List[int]:
    """Generate from the target alone. ``generator`` (or a new one seeded
    with ``seed``) drives sampling; ``device=None`` means the card.

    One forward per generated token: the prompt's prefill yields token 1,
    and the forward after the last token is skipped (its logits would be
    unused)."""
    del use_cache, debug
    device = resolve_device(device)
    processor = logits_processor or GreedyProcessor()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    eos_ids = normalize_eos(eos_tokens_id)
    prompt, n = pad_to_bucket(inputs, pad_token_id)
    prompt = prompt.to(device)
    P = prompt.shape[0]
    S = P + max_gen_len
    buf = torch.zeros((S,), dtype=torch.int64, device=device)
    buf[:P] = prompt

    cache = init_cache(cfg, 1, S, device=device)
    logits, cache = forward_step(cfg, params, prompt[None, :], cache)
    cache = cache.with_length(torch.full((1,), n, dtype=torch.int32,
                                         device=device))
    last_logits = logits[0, n - 1]
    total_len = min(cfg.max_position_embeddings, n + max_gen_len)

    pos = n
    while pos < total_len:
        tok = processor.sample_from_logits(last_logits, generator)
        buf[pos] = tok
        pos += 1
        if eos_ids and bool(eos_mask(tok, eos_ids)):
            break
        if pos >= total_len:
            break
        logits, cache = forward_step(cfg, params, tok.reshape(1, 1), cache)
        last_logits = logits[0, 0]
    return buf[n:pos].tolist()
