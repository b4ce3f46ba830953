"""Batch inference entry with metrics collection (counterpart of
``specdec_tpu/engine/infer_engine.py``).

``infer_batch`` tokenizes a batch of prompts (chat template where the
tokenizer has one), runs it through the method the context configures and
returns per-request ``RequestMetrics`` in a ``BatchMetrics``: NASD with a
host store (``ngram/assisted.py``) or with the device table
(``ngram/device_assisted.py``), model-drafted speculative decoding
(``engine/batch_engine.py``), EAGLE-drafted decoding
(``engine/eagle_batch.py``, where ``ctx.eagle_drafter`` is set and the
drafter is an EAGLE head) or the target alone. A failed batch prints its
traceback and returns None metrics, as the reference does.

The context ``ctx`` is the JAX package's benchmark runner's, with the port's
generator in place of its key: ``tokenizer``, ``max_batch_length``,
``chat``, ``reset_in_between``, ``ngram`` (None, an ``INgramStorage`` or a
``DeviceNGramTable``), ``spec``, ``target_gen``, ``target_cfg``,
``target_params``, ``drafter_cfg``, ``drafter_params``, ``eagle_drafter``
(optional), ``gamma``, ``filler_top_k``, ``processor``, ``gen_len``,
``end_tokens``, ``pad_token_id``, ``device`` and ``request_generator()``,
which returns the ``torch.Generator`` of the current request.
"""
from __future__ import annotations

import time
import traceback
from typing import List, Optional, Tuple

from specdec_tpu_torch.engine.batch_engine import (
    batch_autoregressive_generate, batch_speculative_generate,
)
from specdec_tpu_torch.engine.eagle_batch import batch_eagle_generate
from specdec_tpu_torch.engine.metrics import BatchMetrics, RequestMetrics
from specdec_tpu_torch.ngram import (
    DeviceNGramTable, batch_ngram_assisted_generate,
    device_ngram_assisted_generate_batch, init_device_table,
)


def tokenize_batch(tokenizer, prompts: List[str], max_length: int,
                   chat: bool = True) -> List[List[int]]:
    """Chat-template and tokenize each prompt (padding happens later,
    inside the engine, which masks pads)."""
    ids = []
    for p in prompts:
        if chat and getattr(tokenizer, "chat_template", None):
            text = tokenizer.apply_chat_template(
                [{"role": "user", "content": p}],
                add_generation_prompt=True, tokenize=False)
        else:
            text = p
        toks = tokenizer.encode(text)
        ids.append([int(t) for t in toks][:max_length])
    return ids


def infer_batch(ctx, prompts: List[str]) -> Tuple[Optional[BatchMetrics],
                                                  Optional[BatchMetrics]]:
    """Run one batch through the configured method; returns
    (spec_metrics, target_metrics), at most one of them not None."""
    prompt_ids = tokenize_batch(ctx.tokenizer, prompts, ctx.max_batch_length,
                                chat=ctx.chat)
    if ctx.reset_in_between and ctx.ngram is not None:
        if isinstance(ctx.ngram, DeviceNGramTable):
            ctx.ngram = init_device_table(ctx.ngram.orders[0],
                                          ctx.ngram.capacity, ctx.device)
        else:
            ctx.ngram.reset()

    if ctx.spec:
        return _run_spec(ctx, prompt_ids), None
    if ctx.target_gen:
        return None, _run_target(ctx, prompt_ids)
    return None, None


def _collect(batch_metrics: BatchMetrics, prompt_ids, outputs, rates,
             start_times, first_token_times):
    for i, out in enumerate(outputs):
        r = RequestMetrics()
        r.start_time = start_times[i]
        r.prompt_tokens = len(prompt_ids[i])
        r.generated_tokens = len(out)
        r.total_tokens = r.prompt_tokens + r.generated_tokens
        r.end_time = batch_metrics.batch_end_time
        if rates is not None:
            r.acceptance_rate = rates[i]
        if first_token_times[i] is not None:
            r.first_token_time = first_token_times[i]
            r.ttft = first_token_times[i] - start_times[i]
        else:
            r.ttft = (batch_metrics.batch_end_time - start_times[i]) / \
                max(r.generated_tokens, 1)
        r.total_latency = batch_metrics.batch_end_time - start_times[i]
        batch_metrics.requests.append(r)


def _start(prompt_ids):
    """A new BatchMetrics, the requests' start times, their first-token
    times (None until stamped) and the callback that stamps them."""
    bm = BatchMetrics(batch_size=len(prompt_ids))
    bm.batch_start_time = time.time()
    start_times = [bm.batch_start_time] * len(prompt_ids)
    first_token_times: List[Optional[float]] = [None] * len(prompt_ids)

    def on_first_token(i):
        if first_token_times[i] is None:
            first_token_times[i] = time.time()

    return bm, start_times, first_token_times, on_first_token


def _run_spec(ctx, prompt_ids) -> Optional[BatchMetrics]:
    bm, start_times, first_token_times, on_first_token = _start(prompt_ids)
    common = dict(gamma=ctx.gamma, logits_processor=ctx.processor,
                  gen_len=ctx.gen_len, eos_tokens_id=ctx.end_tokens,
                  pad_token_id=ctx.pad_token_id,
                  generator=ctx.request_generator(), device=ctx.device)
    try:
        if isinstance(ctx.ngram, DeviceNGramTable):
            # device NASD: the accumulated table is carried across
            # requests like the host store. Its loop has no per-window
            # callback, so first_token_times stay unset and _collect's
            # per-token estimate applies
            outputs, rates, ctx.ngram = device_ngram_assisted_generate_batch(
                prompt_ids, ctx.target_cfg, ctx.target_params,
                table=ctx.ngram, filler_top_k=ctx.filler_top_k, **common)
        elif ctx.ngram is not None:
            # host NASD: drafts per sequence from the shared store, one
            # verify per window for the whole batch
            outputs, rates = batch_ngram_assisted_generate(
                prompt_ids, ctx.ngram, ctx.target_cfg, ctx.target_params,
                filler_top_k=ctx.filler_top_k,
                first_token_callback=on_first_token, **common)
        elif getattr(ctx, "eagle_drafter", False):
            # the EAGLE feature-predictor drafter: whole-batch
            # feature-drafted windows
            outputs, rates = batch_eagle_generate(
                prompt_ids, ctx.drafter_cfg, ctx.drafter_params,
                ctx.target_cfg, ctx.target_params,
                first_token_callback=on_first_token, **common)
        else:
            outputs, rates = batch_speculative_generate(
                prompt_ids, ctx.drafter_cfg, ctx.drafter_params,
                ctx.target_cfg, ctx.target_params,
                first_token_callback=on_first_token, **common)
        bm.batch_end_time = time.time()
        _collect(bm, prompt_ids, outputs, rates, start_times,
                 first_token_times)
        return bm
    except Exception as e:
        print(f"batch speculative decoding failed: {e}")
        traceback.print_exc()
        return None


def _run_target(ctx, prompt_ids) -> Optional[BatchMetrics]:
    bm, start_times, first_token_times, on_first_token = _start(prompt_ids)
    try:
        outputs = batch_autoregressive_generate(
            prompt_ids, ctx.target_cfg, ctx.target_params,
            gen_len=ctx.gen_len, logits_processor=ctx.processor,
            eos_tokens_id=ctx.end_tokens, pad_token_id=ctx.pad_token_id,
            generator=ctx.request_generator(),
            first_token_callback=on_first_token, device=ctx.device)
        bm.batch_end_time = time.time()
        _collect(bm, prompt_ids, outputs, None, start_times,
                 first_token_times)
        return bm
    except Exception as e:
        print(f"batch target generation failed: {e}")
        traceback.print_exc()
        return None
