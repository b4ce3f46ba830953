"""The port's batched EAGLE engine, its EAGLE serving batcher and the batch
inference front end's EAGLE branch against the JAX package's, on the same
params (the untrained head of ``init_eagle_params``).

Greedy chain EAGLE's tokens depend on the acceptance draws (see
tests/test_torch_eagle.py), so where the port must give JAX's tokens and
acceptance it takes JAX's draws: ``eagle_batch._accept_uniforms`` is
patched to return, window by window, the uniforms JAX's key schedule
gives. Where outputs must not depend on how windows are scheduled
(windows per sync, batch against serving against AR), the processor is
greedy at temperature 1e-4, where the draws do not matter. Sampled first
tokens are held to the target distribution by JAX's batch TV bound (0.12,
tests/test_eagle_batch.py)."""
import dataclasses
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import eagle as je
from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.engine import eagle_batch as jeb
from specdec_tpu.engine import infer_engine as jie
from specdec_tpu.sampling import processors as jp
from specdec_tpu.serve import EagleContinuousBatcher as JaxEagleBatcher

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.engine import eagle_batch as teb
from specdec_tpu_torch.engine import infer_engine as tie
from specdec_tpu_torch.sampling import eagle_speculative as tes
from specdec_tpu_torch.sampling import processors as tp
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.serve import EagleContinuousBatcher

torch.set_num_threads(2)

VOCAB = 32
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8)
JECFG = JCFG.replace(num_layers=1)
PROMPTS = [
    [3, 14, 15, 9, 2, 6],
    [1, 1, 2, 3, 5, 8, 13, 21],
    [27, 4, 11],
    [9, 9, 9, 1, 2],
]
GAMMA, GEN = 3, 16
LOW_T = 1e-4


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


CFG, ECFG = port_config(JCFG), port_config(JECFG)


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX head, port target, port head)."""
    target = jax.tree.map(np.asarray,
                          jm.init_params(JCFG, jax.random.key(0), scale=0.4))
    head = jax.tree.map(np.asarray,
                        je.init_eagle_params(JECFG, jax.random.key(1)))
    return (jax.tree.map(jnp.asarray, target), jax.tree.map(jnp.asarray, head),
            params_from_numpy(target, "cpu"), params_from_numpy(head, "cpu"))


def uniforms(key, shape):
    """JAX's acceptance draws of a batched window run with ``key``."""
    return np.array(jax.random.uniform(jax.random.split(key, 3)[1], shape))


def batch_window_keys(key):
    """The window keys of JAX's ``batch_eagle_generate``: the first window
    alone, then fused chunks of 8."""
    yield jax.random.fold_in(key, 1)
    r = 0
    while True:
        chunk = jax.random.fold_in(key, 1000 + r)
        for i in range(8):
            yield jax.random.fold_in(chunk, i)
        r += 1


def batch_draws(key, B):
    """JAX's batched draws, window by window: [B, gamma] arrays."""
    keys = batch_window_keys(key)
    return (uniforms(k, (B, GAMMA)) for k in keys)


def feed(draws):
    """An ``_accept_uniforms`` that returns ``draws`` in turn."""
    def draw(shape, generator, device):
        return torch.from_numpy(next(draws).copy()).reshape(shape)
    return draw


def test_batch_eagle_matches_jax_and_single(models, monkeypatch):
    """Ragged prompts: tokens and acceptance equal JAX's; each row equals
    single-sequence ``eagle_generate`` given that row's draws."""
    jt, jh, tt, th = models
    key = jax.random.key(5)
    ref, ref_rates = jeb.batch_eagle_generate(
        PROMPTS, JECFG, jh, JCFG, jt, gamma=GAMMA, gen_len=GEN,
        eos_tokens_id=(), key=key)
    monkeypatch.setattr(teb, "_accept_uniforms",
                        feed(batch_draws(key, len(PROMPTS))))
    got, rates = teb.batch_eagle_generate(
        PROMPTS, ECFG, th, CFG, tt, gamma=GAMMA, gen_len=GEN,
        eos_tokens_id=(), device="cpu")
    assert got == ref and rates == ref_rates
    assert all(len(o) == GEN for o in got) and 0.0 < np.mean(rates) < 1.0
    for b, prompt in enumerate(PROMPTS):
        row = (d[b] for d in batch_draws(key, len(PROMPTS)))
        monkeypatch.setattr(tes, "_accept_uniforms", feed(row))
        single, rate = tes.eagle_generate(
            prompt, ECFG, th, CFG, tt, gamma=GAMMA, max_gen_len=GEN,
            eos_tokens_id=(), device="cpu")
        assert single == got[b] and rate == rates[b], f"row {b}"


def test_batch_eagle_eos_per_row(models, monkeypatch):
    """An EOS taken from row 1's output truncates each row at its first
    EOS, as JAX's engine does, and leaves rows without it at full
    length."""
    jt, jh, tt, th = models
    key = jax.random.key(8)
    full, _ = jeb.batch_eagle_generate(
        PROMPTS, JECFG, jh, JCFG, jt, gamma=GAMMA, gen_len=GEN,
        eos_tokens_id=(), key=key)
    eos = full[1][4]
    ref, _ = jeb.batch_eagle_generate(
        PROMPTS, JECFG, jh, JCFG, jt, gamma=GAMMA, gen_len=GEN,
        eos_tokens_id=eos, key=key)
    monkeypatch.setattr(teb, "_accept_uniforms",
                        feed(batch_draws(key, len(PROMPTS))))
    got, _ = teb.batch_eagle_generate(
        PROMPTS, ECFG, th, CFG, tt, gamma=GAMMA, gen_len=GEN,
        eos_tokens_id=eos, device="cpu")
    assert got == ref
    for b in range(len(PROMPTS)):
        want = (full[b][:full[b].index(eos) + 1] if eos in full[b]
                else full[b])
        assert got[b] == want, f"row {b}"


def test_batch_eagle_first_token_distribution(models):
    """The first token of every row, through the whole-batch accept /
    residual step, follows the target's processed distribution."""
    _, _, tt, th = models
    proc = tp.MultinomialProcessor(temperature=1.0)
    B = 1000
    outs, _ = teb.batch_eagle_generate(
        [PROMPTS[0]] * B, ECFG, th, CFG, tt, gamma=GAMMA, gen_len=1,
        logits_processor=proc, eos_tokens_id=(), first_target=False,
        generator=torch.Generator().manual_seed(9), device="cpu")
    counts = np.bincount([o[0] for o in outs], minlength=VOCAB) / B
    p = proc(tm.forward_full(CFG, tt, torch.tensor([PROMPTS[0]]))[0, -1])
    tv = 0.5 * np.abs(counts - p.numpy()).sum()
    assert tv < 0.12, f"TV distance {tv:.4f}"


class KeyedBatcher(EagleContinuousBatcher):
    """The port's batcher counting admissions and window steps as JAX's
    ``_next_key`` does, so that ``draw`` can give each window JAX's
    draws."""

    def __init__(self, key, *args, **kw):
        super().__init__(*args, **kw)
        self.key, self.ctr, self.win = key, 0, 0

    def _admit(self, slot, req, sync=True):
        self.ctr += 1
        super()._admit(slot, req, sync)

    def _window_step(self):
        self.ctr += 1
        self.win = 0
        super()._window_step()

    def draw(self, shape, generator, device):
        k = jax.random.fold_in(jax.random.fold_in(self.key, self.ctr),
                               self.win)
        self.win += 1
        return torch.from_numpy(uniforms(k, shape))


def serve(batcher):
    ids = [batcher.submit(p) for p in PROMPTS]
    done = batcher.run()
    return ([done[i].output_ids for i in ids],
            [done[i].metrics.acceptance_rate for i in ids])


@pytest.mark.parametrize("wps", [1, 4])
def test_eagle_batcher_matches_jax(models, monkeypatch, wps):
    """Four requests on two slots (slots reused), greedy at temperature 1:
    each request's tokens and acceptance equal JAX's batcher's."""
    jt, jh, tt, th = models
    key = jax.random.key(7)
    kw = dict(num_slots=2, gamma=GAMMA, max_prompt_len=64,
              max_new_tokens=GEN, eos_tokens_id=(), windows_per_sync=wps)
    ref = serve(JaxEagleBatcher(JECFG, jh, JCFG, jt, key=key, **kw))
    b = KeyedBatcher(key, ECFG, th, CFG, tt, device="cpu", **kw)
    monkeypatch.setattr(teb, "_accept_uniforms", b.draw)
    got = serve(b)
    assert got == ref
    assert all(len(o) == GEN for o in got[0])


def test_eagle_batcher_windows_per_sync_and_engines_agree(models):
    """Greedy at temperature 1e-4: 1 and 4 windows per sync give the same
    tokens, equal to the batch engine's, greedy AR's and JAX's batcher's
    for every request."""
    jt, jh, tt, th = models
    kw = dict(num_slots=2, gamma=GAMMA, max_prompt_len=64,
              max_new_tokens=GEN, eos_tokens_id=())
    outs = {wps: serve(EagleContinuousBatcher(
        ECFG, th, CFG, tt, windows_per_sync=wps, device="cpu",
        logits_processor=tp.GreedyProcessor(temperature=LOW_T), **kw))[0]
        for wps in (1, 4)}
    ref = serve(JaxEagleBatcher(
        JECFG, jh, JCFG, jt, key=jax.random.key(3),
        logits_processor=jp.GreedyProcessor(temperature=LOW_T), **kw))[0]
    engine, rates = teb.batch_eagle_generate(
        PROMPTS, ECFG, th, CFG, tt, gamma=GAMMA, gen_len=GEN,
        logits_processor=tp.GreedyProcessor(temperature=LOW_T),
        eos_tokens_id=(), device="cpu")
    ar = [autoregressive_generate(p, CFG, tt, max_gen_len=GEN,
                                  eos_tokens_id=(), device="cpu")
          for p in PROMPTS]
    assert outs[1] == outs[4] == ref == engine == ar
    assert 0.0 < np.mean(rates) < 1.0


def test_eagle_slot_reuse_zeroes_drafter_cache(models):
    """Admission into a reused slot leaves none of the previous request's
    drafter K/V: after one window of a long prompt, every EAGLE-cache row
    below the catch-up's start is zero (JAX's
    test_eagle_slot_reuse_zeroes_drafter_cache)."""
    _, _, tt, th = models
    cb = EagleContinuousBatcher(ECFG, th, CFG, tt, num_slots=1, gamma=3,
                                max_prompt_len=64, max_new_tokens=8,
                                eos_tokens_id=(), device="cpu")
    cb.submit(PROMPTS[1])
    cb.run()
    assert float(cb.state.e_cache.k[:, 0].abs().max()) > 0
    long_prompt = [(7 * i + 3) % VOCAB for i in range(30)]
    cb.submit(long_prompt)
    cb.step()  # the admission, then one window
    pos = int(cb.state.pos[0])
    start = max(pos - 1 - (cb.gamma + 1), 0)
    assert start >= 20, "the catch-up must start past the short request"
    stale = cb.state.e_cache.k[:, 0, :len(long_prompt) - cb.gamma - 2]
    assert float(stale.abs().max()) == 0.0, "stale drafter K/V leaked"


class FakeTokenizer:
    """Characters to token ids (a - z -> 1 - 26, others 27)."""

    chat_template = None

    def encode(self, text):
        return [ord(c) - 96 if c.isalpha() else 27 for c in text.lower()]


def test_infer_batch_dispatches_eagle(models):
    """``infer_batch`` with ``eagle_drafter`` set runs the batched EAGLE
    engine on the head, as the JAX front end does: per-request tokens and
    acceptance equal JAX's (greedy at temperature 1e-4)."""
    jt, jh, tt, th = models
    common = dict(tokenizer=FakeTokenizer(), max_batch_length=16,
                  chat=False, reset_in_between=False, spec=True,
                  target_gen=False, gamma=GAMMA, filler_top_k=3, gen_len=12,
                  end_tokens=(), pad_token_id=0, ngram=None,
                  eagle_drafter=True)
    jctx = types.SimpleNamespace(
        **common, target_cfg=JCFG, target_params=jt, drafter_cfg=JECFG,
        drafter_params=jh,
        processor=jp.GreedyProcessor(temperature=LOW_T),
        request_key=lambda: jax.random.key(0))
    ctx = types.SimpleNamespace(
        **common, target_cfg=CFG, target_params=tt, drafter_cfg=ECFG,
        drafter_params=th, processor=tp.GreedyProcessor(temperature=LOW_T),
        device="cpu", request_generator=lambda: torch.Generator())
    texts = ["the cat sat", "abc abc abc", "hello"]
    got, none = tie.infer_batch(ctx, texts)
    ref, _ = jie.infer_batch(jctx, texts)
    assert none is None and got is not None
    assert [(r.generated_tokens, r.acceptance_rate) for r in got.requests] \
        == [(r.generated_tokens, r.acceptance_rate) for r in ref.requests]
    assert all(r.generated_tokens == 12 for r in got.requests)
