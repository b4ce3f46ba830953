"""The port's beam search against the JAX package's: the four checks of
tests/test_beam_search.py on the port (one beam of one expansion is greedy
AR; deterministic and bounded; EOS or pad stops; a wider beam never
scores worse), its output equal to JAX's on the same float32 params, and
the cache row gather that reorders beams carrying int8 scales."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.sampling.base_decoding import (
    beam_search_generate as jax_beam_search_generate,
)

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_full
from specdec_tpu_torch.sampling.base_decoding import (
    autoregressive_generate, beam_search_generate,
)

torch.set_num_threads(2)

VOCAB = 32
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=32,
                   intermediate_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8)
CFG = ModelConfig(**{**{f.name: getattr(JCFG, f.name)
                        for f in dataclasses.fields(JCFG)},
                     "dtype": torch.float32})
PROMPT = [3, 14, 15, 9, 2, 6]
BEAM = dict(eos_tokens_id=(), device="cpu")


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params) of the same numpy arrays."""
    np_params = jax.tree.map(
        np.asarray, jm.init_params(JCFG, jax.random.key(0), scale=0.4))
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu"))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_beam1_top1_equals_greedy(models, kv_quant):
    """Also over the int8 cache, whose scales the reordering carries."""
    cfg = CFG.replace(kv_quant=kv_quant)
    params = models[1]
    ar = autoregressive_generate(PROMPT, cfg, params, max_gen_len=15, **BEAM)
    beam = beam_search_generate(PROMPT, cfg, params, max_gen_len=15,
                                num_beams=1, top_k=1, **BEAM)
    # beam search also stops on pad_token_id: compare up to that
    if 0 in ar:
        ar = ar[:ar.index(0) + 1]
    assert beam == ar


def test_beam_search_deterministic_and_bounded(models):
    params = models[1]
    out1 = beam_search_generate(PROMPT, CFG, params, max_gen_len=12,
                                num_beams=4, top_k=3, **BEAM)
    out2 = beam_search_generate(PROMPT, CFG, params, max_gen_len=12,
                                num_beams=4, top_k=3, **BEAM)
    assert out1 == out2
    assert 1 <= len(out1) <= 12
    assert all(0 <= t < VOCAB for t in out1)


def score(params, tokens, prompt, alpha=1.2, min_length=5.0):
    """The reference score of a finished sequence: (1 + sum of log-probs)
    / length penalty."""
    logits = forward_full(CFG, params, torch.tensor([list(prompt) + tokens]))
    logp = torch.log_softmax(logits[0], dim=-1)
    s = 1.0 + sum(float(logp[len(prompt) + i - 1, t])
                  for i, t in enumerate(tokens))
    return s / ((min_length + len(tokens)) / (min_length + 1.0)) ** alpha


def test_wider_beam_never_scores_worse(models):
    params = models[1]
    n1 = beam_search_generate(PROMPT, CFG, params, max_gen_len=10,
                              num_beams=1, top_k=1, **BEAM)
    n4 = beam_search_generate(PROMPT, CFG, params, max_gen_len=10,
                              num_beams=4, top_k=4, **BEAM)
    # comparable only when both ran to the cap (the same length penalty)
    if len(n1) == len(n4):
        assert score(params, n4, PROMPT) >= score(params, n1, PROMPT) - 1e-5


def test_beam_eos_stops(models):
    params = models[1]
    free = beam_search_generate(PROMPT, CFG, params, max_gen_len=12,
                                num_beams=3, top_k=3, **BEAM)
    eos = free[2]
    out = beam_search_generate(PROMPT, CFG, params, max_gen_len=12,
                               num_beams=3, top_k=3, eos_tokens_id=eos,
                               device="cpu")
    if eos in out:
        assert out.index(eos) == len(out) - 1
    assert len(out) <= 12


@pytest.mark.parametrize("beams,top_k", [(1, 1), (4, 3)])
@pytest.mark.parametrize("prompt", [PROMPT, [7, 7, 1, 30, 22, 5, 5, 9, 12]],
                         ids=["p0", "p1"])
def test_beam_search_equals_jax(models, prompt, beams, top_k):
    jparams, params = models
    for eos in ((), (4, 11)):
        got = beam_search_generate(prompt, CFG, params, max_gen_len=14,
                                   num_beams=beams, top_k=top_k,
                                   eos_tokens_id=eos, device="cpu")
        ref = jax_beam_search_generate(prompt, JCFG, jparams,
                                       max_gen_len=14, num_beams=beams,
                                       top_k=top_k, eos_tokens_id=eos)
        assert got == ref


def test_gather_rows_moves_every_field():
    """Row i of the gathered cache is row rows[i] of the source, values,
    scales and length alike; the source is untouched."""
    cfg = CFG.replace(kv_quant="int8")
    cache = tc.init_cache(cfg, 3, 5, device="cpu")
    for name in tc.storage_fields(cache):
        field = getattr(cache, name)
        field.copy_(torch.arange(field.numel()).reshape(field.shape)
                    .to(field.dtype))
    cache = cache.with_length(torch.tensor([2, 3, 4], dtype=torch.int32))
    rows = torch.tensor([2, 0, 0])
    got = tc.gather_rows(cache, rows)
    assert tc.storage_fields(got) == ["k", "v", "k_scale", "v_scale"]
    for name in tc.storage_fields(cache):
        assert torch.equal(getattr(got, name),
                           getattr(cache, name)[:, rows])
        assert getattr(got, name).data_ptr() != getattr(cache,
                                                        name).data_ptr()
    assert got.length.tolist() == [4, 2, 2]
    assert cache.length.tolist() == [2, 3, 4]
