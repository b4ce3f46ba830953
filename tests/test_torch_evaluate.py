"""The port's perplexity evaluation (``engine/evaluate.py``) against the
JAX package's, on the same params (made by JAX, carried over with
``bridge.params_from_numpy``) and the same sequences.

Dense f32 perplexities and log-probabilities agree at rtol 1e-5. Quantized
weights agree at bf16 tolerance: the port's plain versions of the weight
kernels round x and each product to bf16, as the kernels do, where the JAX
package's CPU route dequantizes in f32. The quantization quality gates of
tests/test_evaluate.py hold on the port too."""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from specdec_tpu.core import model as jm
from specdec_tpu.core.config import tiny_config
from specdec_tpu.engine import evaluate as jev
from specdec_tpu.quant import core as jq

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.engine import evaluate as tev
from specdec_tpu_torch.quant import core as tq

torch.set_num_threads(2)

VOCAB = 64
# K = 64 everywhere, so every 4-bit format quantizes
JCFG = tiny_config(vocab_size=VOCAB, num_layers=2, hidden_size=64,
                   intermediate_size=128, num_heads=4, num_kv_heads=2,
                   head_dim=16)
RNG = np.random.default_rng(0)
SEQS = [RNG.integers(1, VOCAB, size=n).tolist() for n in (9, 14, 5, 20)]


def port_config(cfg) -> ModelConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ModelConfig(**dict(kw, dtype=torch.float32))


CFG = port_config(JCFG)


@pytest.fixture(scope="module")
def params():
    """JAX numpy params at scale 0.15 (tests/test_evaluate.py's 4-bit
    gate: a model well away from uniform, ppl ~130 over 64 tokens)."""
    return jax.tree.map(np.asarray,
                        jm.init_params(JCFG, jax.random.key(1), scale=0.15))


def both(params, kind="none"):
    if kind != "none":
        params = jax.tree.map(np.asarray, jq.quantize_params(params,
                                                             kind=kind))
    return jax.tree.map(jax.numpy.asarray, params), params_from_numpy(
        params, "cpu")


@pytest.mark.parametrize("batch_size", [1, 3, 8])
def test_dense_perplexity_matches_jax(params, batch_size):
    jp_, tp_ = both(params)
    ref = jev.perplexity(JCFG, jp_, SEQS, batch_size=batch_size)
    got = tev.perplexity(CFG, tp_, SEQS, batch_size=batch_size,
                         device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_sequence_logprobs_match_jax(params):
    jp_, tp_ = both(params)
    ref = jev.sequence_logprobs(JCFG, jp_, SEQS)
    got = tev.sequence_logprobs(CFG, tp_, SEQS, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert all(lp < 0 for lp in got)
    n = sum(len(s) - 1 for s in SEQS)
    np.testing.assert_allclose(np.exp(-sum(got) / n),
                               tev.perplexity(CFG, tp_, SEQS, device="cpu"),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "int4", "nf4", "fp4"])
def test_quantized_perplexity_matches_jax(params, kind):
    """Quantized perplexity and log-probs against JAX's on bit-identical
    containers, at bf16 tolerance (a logit's bf16 step moves a log-prob by
    at most ~2⁻⁸ of its magnitude); batching invariance; and the quality
    gate of tests/test_evaluate.py (within 5%, NF4 15%, of dense)."""
    jp_, tp_ = both(params, kind)
    ref = jev.perplexity(JCFG, jp_, SEQS)
    got = tev.perplexity(CFG, tp_, SEQS, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    np.testing.assert_allclose(
        tev.sequence_logprobs(CFG, tp_, SEQS, device="cpu"),
        jev.sequence_logprobs(JCFG, jp_, SEQS), rtol=1e-2)
    np.testing.assert_allclose(
        tev.perplexity(CFG, tp_, SEQS, batch_size=1, device="cpu"), got,
        rtol=1e-5)
    dense = tev.perplexity(CFG, both(params)[1], SEQS, device="cpu")
    tol = 0.15 if kind == "nf4" else 0.05
    assert abs(got - dense) / dense < tol, (kind, dense, got)


def test_nll_sums_masking(params):
    """Padding scores nothing: a padded row's sums equal the row alone,
    and positions t with t or t+1 padded are not counted."""
    _, tp_ = both(params)
    toks = torch.tensor([[5, 9, 11, 0, 0], [7, 3, 8, 2, 6]])
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    nll, n = tev._nll_sums(CFG, tp_, toks, mask)
    a, na = tev._nll_sums(CFG, tp_, toks[:1, :3], mask[:1, :3])
    b, nb = tev._nll_sums(CFG, tp_, toks[1:], mask[1:])
    assert float(n) == float(na + nb) == 2 + 4
    np.testing.assert_allclose(float(nll), float(a + b), rtol=1e-6)


def test_quantized_perplexity_launches_the_wrappers(params, monkeypatch):
    """On an INT4 target every projection and the lm_head go through the
    weight kernel's wrappers where the kernel takes their K (the plain
    version here; the kernel on the card), and through the dequant route
    where it does not (K % 256 != 0: every K of this model): one call a
    layer projection per forward, each on exactly one of the two."""
    from specdec_tpu_torch.ops import quant_matmul as qm

    _, tp_ = both(params, "int4")
    calls = []

    def counted(label, fn):
        def call(*a):
            calls.append(label)
            return fn(*a)
        return call

    def route(x, w, idx=None, real=qm.dequant_matmul):
        calls.append("route 2d" if idx is None else "route")
        return real(x, w, idx)
    route.calls = qm.dequant_matmul.calls  # the route counts itself by name
    monkeypatch.setitem(qm._WRAPPERS, tq.Int4Weight, (
        counted("2d", qm.int4_matmul),
        counted("stacked", qm.int4_matmul_stacked)))
    monkeypatch.setattr(qm, "dequant_matmul", route)
    tev.perplexity(CFG, tp_, SEQS, batch_size=4, device="cpu")
    # unfused q/k/v, gate/up: 7 projections a layer, 2 layers, one forward
    assert calls.count("stacked") + calls.count("route") == 7 * 2
    assert calls.count("2d") + calls.count("route 2d") == 1
    assert qm.four_bit_takes(CFG.hidden_size) == (calls.count("2d") == 1)


def test_evaluate_needs_a_device_or_the_card(params, monkeypatch):
    """``device=None`` means the card: without CUDA it raises."""
    _, tp_ = both(params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.perplexity(CFG, tp_, SEQS)
