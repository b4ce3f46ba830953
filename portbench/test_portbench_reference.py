"""The plain reference against the program on the CPU at tiny widths of
both families: the program's INT4 prefill logits and its paged decode
logits (prefill, one-token steps and a verify block through the page
pool) against the reference's full-sequence float32 logits, and the
reference's INT4 copy against the program's quantizer bit for bit."""
import numpy as np
import pytest
import torch

from portbench import weights as W
from portbench.conftest import tiny_config
from portbench.harness import Program
from portbench.reference import Reference, fp8_rows, int4_roundtrip

SEED = 2 ** 31 + 11


def tiny(family):
    cfg = tiny_config(family)
    cfg["weights"]["seed"] = SEED
    return cfg
# bf16 activations against float32: the logits' relative Frobenius error
REL_FRO = 2e-2


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).norm() / ref.norm())


@pytest.mark.parametrize("family", ["qwen3", "gpt_neox"])
def test_int4_copy_bit_equal(family):
    from specdec_tpu_torch.quant.core import dequantize, quantize_int4

    lay = W.layer(tiny(family), SEED, 2, "cpu")
    for name in ("wq", "wo", "w_up", "w_down"):
        w = lay[name][0]
        assert torch.equal(int4_roundtrip(w),
                           dequantize(quantize_int4(w), torch.float32)), name


def _sequence(cfg, n):
    rng = np.random.default_rng(5)
    return rng.integers(1, cfg["vocab_size"], size=n).tolist()


@pytest.mark.parametrize("family", ["qwen3", "gpt_neox"])
def test_prefill_logits(family):
    from specdec_tpu_torch.core.model import forward_full

    cfg = tiny(family)
    prog = Program(cfg, torch.device("cpu"))
    seq = _sequence(cfg, 40)
    got = forward_full(prog.t_cfg, prog.target,
                       torch.tensor([seq]))[0, 9:39].float()
    ref = Reference(cfg, "cpu").run([seq], [10])[None][0]
    assert _rel(got, ref) < REL_FRO
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean() > 0.9


@pytest.mark.parametrize("family", ["qwen3", "gpt_neox"])
def test_paged_decode_logits(family):
    from specdec_tpu_torch.core.model import forward_step_paged
    from specdec_tpu_torch.core.paged_cache import init_paged_cache

    cfg = tiny(family)
    prog = Program(cfg, torch.device("cpu"))
    seq = _sequence(cfg, 48)
    page, mp = 16, 4
    cache = init_paged_cache(prog.t_cfg, 1, 1 + mp, page, mp, device="cpu")
    cache.page_table[0] = torch.arange(1, 1 + mp, dtype=torch.int32)
    got = []
    logits, cache = forward_step_paged(prog.t_cfg, prog.target,
                                       torch.tensor([seq[:24]]), cache)
    got.append(logits[0, -1:])
    for t in seq[24:40]:                      # one-token decode steps
        logits, cache = forward_step_paged(prog.t_cfg, prog.target,
                                           torch.tensor([[t]]), cache)
        got.append(logits[0])
    logits, cache = forward_step_paged(      # a verify block of 5
        prog.t_cfg, prog.target, torch.tensor([seq[40:45]]), cache)
    got.append(logits[0, :-1])
    got = torch.cat(got).float()
    ref = Reference(cfg, "cpu").run([seq[:45]], [24])[None][0]
    assert got.shape == ref.shape
    assert _rel(got, ref) < REL_FRO


def test_control_is_coarser():
    """The float8 control departs from the float32 reference by far more
    than the program does."""
    cfg = tiny("qwen3")
    prog = Program(cfg, torch.device("cpu"))
    seq = _sequence(cfg, 40)
    from specdec_tpu_torch.core.model import forward_full

    got = forward_full(prog.t_cfg, prog.target,
                       torch.tensor([seq]))[0, 9:39].float()
    out = Reference(cfg, "cpu").run([seq], [10], (None, "fp8"))
    ref, ctl = out[None][0], out["fp8"][0]
    assert _rel(ctl, ref) > 3 * _rel(got, ref)
    x = torch.randn(8, 64)
    err = (fp8_rows(x) - x).abs() / x.abs().amax(-1, True)
    assert 0 < float(err.max()) <= 2 ** -4
