"""The JAX package's convergence gates (tests/test_pretrain.py), on the
port's trainers at JAX's test width: a 4-layer D=128 target pretrained 450
steps on the order-1 Markov stream (V=128, 64 states, 4 successors) must
reach the stream's entropy floor + 0.35 nats (a fresh batch + 0.4); a
depth-1 EAGLE head trained 250 steps on it must reach a teacher-forced
acceptance proxy of 0.5, more than 0.3 above the untrained head's; and the
trained head must then accept more drafts in ``eagle_generate`` than the
untrained one. The port draws its init and batches from torch, so its
numbers differ from JAX's; the gates are the same."""
import numpy as np
import pytest
import torch

from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.eagle import init_eagle_params
from specdec_tpu_torch.engine import optim
from specdec_tpu_torch.engine.eagle_train import (
    eagle_acceptance_proxy, train_eagle,
)
from specdec_tpu_torch.engine.pretrain import (
    MarkovSpec, build_trained_target, lm_nll, markov_sampler,
)
from specdec_tpu_torch.sampling.eagle_speculative import eagle_generate

torch.set_num_threads(2)

SPEC = MarkovSpec(vocab_size=128, num_states=64, branching=4, zipf_s=1.2,
                  order=1, seed=3)
CFG = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                  num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
                  max_position_embeddings=256, dtype=torch.float32)


@pytest.fixture(scope="module")
def trained():
    return build_trained_target(CFG, SPEC, steps=450, batch_size=32,
                                seq_len=64, learning_rate=3e-3, seed=0,
                                device="cpu")


def test_train_lm_learns_the_stream(trained):
    params, nll = trained
    floor = SPEC.entropy_nats
    assert nll < floor + 0.35, (nll, floor)
    toks = markov_sampler(SPEC, 16, 64, "cpu")(
        torch.Generator().manual_seed(99))
    eval_nll = float(lm_nll(CFG, params, toks))
    assert eval_nll < floor + 0.4, (eval_nll, floor)
    assert not any(t.requires_grad for t in optim.leaves(params))


def test_eagle_gets_real_acceptance_on_trained_target(trained):
    """The head's proxy gates, then generation: over the same prompts and
    draws, the trained head's drafts are accepted more often."""
    target, _ = trained
    e_cfg = CFG.replace(num_layers=1)
    head = init_eagle_params(e_cfg, seed=7, device="cpu")
    sampler = markov_sampler(SPEC, 16, 64, "cpu")
    toks = sampler(torch.Generator().manual_seed(10_007))
    acc0, _ = eagle_acceptance_proxy(CFG, e_cfg, head, target, toks)
    trained_head, acc = train_eagle(CFG, target, e_cfg, head, steps=250,
                                    batch_sampler=sampler,
                                    learning_rate=2e-3, seed=8,
                                    device="cpu")
    assert acc >= 0.5, acc
    assert acc - float(acc0) > 0.3, (float(acc0), acc)
    assert not any(t.requires_grad for t in optim.leaves(trained_head))

    prompts = markov_sampler(SPEC, 4, 12, "cpu")(
        torch.Generator().manual_seed(5)).tolist()
    rates = {}
    for name, h in (("untrained", head), ("trained", trained_head)):
        rates[name] = np.mean([eagle_generate(
            p, e_cfg, h, CFG, target, gamma=4, max_gen_len=24,
            eos_tokens_id=(), seed=i, device="cpu")[1]
            for i, p in enumerate(prompts)])
    assert rates["trained"] > rates["untrained"], rates
