"""Which attention the serving engine's slotted forwards take: the batch
engine's ``forward_step``, which the batchers' admissions go through too,
passes ``kernel_route(cfg)``, so the hybrid layout's drafter steps and the
dense admission prefills reach the flash-decode kernel's wrapper (K3, or
K4 over int8 K/V) whatever ``attention_impl`` says, while the
single-sequence engines, the n-gram loop, tree blocks and forwards that
want a gradient keep the config's rule, which under ``"xla"`` is the plain
attention. On the CPU the wrappers compute the plain
version, so the served tokens are the old route's bit for bit (and, through
tests/test_torch_serve.py, JAX's). Under the tracer each slotted forward
that takes the kernel leaves a ``decode_attention`` record."""
import pytest
import torch

from specdec_tpu_torch.core import cache as tc
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core.config import tiny_config
from specdec_tpu_torch.engine import batch_engine as tbe
from specdec_tpu_torch.ngram import NGramStorage
from specdec_tpu_torch.ngram.assisted import (
    ngram_assisted_speculative_generate,
)
from specdec_tpu_torch.ops import decode_attention as tda
from specdec_tpu_torch.ops import paged_attention as tpa
from specdec_tpu_torch.sampling.speculative import speculative_generate
from specdec_tpu_torch.serve import ContinuousBatcher, PagedContinuousBatcher
from specdec_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(2)

# head_dim 16: one the kernels take over int8 K/V too
CFG = tiny_config(vocab_size=32, num_layers=2, hidden_size=32,
                  intermediate_size=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, attention_impl="xla")
D_CFG = CFG.replace(num_layers=1)
PROMPTS = [[3, 14, 15, 9, 2, 6], [1, 1, 2, 3, 5, 8, 13, 21], [27, 4],
           [9, 9, 9, 1, 2]]
GAMMA, GEN, P = 3, 8, 16
WRAPPERS = ((tda, "flash_decode_attention"),
            (tda, "flash_decode_attention_quant"),
            (tpa, "paged_decode_attention"),
            (tpa, "paged_decode_attention_stacked"),
            (tpa, "paged_decode_attention_quant"),
            (tpa, "paged_decode_attention_quant_stacked"))


@pytest.fixture
def calls(monkeypatch):
    """Every attention kernel wrapper counts its calls (by name) and runs
    as before; ``windows`` counts the batch engine's windows."""
    counts = {name: 0 for _, name in WRAPPERS}
    counts["windows"] = 0
    for module, name in WRAPPERS:
        def counted(*a, _name=name, _fn=getattr(module, name), **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    body = tbe._spec_window_body

    def window(*a, **kw):
        counts["windows"] += 1
        return body(*a, **kw)
    monkeypatch.setattr(tbe, "_spec_window_body", window)
    return counts


def pair(cfg=CFG):
    target = tm.init_params(cfg, seed=0, scale=0.4, device="cpu")
    return dict(target, layers=tm.layer_views(target["layers"], 1)), target


def serve(kind, cfg=CFG, **kw):
    drafter, target = pair(cfg)
    d_cfg = cfg.replace(num_layers=1)
    if kind == "slotted":
        b = ContinuousBatcher(d_cfg, drafter, cfg, target, num_slots=2,
                              gamma=GAMMA, max_prompt_len=P,
                              max_new_tokens=GEN, eos_tokens_id=(),
                              device="cpu", **kw)
    else:
        b = PagedContinuousBatcher(d_cfg, drafter, cfg, target, num_slots=2,
                                   gamma=GAMMA, max_prompt_len=P,
                                   max_new_tokens=GEN, page_size=8,
                                   eos_tokens_id=(), device="cpu", **kw)
    ids = [b.submit(p) for p in PROMPTS]
    done = b.run()
    return b, [done[i].output_ids for i in ids]


def old_route(monkeypatch):
    """The route before the serving engine passed ``kernel_route``: the
    config's rule, the plain attention under ``"xla"``."""
    monkeypatch.setattr(tbe, "kernel_route", lambda cfg: False)


@pytest.mark.parametrize("kind,kv_quant", [
    ("hybrid", "none"), ("hybrid", "int8"), ("slotted", "none")])
def test_serving_forwards_reach_the_flash_kernel(calls, monkeypatch, kind,
                                                 kv_quant):
    """Under ``"xla"`` the hybrid engine's drafter takes the kernel once a
    layer in each of its gamma forwards a window, and each dense admission
    twice (the target's and the drafter's prefill); the slotted engine's
    verify takes it too. The paged verify keeps the paged kernel. The
    served tokens equal the plain route's."""
    cfg = CFG.replace(kv_quant=kv_quant)
    assert tm.kernel_route(cfg)
    b, outs = serve(kind, cfg)
    L, Ld, windows = CFG.num_layers, D_CFG.num_layers, calls["windows"]
    slotted = ("flash_decode_attention_quant" if kv_quant == "int8"
               else "flash_decode_attention")
    paged = ("paged_decode_attention_quant_stacked" if kv_quant == "int8"
             else "paged_decode_attention_stacked")
    admissions = len(PROMPTS)
    if kind == "hybrid":
        assert b.preemptions == 0
        want = {slotted: Ld * GAMMA * windows + (L + Ld) * admissions,
                paged: L * windows}
    else:
        want = {slotted: (Ld * GAMMA + L) * windows + (L + Ld) * admissions}
    assert windows > 0
    assert {k: n for k, n in calls.items() if n and k != "windows"} == want
    old_route(monkeypatch)
    for name in want:
        calls[name] = 0
    assert serve(kind, cfg)[1] == outs
    assert calls.get(slotted) == 0


def test_batch_engine_forwards_reach_the_flash_kernel(calls):
    """Under ``"xla"`` every forward of the batch engine takes the kernel
    once a layer: the batched speculative loop's prefills (target and
    drafter), its gamma drafter forwards and one verify a window, and each
    forward of the batched AR loop."""
    drafter, target = pair()
    prompts = PROMPTS[:2]
    L, Ld = CFG.num_layers, D_CFG.num_layers
    spec, _ = tbe.batch_speculative_generate(
        prompts, D_CFG, drafter, CFG, target, gamma=GAMMA, gen_len=GEN,
        eos_tokens_id=(), device="cpu")
    w = calls["windows"]
    assert w > 0 and calls["flash_decode_attention"] == (
        L * (1 + w) + Ld * (1 + GAMMA * w))
    calls["flash_decode_attention"] = 0
    ar = tbe.batch_autoregressive_generate(prompts, CFG, target, gen_len=GEN,
                                           eos_tokens_id=(), device="cpu")
    n = calls["flash_decode_attention"]
    assert n > L and n % L == 0
    assert [len(o) for o in spec] == [len(o) for o in ar] == [GEN] * 2


def test_softcapped_engine_makes_no_kernel_calls(calls):
    """A logit softcap is off the kernels' route: the drafter, the
    admissions and (through the gather path) the paged verify all attend
    in the plain attention."""
    cfg = CFG.replace(logit_softcap=5.0)
    assert not tm.kernel_route(cfg)
    serve("hybrid", cfg)
    assert calls["windows"] > 0
    assert not any(n for k, n in calls.items() if k != "windows")


def test_single_sequence_tree_and_grad_keep_the_plain_attention(calls):
    """Under ``"xla"``: ``speculative_generate`` and the n-gram loop
    (their own forwards; the n-gram loop's prefill too), a tree block
    (under every ``use_kernel``) and a forward under autograd reach no
    kernel wrapper; forcing the kernel on a forward that wants a gradient
    raises before any launch."""
    drafter, target = pair()
    speculative_generate([3, 1, 4, 1, 5], D_CFG, drafter, CFG, target,
                         gamma=GAMMA, max_gen_len=6, eos_tokens_id=(),
                         device="cpu")
    ngram_assisted_speculative_generate(
        [3, 1, 4, 1, 5, 3, 1, 4], NGramStorage(n=3, vocab_size=32), CFG,
        target, gamma=GAMMA, max_gen_len=6, eos_tokens_id=(), device="cpu")
    cache = tc.init_cache(CFG, 1, 16, device="cpu").with_length(
        torch.tensor([3], dtype=torch.int32))
    q = torch.randn(1, 3, 4, 16)
    kv = torch.randn(1, 16, 2, 16)
    tree = (torch.tensor([3], dtype=torch.int32),
            torch.tril(torch.ones(3, 3, dtype=torch.bool)))
    for use_kernel in (None, True, False):
        tm.attention(CFG, q, kv, kv, torch.tensor([[3, 4, 4]]), tree=tree,
                     use_kernel=use_kernel)
    tm.forward_step_tree(CFG, target, torch.tensor([[5, 6, 7]]), cache,
                         torch.tensor([0, 1, 1]), tree[1])
    grad_params = dict(target, embed=target["embed"].clone().requires_grad_())
    logits, _ = tm.forward_step(CFG, grad_params, torch.tensor([[5, 6, 7]]),
                                tc.init_cache(CFG, 1, 8, device="cpu"))
    assert logits.requires_grad
    assert not any(n for k, n in calls.items() if k != "windows")
    with pytest.raises(ValueError, match="no backward"):
        tm.forward_step(CFG, grad_params, torch.tensor([[5, 6, 7]]),
                        tc.init_cache(CFG, 1, 8, device="cpu"),
                        use_kernel=True)


def test_forced_kernel_refuses_what_it_cannot_take():
    """``use_kernel=True`` on a slotted forward raises before any launch
    for a softcap or a head_dim the kernel has no instance for."""
    toks = torch.tensor([[1, 2]])
    for cfg, match in ((CFG.replace(logit_softcap=5.0), "softcap"),
                       (CFG.replace(head_dim=264), "head_dim 264")):
        with pytest.raises(ValueError, match=match):
            tm.forward_step(cfg, {}, toks,
                            tc.init_cache(CFG, 1, 8, device="cpu"),
                            use_kernel=True)


def traced(fn):
    TRACER.drain()
    TRACER.enable()
    try:
        out = fn()
    finally:
        TRACER.disable()
    return out, TRACER.drain()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_decode_attention_record(kv_quant):
    """A slotted forward on the kernel records (layers, K/V bytes a
    position and layer, q and out bytes a query row and layer, live
    positions = sum(length + T), query rows = B * T); one on the plain
    attention, or any forward with the tracer off, records nothing."""
    cfg = CFG.replace(kv_quant=kv_quant)
    target = tm.init_params(cfg, seed=0, scale=0.4, device="cpu")
    lengths = torch.tensor([5, 9, 0], dtype=torch.int32)
    toks = torch.tensor([[1, 2], [3, 4], [5, 6]])

    def forward(use_kernel):
        cache = tc.init_cache(cfg, 3, 16, device="cpu").with_length(lengths)
        return tm.forward_step(cfg, target, toks, cache,
                               use_kernel=use_kernel)
    _, trace = traced(lambda: (forward(True), forward(False), forward(None)))
    kv = 2 * 2 * (16 * 1 + 4) if kv_quant == "int8" else 2 * 2 * 16 * 4
    assert trace.records == {"decode_attention": [
        (-1, CFG.num_layers, kv, 2 * 4 * 16 * 4, 5 + 9 + 0 + 3 * 2, 3 * 2)]}
    TRACER.drain()
    forward(True)
    assert TRACER.drain().records == {}


def test_decode_attention_records_in_the_engine():
    """In the hybrid engine the records fall in ``draft`` (gamma a window:
    the first forward feeds two tokens a row, the others one) and in
    ``prefill`` (two an admission, over the padded prompt from position
    0); the paged verify keeps its own ``paged_attention`` record."""
    (b, outs), trace = traced(lambda: serve("hybrid"))
    recs = trace.records["decode_attention"]
    spans = [trace.spans[r[0]][0] for r in recs]
    windows = sum(s[0] == "window" for s in trace.spans)
    assert spans.count("prefill") == 2 * len(PROMPTS)
    assert spans.count("draft") == GAMMA * windows
    assert set(spans) == {"prefill", "draft"}
    prefill = [r for r, s in zip(recs, spans) if s == "prefill"]
    assert {(r[1], r[4], r[5]) for r in prefill} == {(2, P, P), (1, P, P)}
    draft = [r for r, s in zip(recs, spans) if s == "draft"]
    assert [r[5] for r in draft] == [4, 2, 2] * windows
    assert all(r[1] == 1 for r in draft)
    assert len(trace.records["paged_attention"]) == windows
