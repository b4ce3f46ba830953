"""deepseek_v2 in the port: latent attention over a latent cache, the
expert layer and YaRN, held to transformers' ``DeepseekV2ForCausalLM``
and to a plain reference of the architecture (``deepseek_v2_reference``)
on the CPU.

One departure between the two published implementations is followed on
the model's side: DeepSeek's own code multiplies the softmax scale by
YaRN's mscale(factor, mscale_all_dim) squared (as transformers'
deepseek_v3 port does), transformers' deepseek_v2 port leaves it out. The
port and the reference apply it; the HF model gets it here through each
attention module's ``scaling``.

Tolerances, and why:

- float32 forwards of the same dense weights (HF, reference, port in
  either attention form): 2e-5 of the logits' largest magnitude, the
  difference of f32 sums taken in other orders (the absorbed form sums
  over the latent, the decompressed one over the heads' widths);
- the INT4 serving path (bf16 activations, weights quantized to INT4)
  against the reference on the same INT4 values: 6% of the logits' largest
  magnitude, bf16's rounding of every activation and the kernels' inputs
  across three layers, far below the gaps the tests' seeds show between
  the best and the second token where the served tokens are compared.
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

import deepseek_v2_reference as ref
from specdec_tpu_torch.core import mla, moe
from specdec_tpu_torch.core.cache import init_cache
from specdec_tpu_torch.core.hf_loader import config_from_hf, params_from_hf
from specdec_tpu_torch.core.model import (
    forward_full, forward_step, forward_step_paged, kernel_route,
    layer_views,
)
from specdec_tpu_torch.core.paged_cache import (
    init_paged_cache, install_sequence_pages, paged_view,
)
from specdec_tpu_torch.core.rope import rope_cos_sin
from specdec_tpu_torch.ops.expert_matmul import (
    int4_expert_matmul, int4_expert_matmul_reference,
)
from specdec_tpu_torch.ops.quant_matmul import int4_matmul_reference
from specdec_tpu_torch.quant.core import (
    Int4Weight, dequantize, quantize_int4, quantize_params,
)

YARN = {"type": "yarn", "factor": 8.0, "original_max_position_embeddings": 32,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
        "mscale_all_dim": 0.707}


def tiny_hf(**kw) -> dict:
    """A tiny deepseek_v2 config: layer 0 dense, 8 experts top-2 and one
    shared expert after it, latent 32, rope 16, YaRN on."""
    hf = dict(model_type="deepseek_v2", vocab_size=128, hidden_size=64,
              intermediate_size=96, moe_intermediate_size=32,
              num_hidden_layers=3, num_attention_heads=4,
              num_key_value_heads=4, n_routed_experts=8, n_shared_experts=1,
              num_experts_per_tok=2, first_k_dense_replace=1,
              kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16,
              qk_rope_head_dim=16, v_head_dim=24,
              max_position_embeddings=256, rope_theta=10000.0,
              rms_norm_eps=1e-6, topk_method="greedy", n_group=1,
              topk_group=1, routed_scaling_factor=1.0, norm_topk_prob=False,
              tie_word_embeddings=False, rope_scaling=dict(YARN))
    hf.update(kw)
    return hf


def hf_model(hf: dict, seed: int = 0):
    """A float32, eager-attention ``DeepseekV2ForCausalLM`` of ``hf`` on
    random weights (norm weights near 1), with mscale^2 in its scaling."""
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    torch.manual_seed(seed)
    keys = {k: v for k, v in hf.items() if k != "model_type"}
    c = DeepseekV2Config(**keys, attn_implementation="eager")
    m = DeepseekV2ForCausalLM(c).float().eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.normal_(0, 0.1)
            if "norm" in name:
                p.add_(1.0)
    rs = hf["rope_scaling"]
    if rs and rs.get("mscale_all_dim"):
        ms = ref._mscale(rs["factor"], rs["mscale_all_dim"])
        for layer in m.model.layers:
            layer.self_attn.scaling = layer.self_attn.scaling * ms * ms
    return m


@pytest.fixture(scope="module")
def model():
    hf = tiny_hf()
    m = hf_model(hf)
    cfg = config_from_hf(m.config)
    return hf, m, cfg, params_from_hf(m, cfg, device="cpu")


def _close(a, b, rel):
    assert (a - b).abs().max().item() <= rel * b.abs().max().item()


# ---------------------------------------------------------------- config

def test_config_reads_deepseek_v2():
    hf = tiny_hf()
    cfg = config_from_hf(hf)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim) == (32, 16, 16, 24)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok,
            cfg.n_shared_experts, cfg.first_k_dense_replace) == (8, 2, 1, 1)
    assert cfg.rotary_dim == 16
    assert [cfg.is_moe_layer(i) for i in range(3)] == [False, True, True]
    ms = 0.1 * 0.707 * math.log(8.0) + 1.0
    assert cfg.attn_scale == pytest.approx(32 ** -0.5 * ms * ms, rel=1e-12)
    # the published DeepSeek-V2-Lite: one latent stream of 576 bf16 values
    # a position and layer, 31,104 B a position over its 27 layers
    lite = config_from_hf(tiny_hf(
        kv_lora_rank=512, qk_rope_head_dim=64, qk_nope_head_dim=128,
        v_head_dim=128, num_hidden_layers=27), dtype=torch.bfloat16)
    Hk, Dk, Dv = lite.cache_dims
    assert (Hk, Dk, Dv) == (1, 576, 0)
    assert Hk * Dk * 2 * lite.num_layers == 31104


@pytest.mark.parametrize("key,value", [
    ("topk_method", "group_limited_greedy"), ("n_group", 8),
    ("q_lora_rank", 1536), ("scoring_func", "sigmoid"),
    ("moe_layer_freq", 2), ("norm_topk_prob", True)])
def test_config_refuses_what_the_port_does_not_implement(key, value):
    with pytest.raises(ValueError, match=key):
        config_from_hf(tiny_hf(**{key: value}))


def test_yarn_frequencies_match_transformers():
    from transformers import DeepseekV2Config
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    hf = tiny_hf(qk_rope_head_dim=64, rope_scaling=dict(
        YARN, factor=40.0, original_max_position_embeddings=4096))
    c = DeepseekV2Config(**{k: v for k, v in hf.items()
                            if k != "model_type"})
    inv, factor = _compute_yarn_parameters(c, "cpu")
    cfg = config_from_hf(hf)
    pos = torch.arange(0, 9000, 7)
    cos, sin = rope_cos_sin(pos, cfg.rotary_dim, cfg.rope_theta,
                            scaling=cfg.rope_scaling)
    ang = pos[:, None].double() * inv.double()[None, :]
    assert factor == pytest.approx(cfg.rope_scaling[5], rel=1e-12)
    torch.testing.assert_close(cos[:, :32], (ang.cos() * factor).float(),
                               atol=2e-3, rtol=0)
    torch.testing.assert_close(sin[:, :32], (ang.sin() * factor).float(),
                               atol=2e-3, rtol=0)
    mine = rope_cos_sin(torch.ones(1), 64, cfg.rope_theta,
                        scaling=cfg.rope_scaling)[1][0, :32].double()
    torch.testing.assert_close(torch.asin(mine), inv.double(), rtol=1e-5,
                               atol=1e-7)


# ------------------------------------------------------ parity with HF

def test_reference_and_port_match_transformers(model):
    hf, m, cfg, params = model
    toks = torch.randint(0, 128, (1, 40), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        want = m(toks).logits[0]
    _close(ref.forward(hf, params, toks[0]), want, 2e-5)
    _close(forward_full(cfg, params, toks)[0], want, 2e-5)


def test_router_matches_transformers_gate(model):
    from transformers.models.deepseek_v2.modeling_deepseek_v2 import (
        DeepseekV2MoEGate,
    )

    hf, m, cfg, params = model
    gate = m.model.layers[1].mlp.gate
    assert isinstance(gate, DeepseekV2MoEGate)
    x = torch.randn(1, 33, 64, generator=torch.Generator().manual_seed(2))
    idx, w = gate(x)
    mw, midx = moe.route(cfg, x[0], params["layers"][1]["router"])
    order = idx.sort(-1)
    torch.testing.assert_close(midx.sort(-1).values, order.values)
    torch.testing.assert_close(mw.gather(1, midx.sort(-1).indices),
                               w.gather(1, order.indices), rtol=1e-6,
                               atol=1e-7)
    assert mw.dtype == torch.float32


# ------------------------------------------------ the caches and windows

def _paged_cache(cfg, S, page=8):
    pages = -(-S // page)
    cache = init_paged_cache(cfg, 1, pages + 1, page, pages, device="cpu")
    row = torch.arange(1, pages + 1, dtype=torch.int32)
    cache.page_table[0] = row
    return cache, row


def _window_logits(cfg, params, seq, kind, rows_first=20):
    """Prefill seq[:rows_first] (the decompressed form, through the padded
    flash-decode kernel's plain version where the config takes it: bf16,
    not float32 at head width 256), a one-token
    decode, then a window of three drafts of which two are rejected
    (rollback by length) and two tokens verified again: logits of every
    forward, with the positions they score."""
    S = len(seq) + 8
    t = torch.tensor(seq)[None, :]
    n = rows_first
    out = []
    cache = init_cache(cfg, 1, S, device="cpu")
    logits, cache = forward_step(cfg, params, t[:, :n], cache,
                                 use_kernel=kernel_route(cfg))
    out.append((logits[0], list(range(n))))
    if kind == "paged":
        pool, row = _paged_cache(cfg, S)
        install_sequence_pages(pool, row, cache)
        cache = paged_view(pool, row, n)
        step = forward_step_paged
    else:
        step = forward_step
    logits, cache = step(cfg, params, t[:, n:n + 1], cache)
    out.append((logits[0], [n]))
    # three drafts, the last two rejected: seq[n+1] is kept, then the
    # window's two wrong tokens are rolled back
    drafts = torch.tensor([[seq[n + 1], 7, 9]])
    logits, cache = step(cfg, params, drafts, cache)
    out.append((logits[0, :1], [n + 1]))
    cache = cache.rolled_back(2)
    logits, cache = step(cfg, params, t[:, n + 2:n + 4], cache)
    out.append((logits[0], [n + 2, n + 3]))
    return out


@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_port_matches_reference_through_prefill_decode_and_rollback(
        model, kind):
    hf, m, cfg, params = model
    seq = torch.randint(0, 128, (28,), generator=torch.Generator()
                        .manual_seed(3)).tolist()
    want = ref.forward(hf, params, seq[:24])
    for got, pos in _window_logits(cfg, params, seq, kind):
        _close(got, want[pos], 2e-5)


def test_paged_absorbed_form_reads_the_pool_in_place(model, monkeypatch):
    """The paged forward's absorbed form (blocks under 16 rows) attends
    through the MLA decode kernel's wrapper over the pool's layer and the
    page table, once a layer, and gathers no page; the decompressed form of
    an admission-sized block still gathers its layer's pages."""
    from specdec_tpu_torch.core import paged_cache
    from specdec_tpu_torch.ops import mla_attention as ma

    _, _, cfg, params = model
    calls = {"gather": 0, "kernel": 0}
    real_gather, real_kernel = paged_cache.gather_pages, ma.mla_decode_attention

    def gather(*args):
        calls["gather"] += 1
        return real_gather(*args)

    def kernel(q, lat, offsets, scale, rank, page_table=None):
        calls["kernel"] += 1
        assert page_table is not None and lat.shape[1] == 1  # [NP, 1, page, D]
        return real_kernel(q, lat, offsets, scale, rank, page_table)

    monkeypatch.setattr(paged_cache, "gather_pages", gather)
    monkeypatch.setattr(mla, "gather_pages", gather)
    monkeypatch.setattr(ma, "mla_decode_attention", kernel)
    pool, row = _paged_cache(cfg, 48)
    cache = paged_view(pool, row, 0)
    toks = torch.arange(1, 17)[None]
    L = cfg.num_layers
    logits, cache = forward_step_paged(cfg, params, toks, cache)
    assert calls == {"gather": L, "kernel": 0}
    for T in (1, 2, 5):
        logits, cache = forward_step_paged(cfg, params, toks[:, :T], cache)
        assert bool(torch.isfinite(logits).all())
    assert calls == {"gather": L, "kernel": 3 * L}


def test_decompressed_form_through_padded_kernel_is_exact(model):
    """K3's padded head width adds zeros to every score and fills dropped
    output columns: on the kernel's plain path the padded call gives the
    unpadded attention's numbers."""
    from specdec_tpu_torch.core.model import masked_attention
    from specdec_tpu_torch.ops.decode_attention import (
        flash_decode_attention,
    )

    g = torch.Generator().manual_seed(4)
    q, k = torch.randn(2, 5, 4, 192, generator=g), torch.randn(
        2, 9, 4, 192, generator=g)
    v = torch.randn(2, 9, 4, 128, generator=g)
    off = torch.tensor([3, 4])
    q_pos = off[:, None] + torch.arange(5)[None]
    want = masked_attention(q, k, v, q_pos, 4, scale=0.123).reshape(
        2, 5, 4, 128)

    def pad(t):
        return torch.nn.functional.pad(t, (0, 256 - t.shape[-1]))
    got = flash_decode_attention(pad(q), pad(k), pad(v), off, scale=0.123)
    torch.testing.assert_close(got[..., :128], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[..., 128:], torch.zeros_like(got[..., 128:]))


def _split_kvb(cfg, w):
    """kv_b's values [r, H * (nope + v)] as (W_UK, W_UV), by head."""
    H, nope = cfg.num_heads, cfg.qk_nope_head_dim
    w = w.float().reshape(cfg.kv_lora_rank, H, -1).transpose(0, 1)
    return w[..., :nope], w[..., nope:]


@pytest.mark.parametrize("build", ["loader", "quantizer"])
def test_absorbed_weights_set_once_at_build(request, build):
    """The loader and the quantizer each set a latent layer's W_UK/W_UV,
    float32 and contiguous, from the kv_b they hold: the dense values, or
    the INT4 values dequantized (the served form of ``int4_model``)."""
    if build == "loader":
        _, _, cfg, params = request.getfixturevalue("model")
    else:
        _, cfg, params, _ = request.getfixturevalue("int4_model")
    for lay in params["layers"]:
        kvb = lay["w_kvb"]
        kvb = dequantize(kvb) if isinstance(kvb, Int4Weight) else kvb
        for got, want in zip((lay["w_uk"], lay["w_uv"]),
                             _split_kvb(cfg, kvb)):
            assert got.dtype == torch.float32 and got.is_contiguous()
            assert torch.equal(got, want)


@pytest.mark.parametrize("where", ["absorbed_form", "quantizer"])
def test_latent_layer_without_absorbed_weights_is_refused(model, where):
    """The absorbed form does not make W_UK/W_UV itself, and the quantizer
    needs the config to split them."""
    _, _, cfg, params = model
    bare = [{k: v for k, v in lay.items() if k not in ABSORBED}
            for lay in params["layers"]]
    with pytest.raises(ValueError, match="w_kvb" if where == "quantizer"
                       else "w_uk"):
        if where == "quantizer":
            quantize_params(dict(params, layers=bare), kind="int8",
                            fuse=True)
        else:
            g = torch.Generator().manual_seed(2)
            H = cfg.num_heads
            mla.absorbed(cfg, bare[0], torch.randn(1, 2, H, 16, generator=g),
                         torch.randn(1, 2, H, 16, generator=g),
                         torch.randn(1, 4, 48, generator=g),
                         torch.tensor([[2, 3]]))


# --------------------------------------------------- the INT4 serving path

# the absorbed form's float32 weights, which the served layers keep
ABSORBED = ("w_uk", "w_uv")


def _int4(cfg, params):
    """The served form: INT4 (fused), bf16 activations, w_uk/w_uv held in
    float32 (set by the quantizer)."""
    q = quantize_params(params, kind="int4", fuse=True, cfg=cfg)
    bf = cfg.replace(dtype=torch.bfloat16)
    layers = [{k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor)
               and k not in ABSORBED else v for k, v in lay.items()}
              for lay in q["layers"]]
    served = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor)
                  else v) for k, v in q.items() if k != "layers"}
    served["layers"] = layers
    # the reference's weights: the INT4 values in float32
    deq = {k: (dequantize(v) if not isinstance(v, torch.Tensor)
               else v.to(torch.bfloat16).float())
           for k, v in q.items() if k != "layers"}
    deq["layers"] = []
    for lay, orig in zip(q["layers"], params["layers"]):
        d = {k: dequantize(v) if not isinstance(v, torch.Tensor)
             else v.to(torch.bfloat16).float() for k, v in lay.items()
             if k not in ABSORBED}
        for fused, parts, widths in (
                ("wq_kva", ("wq", "w_kva"), None),
                ("w_gateup", ("w_gate", "w_up"), None),
                ("shared_gateup", ("shared_gate", "shared_up"), None),
                ("experts_gateup", ("experts_gate", "experts_up"), None)):
            if fused in d:
                w = d.pop(fused)
                a = orig[parts[0]].shape[-1]
                d[parts[0]], d[parts[1]] = w[..., :a], w[..., a:]
        deq["layers"].append(d)
    return bf, served, deq


@pytest.fixture(scope="module")
def int4_model():
    """D 256 so that every projection takes the INT4 kernels' plain
    versions (K % 256), the experts' down projection K = 192 (K % 64)."""
    hf = tiny_hf(hidden_size=256, intermediate_size=512,
                 moe_intermediate_size=192, kv_lora_rank=64,
                 qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=64,
                 vocab_size=512)
    m = hf_model(hf, seed=5)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if "norm" not in name:
                p.mul_(0.5)
    cfg = config_from_hf(m.config)
    return (hf, *_int4(cfg, params_from_hf(m, cfg, device="cpu")))


@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_int4_path_matches_reference_on_its_values(int4_model, kind):
    hf, cfg, served, deq = int4_model
    seq = torch.randint(0, 512, (28,), generator=torch.Generator()
                        .manual_seed(6)).tolist()
    want = ref.forward(hf, deq, seq[:24])
    for got, pos in _window_logits(cfg, served, seq, kind):
        _close(got.float(), want[pos], 6e-2)


def test_served_tokens_equal_reference_greedy(int4_model):
    """The paged engine serves the INT4 pair (drafter: layers 0-1) and
    every served token is the reference's argmax on the INT4 values."""
    from specdec_tpu_torch.sampling.processors import GreedyProcessor
    from specdec_tpu_torch.serve import PagedContinuousBatcher

    hf, cfg, served, deq = int4_model
    d_cfg = cfg.replace(num_layers=2)
    drafter = dict(served, layers=layer_views(served["layers"], 2))
    b = PagedContinuousBatcher(
        d_cfg, drafter, cfg, served, num_slots=2, gamma=3,
        max_prompt_len=24, max_new_tokens=10, page_size=8,
        logits_processor=GreedyProcessor(temperature=1e-4),
        eos_tokens_id=(), seed=1, device="cpu")
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, 512, (n,), generator=g).tolist()
               for n in (20, 17, 23)]
    ids = [b.submit(p, max_new_tokens=8) for p in prompts]
    b.run()
    for rid, p in zip(ids, prompts):
        out = b.completed[rid].output_ids
        assert len(out) == 8
        logits = ref.forward(hf, deq, p + out)[len(p) - 1:-1]
        gap = logits.max(-1).values - logits.gather(
            1, torch.tensor(out)[:, None])[:, 0]
        assert gap.max().item() <= 0.06 * logits.abs().max().item(), gap


def test_paged_batcher_refuses_what_mla_does_not_take(int4_model):
    from specdec_tpu_torch.serve import PagedContinuousBatcher

    _, cfg, served, _ = int4_model
    for kw in ({"prefix_caching": True}, {"prefill_chunk": 16}):
        with pytest.raises(ValueError, match="latent"):
            PagedContinuousBatcher(cfg, served, cfg, served, num_slots=2,
                                   max_prompt_len=32, max_new_tokens=8,
                                   device="cpu", **kw)


def test_drafter_view_shares_the_target_layers(int4_model):
    _, cfg, served, _ = int4_model
    view = layer_views(served["layers"], 2)
    assert len(view) == 2 and all(a is b for a, b in
                                  zip(view, served["layers"]))


# ---------------------------------------------------- the expert kernel

def _routing(T, E, k, used, g):
    idx = torch.rand(T, used, generator=g).topk(k).indices
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(E, dtype=torch.int32).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    off = torch.nn.functional.pad(torch.cumsum(counts, 0, dtype=torch.int32),
                                  (1, 0))
    return off, (order // k).to(torch.int32)


@pytest.mark.parametrize("K,N", [(1408, 64), (2048, 96), (192, 40)])
@pytest.mark.parametrize("used", [8, 3])
def test_expert_matmul_plain_version_is_per_expert_k1(K, N, used):
    """Each expert's rows, gathered through the sorted index, through K1's
    plain version on that expert's matrix; experts given no row (``used``
    3 of 8) write nothing and are skipped."""
    g = torch.Generator().manual_seed(K + used)
    w = quantize_int4(torch.randn(8, K, N, generator=g) * 0.05)
    x = torch.randn(11, K, generator=g).to(torch.bfloat16)
    off, rows = _routing(11, 8, 2, used, g)
    got = int4_expert_matmul(x, w, off, rows)
    for e in range(8):
        a, b = int(off[e]), int(off[e + 1])
        if used == 3 and e >= 3:
            assert a == b
        want = int4_matmul_reference(x[rows[a:b].long()], w.packed[e],
                                     w.absmax[e])
        assert torch.equal(got[a:b], want)
    # the input already in expert order: rows None
    xs = x[rows.long()]
    assert torch.equal(int4_expert_matmul_reference(xs, w, off), got)


def test_expert_layer_weights_each_expert_alone():
    """Quantizing a stack quantizes each expert's matrix alone."""
    g = torch.Generator().manual_seed(8)
    w = torch.randn(3, 128, 32, generator=g)
    w[1] *= 100.0
    s = quantize_int4(w)
    assert isinstance(s, Int4Weight) and s.packed.shape == (3, 16, 32)
    for e in range(3):
        one = quantize_int4(w[e])
        assert torch.equal(s.packed[e], one.packed)
        assert torch.equal(s.absmax[e], one.absmax)


def test_expert_layer_traced_records(int4_model):
    from specdec_tpu_torch.utils.profiling import TRACER

    _, cfg, served, _ = int4_model
    TRACER.drain()
    TRACER.enable()
    try:
        tokens = torch.randint(0, 512, (2, 3))
        cache = init_cache(cfg, 2, 16, device="cpu")
        forward_step(cfg, served, tokens, cache)
    finally:
        TRACER.disable()
    t = TRACER.drain()
    routes = t.records["moe_route"]
    assert len(routes) == 2          # layers 1 and 2
    for _, rows, most, touched in routes:
        assert rows == 6 * 2 and 1 <= most <= 6 and 1 <= touched <= 8
    kern = t.records["int4_expert_matmul"]
    assert len(kern) == 4            # gate/up and down, two layers
    assert [r[1:4] for r in kern[:2]] == [(12, 256, 384), (12, 192, 256)]
    att = t.records["mla_attention"]
    assert len(att) == 1 and att[0][1:] == (3, 96 * 2, 4 * 160 * 2, 2 * 3,
                                            6)
    assert sum(s[0] == "mla_attend" for s in t.spans) == 3


def test_dense_config_path_unchanged():
    """A config without latent attention allocates K and V as before."""
    from specdec_tpu_torch.core.config import tiny_config

    cfg = tiny_config()
    c = init_cache(cfg, 2, 8, device="cpu")
    assert c.k.shape == c.v.shape == (2, 2, 8, 2, 16)
    assert cfg.cache_dims == (2, 16, 16)
    assert cfg.kv_lora_rank == 0 and not cfg.is_moe_layer(1)
    # the JAX package's fields, and no others
    assert "kv_lora_rank" not in {f.name for f in dataclasses.fields(cfg)}


# ------------------------------------------------ the benchmark's family

def test_benchmark_family_block_matches_reference(model):
    """``portbench/families/deepseek_v2.py``'s float32 ``block``, layer by
    layer, against the plain reference on the same dense weights."""
    from portbench import weights as W
    from portbench.reference import Ops, rms

    hf, m, cfg, params = model
    fam = W.family(hf)
    a = fam.arch(hf)
    seq = torch.randint(0, 128, (30,), generator=torch.Generator()
                        .manual_seed(9))
    x = params["embed"][seq].float()
    pos = torch.arange(30)
    for i, lay in enumerate(params["layers"]):
        x = fam.block(a, i, x, pos, {k: v.float() for k, v in lay.items()},
                      Ops(None))
    got = rms(x, params["final_norm_w"], a["eps"]) @ params["lm_head"]
    _close(got, ref.forward(hf, params, seq), 2e-5)


def test_benchmark_family_counts_the_published_model():
    """DeepSeek-V2-Lite's active weights a token (2.24B in the layers,
    2.45B with the head: the published 2.4B active) and the decompressed
    form's operations a scored key, 2 * (192 + 128) a head."""
    import json
    from pathlib import Path

    from portbench import weights as W

    cfg = json.loads((Path(__file__).resolve().parents[1] / "portbench" /
                      "configs" / "deepseek-v2-lite-ls8.json").read_text())
    fam = W.family(cfg)
    a = fam.arch(cfg)
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    moe_w = 2048 * 64 + 3 * 2048 * 1408 * (2 + 6)
    assert fam.weights_per_token(a) == (27 * attn + 3 * 2048 * 10944
                                        + 26 * moe_w)
    assert 4 * a["Hq"] * a["Dh"] == 16 * 2 * (192 + 128)
    assert a["scale"] == pytest.approx(
        192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2, rel=1e-12)
    assert [n for n, (s, k) in fam.tensors(a, 1).items() if k == "bias"] \
        == ["router"]
    assert fam.tensors(a, 1)["experts_down"][0] == (64, 1408, 2048)
    assert "w_down" in fam.tensors(a, 0) and "router" not in fam.tensors(
        a, 0)
