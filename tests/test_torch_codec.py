"""The port's encoder-decoder against the JAX package's:
``core/codec_model.py``, ``sampling/codec_decoding.py`` and the T5 branch
of ``engine/model_loader.py::load_models``.

T5 checkpoints are built here with ``transformers`` (gated-gelu and ReLU,
tied and untied heads), saved with ``save_pretrained`` and read by both
packages: the JAX package through ``transformers``, the port through its
own safetensors reader. Params are bit-identical in f32; logits agree
within rtol = atol = 1e-5; greedy tokens and greedy acceptance are equal
(the port given JAX's acceptance draws where they matter); sampled output
is held to the target's distribution by JAX's TV bound (0.06,
tests/test_speculative.py)."""
import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import codec_model as jc
from specdec_tpu.engine import model_loader as jml
from specdec_tpu.sampling import codec_decoding as jd

from specdec_tpu_torch.bridge import params_from_numpy
from specdec_tpu_torch.core import codec_model as tc
from specdec_tpu_torch.engine import model_loader as tml
from specdec_tpu_torch.sampling import codec_decoding as td
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, MultinomialProcessor,
)
from specdec_tpu_torch.sampling.speculative import accept_step, commit_step

from test_torch_loader import write_tokenizer

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = [("relu", True), ("relu", False), ("gated", True),
            ("gated", False)]


def variant_id(v):
    return f"{v[0]}-{'tied' if v[1] else 'untied'}"


def same_bits(got, ref, where="params"):
    """The port's params bit-identical to JAX's (numpy leaves)."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(ref), where
        for k in got:
            same_bits(got[k], ref[k], f"{where}.{k}")
        return
    a = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    b = np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.shape,
                                                       b.shape)
    assert np.array_equal(a, b), where


def same_config(tcfg: tc.CodecConfig, jcfg: jc.CodecConfig):
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def to_torch(jcfg: jc.CodecConfig) -> tc.CodecConfig:
    return tc.CodecConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)
                             if f.name != "dtype"})


# ---------------------------------------------------------------------------
# relative position buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets", [(32, 128), (8, 32)])
def test_rel_position_bucket_bit_equal(buckets, bidirectional):
    """Bit-equal to the jitted JAX function (the loops run jitted) over
    rel in [-1024, 1024]: at T5's (32, 128) the encoder's log-spaced
    bucket truncates an exact integer at |rel| = 16, 32 and 64."""
    nb, md = buckets
    rel = np.arange(-1024, 1025, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda r: jc.rel_position_bucket(
        r, bidirectional, nb, md))(jnp.asarray(rel)))
    got = tc.rel_position_bucket(torch.from_numpy(rel).long(), bidirectional,
                                 nb, md)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# T5 checkpoints built with transformers
# ---------------------------------------------------------------------------

def build_t5(ffn: str, tied: bool, vocab_size: int = 256, seed: int = 0):
    """A tiny HF T5 (as tests/test_codec.py builds one), every parameter
    perturbed so that norms are not 1 (which would hide a missing one)."""
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(seed)
    cfg = T5Config(
        vocab_size=vocab_size, d_model=48, d_kv=12, d_ff=96, num_layers=2,
        num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=32, dropout_rate=0.0,
        feed_forward_proj="gated-gelu" if ffn == "gated" else "relu",
        decoder_start_token_id=0, eos_token_id=1, pad_token_id=0,
        tie_word_embeddings=tied)
    model = T5ForConditionalGeneration(cfg)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.fixture(scope="module")
def t5(tmp_path_factory):
    """{variant: (model, checkpoint dir)}; each dir also holds a
    word-level tokenizer (tests/test_torch_loader.py::write_tokenizer)."""
    root = tmp_path_factory.mktemp("t5")
    out = {}
    for v in VARIANTS:
        model = build_t5(*v)
        path = root / variant_id(v)
        model.save_pretrained(path, safe_serialization=True)
        write_tokenizer(path)
        out[v] = (model, str(path))
    return out


def jax_model(model):
    cfg = jc.codec_config_from_hf(model.config, dtype=jnp.float32)
    return cfg, jc.codec_params_from_hf(model, cfg)


@pytest.mark.parametrize("variant", VARIANTS, ids=variant_id)
def test_checkpoint_params_bit_equal(t5, variant):
    """load_codec_checkpoint (the port's own reader) and
    codec_params_from_hf on the module's state dict give JAX's
    codec_params_from_hf(model) bit for bit, and its config."""
    model, path = t5[variant]
    jcfg, jparams = jax_model(model)
    cfg, params = tc.load_codec_checkpoint(path, torch.float32, "cpu")
    same_config(cfg, jcfg)
    assert cfg.dtype == torch.float32
    same_bits(params, jax.tree.map(np.asarray, jparams))
    same_bits(tc.codec_params_from_hf(model, cfg, device="cpu"),
              jax.tree.map(np.asarray, jparams))
    same_config(tc.codec_config_from_hf(model.config), jcfg)


def test_checkpoint_bf16(tmp_path):
    """A bf16 checkpoint: loaded at f32 its weights are the bf16 values
    (exact), loaded at bf16 they are bit-equal to the f32 load cast."""
    build_t5("gated", False).to(torch.bfloat16).save_pretrained(
        tmp_path, safe_serialization=True)
    _, p32 = tc.load_codec_checkpoint(str(tmp_path), torch.float32, "cpu")
    cfg, p16 = tc.load_codec_checkpoint(str(tmp_path), torch.bfloat16, "cpu")
    assert cfg.dtype == torch.bfloat16
    for name in ("embed", "lm_head"):
        assert p16[name].dtype == torch.bfloat16
        assert torch.equal(p16[name], p32[name].to(torch.bfloat16))
        assert torch.equal(p16[name].float(), p32[name])
    assert torch.equal(p16["dec_layers"]["wi_0"],
                       p32["dec_layers"]["wi_0"].to(torch.bfloat16))


def jax_logits(cfg, params, enc_ids, dec_ids):
    mask = jnp.ones(enc_ids.shape, jnp.int32)
    enc = jc.encode(cfg, params, jnp.asarray(enc_ids), mask)
    ck, cv = jc.init_cross_kv(cfg, params, enc)
    logits, _ = jc.decode_step(cfg, params, jnp.asarray(dec_ids),
                               jd._codec_cache(cfg, 16), ck, cv, mask)
    return np.asarray(logits)


def port_logits(cfg, params, enc_ids, dec_ids, blocks=None):
    """Logits of dec_ids decoded in ``blocks`` (sizes; one block by
    default) through one cache of 16 slots."""
    enc_ids, dec_ids = torch.from_numpy(enc_ids), torch.from_numpy(dec_ids)
    mask = torch.ones(enc_ids.shape, dtype=torch.int32)
    enc = tc.encode(cfg, params, enc_ids, mask)
    ck, cv = tc.init_cross_kv(cfg, params, enc)
    cache = tc.codec_cache(cfg, 1, 16, "cpu")
    out, start = [], 0
    for size in blocks or [dec_ids.shape[1]]:
        logits, cache = tc.decode_step(cfg, params,
                                       dec_ids[:, start:start + size], cache,
                                       ck, cv, mask)
        out.append(logits)
        start += size
    assert int(cache.length[0]) == dec_ids.shape[1]
    return torch.cat(out, dim=1).numpy()


def ids(seed, V=256):
    rng = np.random.default_rng(seed)
    enc = rng.integers(2, V, size=(1, 9)).astype(np.int64)
    dec = np.concatenate([[[0]], rng.integers(2, V, size=(1, 6))], 1)
    return enc, dec.astype(np.int64)


@pytest.mark.parametrize("variant", VARIANTS, ids=variant_id)
def test_logits_match_jax(t5, variant):
    """encode / init_cross_kv / decode_step logits equal JAX's within
    rtol = atol = 1e-5 in f32, for the checkpoint's params and for JAX's
    params carried across by bridge.params_from_numpy."""
    model, path = t5[variant]
    jcfg, jparams = jax_model(model)
    enc, dec = ids(3)
    ref = jax_logits(jcfg, jparams, enc, dec)
    cfg, params = tc.load_codec_checkpoint(path, torch.float32, "cpu")
    np.testing.assert_allclose(port_logits(cfg, params, enc, dec), ref, **TOL)
    carried = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    np.testing.assert_allclose(port_logits(cfg, carried, enc, dec), ref,
                               **TOL)


@pytest.mark.parametrize("blocks", [[1] * 7, [3, 1, 3]], ids=["tokens", "mixed"])
def test_cached_decode_matches_block_decode(t5, blocks):
    """Decoding token by token (or in blocks) through the cache gives the
    one-block decode's logits (tests/test_codec.py:56-77) within 1e-5."""
    model, path = t5[("relu", True)]
    cfg, params = tc.load_codec_checkpoint(path, torch.float32, "cpu")
    enc, dec = ids(5)
    np.testing.assert_allclose(port_logits(cfg, params, enc, dec, blocks),
                               port_logits(cfg, params, enc, dec), **TOL)


# ---------------------------------------------------------------------------
# generation against JAX
# ---------------------------------------------------------------------------

CFG = jc.CodecConfig(vocab_size=48, d_model=32, d_kv=8, d_ff=64, num_heads=4,
                     num_encoder_layers=2, num_decoder_layers=2,
                     rel_buckets=8, rel_max_distance=32,
                     decoder_start_token_id=0, max_position_embeddings=256)
TCFG = to_torch(CFG)
PROMPT = [5, 9, 33, 2, 41, 7]
GEN = 14


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX drafter, port target, port drafter): the target of
    tests/test_codec.py and a drafter = target + noise, carried across."""
    target = jc.init_codec_params(CFG, jax.random.key(0), scale=0.4)
    noise = jc.init_codec_params(CFG, jax.random.key(1), scale=0.1)
    drafter = jax.tree.map(lambda a, b: a + b, target, noise)
    return (target, drafter,
            params_from_numpy(jax.tree.map(np.asarray, target), "cpu"),
            params_from_numpy(jax.tree.map(np.asarray, drafter), "cpu"))


def jax_draws(key, gamma):
    """JAX's acceptance draws of window w of ``_codec_spec``."""
    def draw(shape, generator, device):
        k = jax.random.split(jax.random.fold_in(key, draw.window), 3)[1]
        draw.window += 1
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (gamma,)))).reshape(shape)
    draw.window = 0
    return draw


def port_ar(params, prompt=PROMPT, gen=GEN, eos=()):
    return td.autoregressive_generate_encoder_decoder(
        prompt, TCFG, params, max_gen_len=gen, eos_tokens_id=eos,
        device="cpu")


def test_greedy_ar_matches_jax(models):
    jt, _, tt, _ = models
    ref = jd.autoregressive_generate_encoder_decoder(
        PROMPT, CFG, jt, max_gen_len=GEN, eos_tokens_id=(),
        key=jax.random.key(2))
    got = port_ar(tt)
    assert got == ref
    assert got[0] == CFG.decoder_start_token_id and len(got) == GEN + 1


def test_greedy_spec_matches_jax(models, monkeypatch):
    """Greedy spec with the distinct drafter (first_target=False) gives
    JAX's tokens and acceptance exactly, given JAX's acceptance draws (a
    greedy draft is accepted with probability p(x)/q(x), so the draws
    matter); self-draft greedy spec equals greedy AR at acceptance 1.0."""
    jt, jdr, tt, tdr = models
    key = jax.random.key(4)
    ref, ref_rate = jd.speculative_generate_encoder_decoder(
        PROMPT, CFG, jdr, CFG, jt, gamma=3, max_gen_len=GEN,
        eos_tokens_id=(), first_target=False, key=key)
    monkeypatch.setattr(td, "_accept_uniforms", jax_draws(key, 3))
    got, rate = td.speculative_generate_encoder_decoder(
        PROMPT, TCFG, tdr, TCFG, tt, gamma=3, max_gen_len=GEN,
        eos_tokens_id=(), first_target=False, device="cpu")
    assert got == ref and rate == ref_rate
    assert len(got) == GEN + 1 and 0.0 < rate < 1.0
    monkeypatch.undo()
    own, own_rate = td.speculative_generate_encoder_decoder(
        PROMPT, TCFG, tt, TCFG, tt, gamma=3, max_gen_len=GEN,
        eos_tokens_id=(), first_target=False, device="cpu")
    assert own == port_ar(tt) and own_rate == 1.0


def test_first_target_drafter_covers_the_start_token(models):
    """With first_target the drafter's cache covers the start token. The
    JAX package gives its drafter length 1 without writing position 0 (a
    zero key and value stand in for the start token's: ROADMAP.md §3), so
    its self-draft parts from its greedy AR on this prompt; the port's
    self-draft equals greedy AR at acceptance 1.0, and the distinct
    drafter's greedy run is deterministic and starts with the target's own
    first token."""
    jt, _, tt, tdr = models
    prompt = [int(t) for t in np.random.default_rng(1).integers(2, 48, 240)]
    jar = jd.autoregressive_generate_encoder_decoder(
        prompt, CFG, jt, max_gen_len=40, eos_tokens_id=(),
        key=jax.random.key(0))
    jspec, _ = jd.speculative_generate_encoder_decoder(
        prompt, CFG, jt, CFG, jt, gamma=3, max_gen_len=40, eos_tokens_id=(),
        key=jax.random.key(0))
    assert jspec != jar            # the reference's fault
    for p in (prompt, PROMPT):
        ar = port_ar(tt, p, GEN)
        own, rate = td.speculative_generate_encoder_decoder(
            p, TCFG, tt, TCFG, tt, gamma=3, max_gen_len=GEN,
            eos_tokens_id=(), device="cpu")
        assert own == ar and rate == 1.0
        runs = [td.speculative_generate_encoder_decoder(
            p, TCFG, tdr, TCFG, tt, gamma=3, max_gen_len=GEN,
            eos_tokens_id=(), seed=3, device="cpu") for _ in range(2)]
        assert runs[0] == runs[1] and runs[0][0][:2] == ar[:2]


def test_low_temperature_spec_equals_ar(models):
    """GreedyProcessor at temperature 1e-4 saturates the softmaxes: a draft
    is accepted iff it is the target's argmax, a rejection commits the
    argmax, so the distinct drafter gives greedy AR's tokens whatever the
    draws."""
    _, _, tt, tdr = models
    prompt = [3, 17, 22, 40, 11]   # drafts accepted in part here
    for seed in (0, 1):
        got, rate = td.speculative_generate_encoder_decoder(
            prompt, TCFG, tdr, TCFG, tt, gamma=4, max_gen_len=GEN,
            logits_processor=GreedyProcessor(temperature=1e-4),
            eos_tokens_id=(), seed=seed, device="cpu")
        assert got == port_ar(tt, prompt) and 0.0 < rate < 1.0


def test_max_position_sets_total_len(models):
    """A prompt of 240 tokens under max_position_embeddings 256: total_len
    = 256 - 240 - 1 = 15 decoder positions, not max_gen_len + 1."""
    jt, _, tt, _ = models
    prompt = list(np.random.default_rng(1).integers(2, 48, size=240))
    ref = jd.autoregressive_generate_encoder_decoder(
        prompt, CFG, jt, max_gen_len=40, eos_tokens_id=(),
        key=jax.random.key(0))
    got = port_ar(tt, prompt, 40)
    assert got == ref and len(got) == 15
    spec, rate = td.speculative_generate_encoder_decoder(
        prompt, TCFG, tt, TCFG, tt, gamma=3, max_gen_len=40,
        eos_tokens_id=(), device="cpu")
    assert spec == got and rate == 1.0


def test_eos_stops(models):
    """A token of the free-running output as EOS: AR and self-draft spec
    stop right after its first occurrence, as JAX's AR does."""
    jt, _, tt, _ = models
    prompt = [5, 9, 33, 2]
    free = port_ar(tt, prompt, 12)
    eos = free[4]
    want = free[:free.index(eos, 1) + 1]
    ref = jd.autoregressive_generate_encoder_decoder(
        prompt, CFG, jt, max_gen_len=12, eos_tokens_id=eos,
        key=jax.random.key(6))
    assert port_ar(tt, prompt, 12, eos) == ref == want
    spec, _ = td.speculative_generate_encoder_decoder(
        prompt, TCFG, tt, TCFG, tt, gamma=3, max_gen_len=12,
        eos_tokens_id=eos, device="cpu")
    assert spec == want


def test_sampled_first_token_distribution(models):
    """The first token through the accept / reject / residual path (one
    window, first_target=False) is distributed as the target's processed
    distribution at decoder position 0: TV < 0.06 over 1000 draws, JAX's
    bound (tests/test_speculative.py:77). At temperature 0.15 the target
    puts 0.77 on its top token (expected TV of 1000 exact draws 0.029) and
    the drafter's proposal is rejected with probability 0.2 (its own
    distribution is at TV 0.2 from the target's)."""
    _, _, tt, tdr = models
    proc = MultinomialProcessor(temperature=0.15)
    gen = torch.Generator().manual_seed(0)
    n_runs = 1000
    counts = np.zeros(CFG.vocab_size)
    for _ in range(n_runs):
        out, _ = td.speculative_generate_encoder_decoder(
            PROMPT, TCFG, tdr, TCFG, tt, gamma=1, max_gen_len=1,
            logits_processor=proc, eos_tokens_id=(), first_target=False,
            generator=gen, device="cpu")
        assert len(out) == 2
        counts[out[1]] += 1
    prompt = torch.tensor([PROMPT])
    mask = torch.ones_like(prompt, dtype=torch.int32)
    ck, cv = tc.init_cross_kv(TCFG, tt, tc.encode(TCFG, tt, prompt, mask))
    logits, _ = tc.decode_step(TCFG, tt, torch.zeros((1, 1), dtype=torch.long),
                               tc.codec_cache(TCFG, 1, 8, "cpu"), ck, cv,
                               mask)
    p = proc(logits[0, 0]).numpy()
    tv = 0.5 * np.abs(counts / n_runs - p).sum()
    assert tv < 0.06, f"TV distance {tv:.4f}"


@jax.jit
def jax_window(p_all, q_all, drafts, r, eos_ids, remaining):
    """sampling/codec_decoding.py:187-222 of the JAX package, transcribed,
    with the greedy processor's argmax as the resample; ``eos_ids`` an
    array padded with -1."""
    gamma = drafts.shape[0]
    idx = jnp.arange(gamma)
    p_x = p_all[idx, drafts]
    q_x = q_all[idx, drafts]
    reject = r > p_x / jnp.maximum(q_x, 1e-38)
    n = jnp.where(jnp.any(reject), jnp.argmax(reject), gamma)
    p_n = p_all[jnp.minimum(n, gamma)]
    q_n = q_all[jnp.minimum(n, gamma - 1)]
    pos = jnp.maximum(p_n - q_n, 0.0)
    residual = pos / jnp.maximum(pos.sum(), 1e-38)
    has_mass = jnp.sum(pos) > 1e-12
    resample = jnp.where(has_mass, residual, p_n)
    next_dist = jnp.where(n == gamma, p_all[gamma], resample)
    next_tok = jnp.argmax(next_dist).astype(jnp.int32)
    cand = jnp.where(idx < n, drafts, 0)
    cand = jnp.append(cand, 0).at[n].set(next_tok)
    advance = jnp.minimum(n + 1, remaining)
    is_eos = jnp.isin(cand, eos_ids) & (jnp.arange(gamma + 1) <= n)
    within = is_eos & (jnp.arange(gamma + 1) < advance)
    any_eos = jnp.any(within)
    advance = jnp.where(any_eos, jnp.minimum(jnp.argmax(within) + 1,
                                             advance), advance)
    return n, cand, advance, any_eos


def test_accept_and_commit_are_the_codec_window_rule():
    """The codec loop's window (JAX's sampling/codec_decoding.py:187-222)
    is the decoder-only loop's accept_step + commit_step: the same accept
    count, candidates, advance and EOS flag on 200 random windows (drafts
    from q or at random, EOS sets, budgets that cut the window)."""
    rng = np.random.default_rng(0)
    gamma, V = 4, 10
    for _ in range(200):
        p = rng.dirichlet(np.full(V, 0.3), size=gamma + 1).astype(np.float32)
        q = rng.dirichlet(np.full(V, 0.3), size=gamma).astype(np.float32)
        if rng.random() < 0.5:
            p[:gamma] = 0.7 * p[:gamma] + 0.3 * q  # drafts often accepted
        drafts = (q.argmax(-1) if rng.random() < 0.5
                  else rng.integers(0, V, gamma)).astype(np.int32)
        r = rng.random(gamma).astype(np.float32)
        eos_ids = tuple(int(t) for t in rng.choice(V, rng.integers(0, 3),
                                                   replace=False))
        remaining = int(rng.integers(1, gamma + 3))
        ref = jax_window(p, q, drafts, r,
                         np.array(eos_ids + (-1,) * (2 - len(eos_ids))),
                         remaining)
        n, next_tok = accept_step(
            torch.from_numpy(p)[None], torch.from_numpy(q)[None],
            torch.from_numpy(drafts).long()[None], torch.from_numpy(r)[None],
            GreedyProcessor(), None)
        cand, advance, any_eos = commit_step(
            torch.from_numpy(drafts).long()[None], n, next_tok, remaining,
            eos_ids)
        assert int(n[0]) == int(ref[0])
        np.testing.assert_array_equal(cand[0].numpy(), np.asarray(ref[1]))
        assert (int(advance[0]), bool(any_eos[0])) == (int(ref[2]),
                                                       bool(ref[3]))


# ---------------------------------------------------------------------------
# load_models
# ---------------------------------------------------------------------------

def test_load_models_t5_matches_jax(t5):
    """load_models on a T5 directory with a tokenizer, in both packages:
    the same configs, params bit-equal to each other, the same tokenizer
    output and end tokens; kv_quant does not touch a codec model."""
    _, path = t5[("gated", False)]
    ours = tml.load_models(path, path, dtype=torch.float32, kv_quant="int8",
                           device="cpu")
    theirs = jml.load_models(path, path, dtype=jnp.float32, kv_quant="int8")
    for role in ("target", "drafter"):
        assert ours[role]["codec"] and theirs[role]["codec"]
        same_config(ours[role]["cfg"], theirs[role]["cfg"])
        same_bits(ours[role]["params"],
                  jax.tree.map(np.asarray, theirs[role]["params"]))
    assert ours["end_tokens"] == theirs["end_tokens"]
    assert ours["pad_token_id"] == theirs["pad_token_id"]
    text = "tell me about speculative decoding"
    assert ours["tokenizer"].encode(text) == theirs["tokenizer"].encode(text)


@pytest.mark.parametrize("case", ["quantization", "drafter_quantization",
                                  "layerskip", "eagle"])
def test_load_models_refuses_what_codec_cannot_take(case, t5, tmp_path,
                                                    monkeypatch):
    """A codec target or drafter with a quantization, and a layerskip: or
    eagle: drafter over a codec target, raise ValueError before any
    weight is read. (JAX's loader instead quantizes the codec params and
    fails with a KeyError on params["layers"].)"""
    _, path = t5[("relu", True)]

    def no_read(*a, **k):
        raise AssertionError("a checkpoint was read before the refusal")

    monkeypatch.setattr(tc, "load_codec_checkpoint", no_read)
    kw = {"quantization": dict(drafter_model_path=None,
                               quantization="int4"),
          "drafter_quantization": dict(drafter_model_path=path,
                                       drafter_quantization="int8"),
          "layerskip": dict(drafter_model_path="layerskip:1"),
          "eagle": dict(drafter_model_path="eagle:1")}[case]
    with pytest.raises(ValueError, match="codec models load dense"):
        tml.load_models(path, dtype=torch.float32, device="cpu", **kw)


def test_load_models_codec_vocab_check(t5, tmp_path):
    """The drafter and target must share a vocabulary, codec pairs too."""
    _, path = t5[("relu", True)]
    other = tmp_path / "t5_v128"
    build_t5("relu", True, vocab_size=128).save_pretrained(
        other, safe_serialization=True)
    write_tokenizer(other)
    with pytest.raises(ValueError, match="share a vocabulary"):
        tml.load_models(path, str(other), dtype=torch.float32, device="cpu")
