"""The port's loaders against the JAX package's: ``core/hf_loader.py``,
``core/stream_loader.py``, ``quant/host.py``,
``quant/core.py::init_quantized_params`` and ``engine/model_loader.py``.

Every checkpoint is built here with ``transformers`` (tiny llama, qwen3 and
gemma configs, a word-level tokenizer) and read by both packages: the JAX
package as its own tests run it (``tests/test_stream_loader.py``), the
port on the CPU. Dense parameters and quantized containers must be
bit-identical; logits agree at f32 tolerance on f32 checkpoints and at bf16
tolerance quantized (``tests/test_torch_model.py::bf16_close``); greedy
tokens are equal."""
import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.core import hf_loader as jhf
from specdec_tpu.core import model as jm
from specdec_tpu.core import stream_loader as jsl
from specdec_tpu.engine import model_loader as jml
from specdec_tpu.quant import core as jq
from specdec_tpu.quant import host as jhost
from specdec_tpu.sampling import base_decoding as jbd

from specdec_tpu_torch.core import hf_loader as thf
from specdec_tpu_torch.core import model as tm
from specdec_tpu_torch.core import stream_loader as tsl
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.engine import model_loader as tml
from specdec_tpu_torch.quant import core as tq
from specdec_tpu_torch.quant import host as thost
from specdec_tpu_torch.sampling import base_decoding as tbd

torch.set_num_threads(2)

QUANT_KINDS = ("int8", "int4", "nf4", "fp4")
WORDS = ("the cat sat on a mat and then it ran to tell me about speculative "
         "decoding what is systolic array for hello world drafts verify "
         "tokens fast slow model").split()


# ---------------------------------------------------------------------------
# checkpoints, built in the test
# ---------------------------------------------------------------------------

def write_tokenizer(path):
    """A word-level tokenizer: <unk>, <s>, </s>, <|im_end|>, WORDS, then
    filler words up to 256 entries; no pad token (so pad falls back to
    EOS) and <|im_end|> in the vocabulary (a second end token)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    names = ["<unk>", "<s>", "</s>", "<|im_end|>"] + WORDS
    names += [f"w{i}" for i in range(256 - len(names))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(names)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                            eos_token="</s>", unk_token="<unk>").save_pretrained(
        str(path))


def _perturbed(model, seed):
    """Noise on every parameter (HF initializes norms to 1 or 0, which
    would hide a missing norm or its gemma +1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.eval()


def build_hf(family, seed=7, **kw):
    """A tiny transformers model of ``family`` (llama, qwen3, gemma)."""
    import transformers as tr

    torch.manual_seed(seed)
    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  max_position_embeddings=256, rms_norm_eps=1e-6,
                  eos_token_id=2, bos_token_id=1, pad_token_id=None)
    if family == "llama":
        cfg = tr.LlamaConfig(num_hidden_layers=3, num_attention_heads=4,
                             num_key_value_heads=2, tie_word_embeddings=False,
                             **dict(common, **kw))
        model = tr.LlamaForCausalLM(cfg)
    elif family == "qwen3":
        cfg = tr.Qwen3Config(num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, head_dim=16,
                             tie_word_embeddings=False, **common)
        model = tr.Qwen3ForCausalLM(cfg)
    else:
        cfg = tr.GemmaConfig(num_hidden_layers=2, num_attention_heads=2,
                             num_key_value_heads=1, head_dim=256, **common)
        model = tr.GemmaForCausalLM(cfg)
    return _perturbed(model, seed)


def shard_checkpoint(src, dst, n_shards=2):
    """Rewrite a one-file checkpoint as ``n_shards`` shards with an index,
    the layout large checkpoints ship in."""
    from safetensors.torch import load_file, save_file

    os.makedirs(dst, exist_ok=True)
    sd = load_file(os.path.join(src, "model.safetensors"))
    names = sorted(sd)
    weight_map = {}
    for s in range(n_shards):
        fname = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        part = {k: sd[k].contiguous() for k in names[s::n_shards]}
        save_file(part, os.path.join(dst, fname), metadata={"format": "pt"})
        weight_map.update({k: fname for k in part})
    with open(os.path.join(dst, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    for f in os.listdir(src):
        if f.endswith(".json") and f != "model.safetensors.index.json":
            with open(os.path.join(src, f)) as a, \
                    open(os.path.join(dst, f), "w") as b:
                b.write(a.read())


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{name: path}: llama in f32 (with a tokenizer), in bf16 and as two
    bf16 shards; qwen3 and gemma in f32; configs only for the rope cases."""
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    llama = build_hf("llama")
    for name, dtype in (("llama_f32", torch.float32),
                        ("llama_bf16", torch.bfloat16)):
        llama.to(dtype).save_pretrained(root / name)
        write_tokenizer(root / name)
        out[name] = str(root / name)
    shard_checkpoint(out["llama_bf16"], str(root / "llama_shards"))
    out["llama_shards"] = str(root / "llama_shards")
    for fam in ("qwen3", "gemma"):
        build_hf(fam).save_pretrained(root / f"{fam}_f32")
        out[f"{fam}_f32"] = str(root / f"{fam}_f32")
    import transformers as tr
    for name, rs in (("rope_llama3", {
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
            ("rope_linear", {"rope_type": "linear", "factor": 2.0})):
        tr.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, rope_scaling=rs).save_pretrained(
            root / name)
        out[name] = str(root / name)
    return out


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def _bits(x) -> np.ndarray:
    """Any tensor or array as raw bits (bf16 viewed as int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def assert_same_bits(got, ref, where="params"):
    """The port's params (or container) bit-identical to JAX's."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(ref), where
        for k in got:
            assert_same_bits(got[k], ref[k], f"{where}.{k}")
    elif isinstance(got, tq.QUANTIZED):
        assert type(got).__name__ == type(ref).__name__, where
        for f in dataclasses.fields(got):
            assert_same_bits(getattr(got, f.name), getattr(ref, f.name),
                             f"{where}.{f.name}")
    else:
        a, b = _bits(got), _bits(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), where


def jax_config_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def assert_config_equal(tcfg: ModelConfig, jcfg):
    """Every field of the port's config equals JAX's (dtype by name)."""
    ref = jax_config_fields(jcfg)
    for f in dataclasses.fields(tcfg):
        got = getattr(tcfg, f.name)
        if f.name == "dtype":
            assert str(got).split(".")[-1] == jnp.dtype(ref["dtype"]).name
        else:
            assert got == ref[f.name], (f.name, got, ref[f.name])


def bf16_close(got, ref):
    """tests/test_torch_model.py's bf16 tolerance for quantized models."""
    assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -5 * np.abs(ref).max())


TOKENS = np.random.default_rng(0).integers(3, 250, size=(2, 12))


def logits_both(tcfg, tparams, jcfg, jparams):
    got = tm.forward_full(tcfg, tparams, torch.tensor(TOKENS)).float().numpy()
    ref = np.asarray(jm.forward_full(jcfg, jparams, jnp.asarray(TOKENS,
                                                                jnp.int32)),
                     np.float32)
    return got, ref


# ---------------------------------------------------------------------------
# config_from_hf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama_f32", "qwen3_f32", "gemma_f32",
                                  "rope_llama3", "rope_linear"])
def test_config_from_hf_matches_jax(ckpts, name):
    """From config.json alone (a dict) and from transformers' AutoConfig,
    the port's config equals JAX's: head_dim from the config (gemma's 256),
    qk_norm for qwen3, tie_word_embeddings, llama3 and linear rope."""
    from transformers import AutoConfig

    hf = AutoConfig.from_pretrained(ckpts[name])
    ref = jhf.config_from_hf(hf, dtype=jnp.bfloat16)
    assert_config_equal(thf.config_from_hf(
        tsl.read_config(ckpts[name]), dtype=torch.bfloat16), ref)
    assert_config_equal(thf.config_from_hf(hf, dtype=torch.bfloat16), ref)
    expect = {"qwen3_f32": ("qk_norm", True), "gemma_f32": ("head_dim", 256),
              "rope_linear": ("rope_scaling", ("linear", 2.0)),
              "rope_llama3": ("rope_scaling",
                              ("llama3", 8.0, 1.0, 4.0, 64.0)),
              "llama_f32": ("tie_embeddings", False)}[name]
    assert getattr(ref, expect[0]) == expect[1]


def test_unsupported_rope_scaling_raises_in_both():
    cfg = {"rope_scaling": {"rope_type": "yarn", "factor": 4.0}}
    with pytest.raises(ValueError, match="yarn"):
        thf._rope_scaling_from_hf(cfg)
    from types import SimpleNamespace
    with pytest.raises(ValueError, match="yarn"):
        jhf._rope_scaling_from_hf(SimpleNamespace(**cfg))


# ---------------------------------------------------------------------------
# streamed loading: dense, sharded, quantized
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", [
    ("llama_bf16", "bfloat16"), ("llama_shards", "bfloat16"),
    ("llama_f32", "float32"), ("llama_f32", "bfloat16"),
    ("qwen3_f32", "float32"), ("gemma_f32", "float32"),
    ("gemma_f32", "bfloat16")])
def test_streamed_dense_bit_identical(ckpts, name, dtype):
    """load_hf_streamed's dense params equal JAX's bit for bit, from one
    file and from two shards (whose index sends each name to its shard)."""
    jcfg, jp = jsl.load_hf_streamed(ckpts[name], dtype=getattr(jnp, dtype))
    tcfg, tp = tsl.load_hf_streamed(ckpts[name], dtype=getattr(torch, dtype),
                                    device="cpu")
    assert_config_equal(tcfg, jcfg)
    assert_same_bits(tp, jax.tree.map(np.asarray, jp))


def test_sharded_equals_single_file(ckpts):
    _, one = tsl.load_hf_streamed(ckpts["llama_bf16"], device="cpu")
    _, two = tsl.load_hf_streamed(ckpts["llama_shards"], device="cpu")
    assert_same_bits(two, one)
    reader = tsl.ShardReader(ckpts["llama_shards"], max_open=1,
                             byte_budget=1)
    names = sorted(reader._where)
    assert len(set(reader._where.values())) == 2
    # alternating shards through a one-file, one-byte budget: every read
    # maps its file again and still returns the same rows
    for name in names[:6]:
        whole = reader(name)
        assert torch.equal(reader.slice_rows(name, 1, 3), whole[1:3])


@pytest.mark.parametrize("kind", QUANT_KINDS)
@pytest.mark.parametrize("name", ["llama_bf16", "llama_shards"])
def test_streamed_quantized_bit_identical(ckpts, name, kind):
    """Direct-to-quantized streaming: containers equal JAX's (host
    quantizers) bit for bit, and equal the port's quantize_params of the
    dense load."""
    _, jp = jsl.load_hf_streamed(ckpts[name], dtype=jnp.bfloat16,
                                 quantization=kind)
    _, tp = tsl.load_hf_streamed(ckpts[name], quantization=kind,
                                 device="cpu")
    assert_same_bits(tp, jax.tree.map(np.asarray, jp))
    _, dense = tsl.load_hf_streamed(ckpts[name], device="cpu")
    assert_same_bits(tp, tq.quantize_params(dense, kind=kind, fuse=True))


@pytest.mark.parametrize("name", ["llama_f32", "qwen3_f32", "gemma_f32"])
def test_streamed_logits_and_greedy_match_jax(ckpts, name):
    """An f32 checkpoint's logits agree with JAX's at f32 tolerance and its
    greedy tokens are equal."""
    jcfg, jp = jsl.load_hf_streamed(ckpts[name], dtype=jnp.float32)
    tcfg, tp = tsl.load_hf_streamed(ckpts[name], dtype=torch.float32,
                                    device="cpu")
    got, ref = logits_both(tcfg, tp, jcfg, jp)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    prompt = [int(t) for t in TOKENS[0, :6]]
    ours = tbd.autoregressive_generate(prompt, tcfg, tp, max_gen_len=10,
                                       eos_tokens_id=(), device="cpu")
    theirs = jbd.autoregressive_generate(prompt, jcfg, jp, max_gen_len=10,
                                         eos_tokens_id=())
    assert ours == [int(t) for t in theirs]


@pytest.mark.parametrize("kind", QUANT_KINDS)
def test_quantized_logits_match_jax(ckpts, kind):
    """Quantized loads (K = 64, 128: natural-order absmax, the layout the
    card's 4-bit kernels refuse; the plain path takes it) agree with JAX's
    at bf16 tolerance."""
    jcfg, jp = jsl.load_hf_streamed(ckpts["llama_f32"], dtype=jnp.float32,
                                    quantization=kind)
    tcfg, tp = tsl.load_hf_streamed(ckpts["llama_f32"], dtype=torch.float32,
                                    quantization=kind, device="cpu")
    bf16_close(*logits_both(tcfg, tp, jcfg, jp))


@pytest.mark.parametrize("name", ["llama_f32", "gemma_f32"])
def test_load_hf_model_matches_jax(ckpts, name):
    """The whole-model path (transformers' torch model) gives JAX's params
    bit for bit."""
    jcfg, jp = jhf.load_hf_model(ckpts[name], dtype=jnp.float32)
    tcfg, tp = thf.load_hf_model(ckpts[name], dtype=torch.float32,
                                 device="cpu")
    assert_config_equal(tcfg, jcfg)
    assert_same_bits(tp, jax.tree.map(np.asarray, jp))


def test_safetensors_reader_dtypes(tmp_path):
    """The hand-written reader against safetensors' own writer: BF16, F16,
    F32 and I32 tensors, a 0-d tensor and an empty one, metadata kept."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    sd = {"a": torch.randn(5, 3, generator=g).to(torch.bfloat16),
          "b": torch.randn(4, generator=g).to(torch.float16),
          "c": torch.randn(2, 3, 4, generator=g),
          "d": torch.arange(7, dtype=torch.int32),
          "e": torch.tensor(3.5), "f": torch.zeros(0, 4)}
    save_file(sd, str(tmp_path / "model.safetensors"),
              metadata={"format": "pt"})
    f = tsl.SafetensorsFile(str(tmp_path / "model.safetensors"))
    assert f.metadata == {"format": "pt"}
    for k, v in sd.items():
        got = f.get(k)
        assert got.dtype == v.dtype and got.shape == v.shape
        assert torch.equal(got, v), k
    assert torch.equal(f.get("c", 1, 2), sd["c"][1:2])


# ---------------------------------------------------------------------------
# quant/host.py and init_quantized_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", QUANT_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_quantizers_match_jax(kind, dtype):
    """quant/host.py equals JAX's host quantizers bit for bit, whole and
    chunked by columns (an uneven last chunk), stacked [L, K, N] too."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    w = (rng.standard_normal((2, 128, 200)) * 0.05).astype(np.float32)
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    tfn, jfn = thost.HOST_QUANTIZERS[kind], jhost.HOST_QUANTIZERS[kind]
    assert_same_bits(tfn(w[0]), jfn(w[0]))
    assert_same_bits(tfn(w), jfn(w))
    assert_same_bits(thost.quantize_np_chunked(tfn, w[0], chunk_cols=48),
                     jhost.quantize_np_chunked(jfn, w[0], chunk_cols=48))
    assert_same_bits(thost.quantize_np_chunked(tfn, w[0], chunk_cols=48),
                     tfn(w[0]))


@pytest.mark.parametrize("fuse", [True, False])
def test_host_layer_dict_matches_jax(fuse):
    rng = np.random.default_rng(4)
    lay = {k: (rng.standard_normal((1, 64, n)) * 0.1).astype(np.float32)
           for k, n in (("wq", 64), ("wk", 32), ("wv", 32), ("wo", 64),
                        ("w_gate", 128), ("w_up", 128))}
    lay["w_down"] = (rng.standard_normal((1, 128, 64)) * 0.1).astype(
        np.float32)
    lay["bq"], lay["bk"], lay["bv"] = (np.ones((1, n), np.float32)
                                       for n in (64, 32, 32))
    lay["attn_norm_w"] = np.ones((1, 64), np.float32)
    assert_same_bits(
        thost.quantize_layer_dict_np(lay, thost.quantize_int4_np, fuse),
        jhost.quantize_layer_dict_np(lay, jhost.quantize_int4_np, fuse))


@pytest.mark.parametrize("kind", QUANT_KINDS)
def test_init_quantized_params(kind):
    """The containers have JAX's fields, shapes and dtypes, and equal the
    port's quantize_params of the same dense layers drawn again from the
    same generator stream, bit for bit (layer_out_scales included)."""
    cfg = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
               num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64)
    tcfg = ModelConfig(**cfg, dtype=torch.bfloat16)
    scales = [1.0, 0.5, 0.08]
    got = tq.init_quantized_params(tcfg, seed=11, kind=kind, device="cpu",
                                   layer_out_scales=scales)
    ref = jax.tree.map(np.asarray, jq.init_quantized_params(
        jm.ModelConfig(**cfg, dtype=jnp.bfloat16), jax.random.key(0),
        kind=kind, layer_out_scales=scales))
    assert sorted(got) == sorted(ref) and sorted(got["layers"]) == sorted(
        ref["layers"])
    for where, a, b in [("lm_head", got["lm_head"], ref["lm_head"])] + [
            (k, got["layers"][k], ref["layers"][k]) for k in got["layers"]]:
        if isinstance(a, tq.QUANTIZED):
            assert type(a).__name__ == type(b).__name__
            fa = {f.name: _bits(getattr(a, f.name))
                  for f in dataclasses.fields(a)}
            fb = {f.name: _bits(getattr(b, f.name))
                  for f in dataclasses.fields(b)}
            assert {k: (v.shape, v.dtype) for k, v in fa.items()} == {
                k: (v.shape, v.dtype) for k, v in fb.items()}, where
        else:
            assert (_bits(a).shape, _bits(a).dtype) == (
                _bits(b).shape, _bits(b).dtype), where

    gen = torch.Generator().manual_seed(11)
    one = tcfg.replace(num_layers=1)
    lays = [tm.init_layer_params(one, 0.02, "cpu", gen) for _ in range(3)]
    dense = {k: torch.cat([lay[k] for lay in lays]) for k in lays[0]}
    for nm in ("wo", "w_down"):
        dense[nm] = (dense[nm].float() * torch.tensor(scales)[:, None, None]
                     ).to(tcfg.dtype)
    embed = (torch.randn((512, 256), generator=gen) * 0.02).to(tcfg.dtype)
    head = (torch.randn((256, 512), generator=gen) * 0.02).to(tcfg.dtype)
    want = tq.quantize_params(
        {"embed": embed, "layers": dense, "lm_head": head,
         "final_norm_w": torch.ones(256, dtype=tcfg.dtype)},
        kind=kind, fuse=True)
    assert_same_bits(got, want)


# ---------------------------------------------------------------------------
# engine/model_loader.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(jml.SYNTHETIC_PRESETS))
def test_synthetic_preset_configs_match_jax(preset):
    assert tml.SYNTHETIC_PRESETS[preset] == jml.SYNTHETIC_PRESETS[preset]
    assert_config_equal(
        ModelConfig(dtype=torch.bfloat16, **tml.SYNTHETIC_PRESETS[preset]),
        jm.ModelConfig(dtype=jnp.bfloat16, **jml.SYNTHETIC_PRESETS[preset]))


def test_synthetic_tokenizer_matches_jax():
    text = "Speculative décodage, 42 ✓"
    t, j = tml.SyntheticTokenizer(2048), jml.SyntheticTokenizer(2048)
    assert t.encode(text) == j.encode(text)
    assert t.decode(t.encode(text)) == j.decode(j.encode(text)) == text
    assert (t.pad_token_id, t.eos_token_id) == (j.pad_token_id,
                                                 j.eos_token_id)
    assert t("ab") == j("ab")


def test_layerskip_damping_and_views():
    """-ls<k> damps wo/w_down of layers >= k by 0.08 (the crc32-seeded
    init otherwise); a quantized -ls<k> target is init_quantized_params
    with that damping as its layer_out_scales; layerskip:<k> gives the
    target's first k layers as views of its quantized containers."""
    cfg = ModelConfig(dtype=torch.float32, **tml.SYNTHETIC_PRESETS["tiny"])
    plain = tm.init_params(cfg, seed=zlib.crc32(b"tiny") % 2 ** 31,
                           device="cpu")
    damped = tml._synthetic("synthetic:tiny-ls2", torch.float32,
                            device="cpu")["params"]
    for nm in ("wo", "w_down"):
        assert torch.equal(damped["layers"][nm][:2], plain["layers"][nm][:2])
        assert torch.equal(damped["layers"][nm][2:],
                           plain["layers"][nm][2:] * np.float32(0.08))
    assert torch.equal(damped["layers"]["wq"], plain["layers"]["wq"])
    with pytest.raises(ValueError):
        tml._synthetic("synthetic:tiny-ls4", torch.float32, device="cpu")

    b = tml.load_models("synthetic:tiny-ls2", "layerskip:2",
                        dtype=torch.float32, quantization="int4",
                        device="cpu")
    t, d = b["target"], b["drafter"]
    assert_same_bits(t["params"], tq.init_quantized_params(
        cfg, seed=zlib.crc32(b"tiny") % 2 ** 31, kind="int4",
        layer_out_scales=[1.0, 1.0, 0.08, 0.08], device="cpu"))
    assert d["cfg"] == t["cfg"].replace(num_layers=2)
    assert d["quantized"] == t["quantized"] == "int4"
    for k, v in d["params"]["layers"].items():
        full = t["params"]["layers"][k]
        if isinstance(v, tq.QUANTIZED):
            v, full = v.packed, full.packed
        assert v.shape[0] == 2 and v.data_ptr() == full.data_ptr(), k
    assert d["params"]["lm_head"] is t["params"]["lm_head"]


def test_eagle_spec_shapes_match_jax():
    """eagle:<depth> builds an untrained head with JAX's shapes, seeded by
    crc32 of eagle:<target>:<depth> (the same numbers each call)."""
    ours = tml.load_models("synthetic:tiny", "eagle:2", dtype=torch.float32,
                           device="cpu")
    theirs = jml.load_models("synthetic:tiny", "eagle:2", dtype=jnp.float32)
    assert ours["drafter"]["eagle"] and theirs["drafter"]["eagle"]
    assert ours["drafter"]["cfg"].num_layers == 2
    ref = jax.tree.map(lambda x: (tuple(x.shape), np.asarray(x).dtype.name),
                       theirs["drafter"]["params"])
    got = {"fc_w": ours["drafter"]["params"]["fc_w"],
           "fc_b": ours["drafter"]["params"]["fc_b"],
           "layers": ours["drafter"]["params"]["layers"]}
    got = {k: ({n: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for n, t in v.items()} if isinstance(v, dict)
               else (tuple(v.shape), str(v.dtype).split(".")[-1]))
           for k, v in got.items()}
    assert got == ref
    again = tml.load_models("synthetic:tiny", "eagle:2", dtype=torch.float32,
                            device="cpu")
    assert torch.equal(again["drafter"]["params"]["fc_w"],
                       ours["drafter"]["params"]["fc_w"])


def test_load_models_checkpoint_matches_jax(ckpts):
    """A checkpoint directory: the tokenizer's output, the end tokens
    (EOS and <|im_end|>), the pad fallback to EOS and the params equal
    JAX's; the drafter checkpoint loads the same way."""
    path = ckpts["llama_f32"]
    ours = tml.load_models(path, path, dtype=torch.float32, device="cpu")
    theirs = jml.load_models(path, path, dtype=jnp.float32)
    assert ours["end_tokens"] == theirs["end_tokens"] == [2, 3]
    assert ours["pad_token_id"] == theirs["pad_token_id"] == 2
    text = "tell me about speculative decoding hello"
    assert ours["tokenizer"].encode(text) == theirs["tokenizer"].encode(text)
    for role in ("target", "drafter"):
        assert_config_equal(ours[role]["cfg"], theirs[role]["cfg"])
        assert_same_bits(ours[role]["params"],
                         jax.tree.map(np.asarray, theirs[role]["params"]))
    q = tml.load_models(path, None, dtype=torch.float32, quantization="int8",
                        kv_quant="int8", device="cpu")
    assert q["target"]["quantized"] == "int8"
    assert q["target"]["cfg"].kv_quant == "int8"


def _t5_dir(tmp_path):
    d = tmp_path / "t5"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "t5"}))
    return str(d)


@pytest.mark.parametrize("case", ["t5", "mesh", "vllm_tp"])
def test_later_slices_raise_not_implemented(case, tmp_path, monkeypatch):
    """Every spec of the JAX entry points is ported now. T5, once item 2,
    goes to the codec loader (tests/test_torch_codec.py), which looks for
    its weights. A mesh (TP_SIZE, or the facade's tensor_parallel_size)
    builds on a world of one process per card (tests/test_torch_parallel.py):
    a single process that was launched as no rank of a world raises a
    ValueError naming the launch, before anything loads."""
    if case == "t5":
        with pytest.raises(FileNotFoundError, match="model.safetensors"):
            tml.load_models(_t5_dir(tmp_path), device="cpu")
        return
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        if case == "mesh":
            from specdec_tpu_torch.engine.benchmark_runner import (
                BenchmarkRunner,
            )
            monkeypatch.setenv("TP_SIZE", "2")
            BenchmarkRunner(device="cpu")
        else:
            from specdec_tpu_torch.engine.vllm_compat import (
                VLLMConfig, VLLMEngineManager,
            )
            VLLMEngineManager(VLLMConfig(model="synthetic:tiny",
                                         tensor_parallel_size=2),
                              device="cpu").initialize(num_slots=1)


# ---------------------------------------------------------------------------
# the route of 4-bit shapes the card's kernels do not take
# ---------------------------------------------------------------------------

def test_check_kernel_shapes_refuses_on_cuda_only():
    """check_kernel_shapes reports each projection's route by its K: a
    4-bit weight whose K is no multiple of 256 goes to the dequant route
    (hidden 192: wqkv, wo, w_gateup and the lm_head; w_down K=256 takes
    its kernel), INT8 always takes its kernel, and "none" has no
    projection to route. Nothing is refused on any device any more."""
    cfg = ModelConfig(vocab_size=256, hidden_size=192, intermediate_size=256,
                      num_layers=1, num_heads=3, num_kv_heads=1, head_dim=64)
    for kind in ("int4", "nf4", "fp4"):
        assert tq.check_kernel_shapes(cfg, kind) == {
            "wqkv": "dequant", "wo": "dequant", "w_gateup": "dequant",
            "w_down": "kernel", "lm_head": "dequant"}
    assert set(tq.check_kernel_shapes(cfg, "int8").values()) == {"kernel"}
    assert tq.check_kernel_shapes(cfg, "none") == {}
    wide = cfg.replace(hidden_size=256, num_heads=4, intermediate_size=704)
    routes = tq.check_kernel_shapes(wide, "int4")
    assert routes.pop("w_down") == "dequant"
    assert set(routes.values()) == {"kernel"}
    with pytest.raises(ValueError, match=r"wqkv has K=96.*'int8' or 'none'"):
        tq.check_kernel_shapes(cfg.replace(hidden_size=96), "nf4")
    assert tq.check_kernel_shapes(cfg.replace(hidden_size=96), "int8")


@pytest.mark.parametrize("entry", ["synthetic", "streamed", "load_models"])
def test_loaders_refuse_before_any_launch(entry, ckpts):
    """The loaders no longer refuse 4-bit shapes the kernels do not take:
    the test checkpoint (hidden 64, intermediate 128) streams into NF4 and
    loads through load_models in FP4 with a LayerSkip drafter, and every
    projection of a forward goes through the dequant route (3 layers x 4
    projections + the lm_head), its logits the dequantized weights'.
    ``synthetic:llama-70m`` (intermediate 1376 = 21.5 blocks of 64) still
    raises before anything is made, as the JAX quantizer asserts: no 4-bit
    format holds that K."""
    from specdec_tpu_torch.ops import quant_matmul as tqm

    if entry == "synthetic":
        with pytest.raises(ValueError, match="w_down has K=1376"):
            tml._synthetic("synthetic:llama-70m", torch.bfloat16, "int4",
                           device="cpu")
        return
    if entry == "streamed":
        cfg, params = tsl.load_hf_streamed(ckpts["llama_f32"],
                                           dtype=torch.float32,
                                           quantization="nf4", device="cpu")
    else:
        bundle = tml.load_models(ckpts["llama_f32"], "layerskip:1",
                                 dtype=torch.float32, quantization="fp4",
                                 device="cpu")
        cfg, params = bundle["target"]["cfg"], bundle["target"]["params"]
        assert bundle["drafter"]["cfg"].num_layers == 1
    tokens = torch.tensor([[5, 9, 33, 2]])
    before = tqm.dequant_matmul.calls
    logits = tm.forward_full(cfg, params, tokens)
    assert tqm.dequant_matmul.calls - before == 3 * 4 + 1
    dense = {k: v for k, v in params.items() if k != "layers"}
    dense["lm_head"] = tq.dequantize(params["lm_head"])
    dense["layers"] = {k: tq.dequantize(v) if isinstance(v, tq.QUANTIZED)
                       else v for k, v in params["layers"].items()}
    torch.testing.assert_close(logits, tm.forward_full(cfg, dense, tokens),
                               rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["load_hf_model", "tokenizer"])
def test_missing_transformers_raises_import_error(ckpts, monkeypatch, entry):
    """Where transformers is missing (as on the card's machine), the
    whole-model loader and a checkpoint's tokenizer raise an ImportError
    naming it, before any weight is read; the streamed loader needs none."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        if entry == "load_hf_model":
            thf.load_hf_model(ckpts["llama_f32"], device="cpu")
        else:
            tml.load_models(ckpts["llama_f32"], device="cpu")
    cfg, _ = tsl.load_hf_streamed(ckpts["llama_f32"], device="cpu")
    assert cfg.num_layers == 3
