"""The port's checkpoints (``engine/checkpoint.py``) and the loader specs
that train at load (``engine/model_loader.py``): ``trained:<preset>[@n]``,
``eagle:<depth>@<steps>`` with EAGLE_SAVE, and ``eagle:<dir>``.

A checkpoint round trip is bit-exact for dense tensors of every dtype and
for every quantized container, and refuses to overwrite unless asked. The
loader specs hold tests/test_pretrain.py's and
tests/test_checkpoint_loading.py's assertions on the port; the stream of
``trained:`` is the JAX loader's (the same ``MarkovSpec``)."""
import dataclasses
import os
import zlib

import numpy as np
import pytest
import torch

from specdec_tpu.engine import pretrain as jp

from specdec_tpu_torch.engine import model_loader as tml
from specdec_tpu_torch.engine import optim
from specdec_tpu_torch.engine import pretrain as tp
from specdec_tpu_torch.engine.checkpoint import load_params, save_params
from specdec_tpu_torch.quant import core as tq

torch.set_num_threads(2)

INT_OF = {2: torch.int16, 4: torch.int32, 1: torch.int8, 8: torch.int64}


def same_bits(got, ref, path="params"):
    """Trees equal in structure, types, dtypes, shapes and bits."""
    assert type(got) is type(ref), path
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            same_bits(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, tq.QUANTIZED):
        for f in dataclasses.fields(ref):
            same_bits(getattr(got, f.name), getattr(ref, f.name),
                      f"{path}.{f.name}")
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        if got.dtype.is_floating_point:
            got = got.view(INT_OF[got.element_size()])
            ref = ref.view(INT_OF[ref.element_size()])
        assert torch.equal(got, ref), path


def sample_tree():
    """Dense f32 and bf16 leaves (a NaN, infinities and a negative zero
    among them), int32 bookkeeping, and every quantized container, 2D and
    stacked, nested as a model's params are."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((2, 256, 64), generator=g) * 0.05
    f32 = torch.randn((5, 7), generator=g)
    f32[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                               -0.0])
    return {
        "embed": f32,
        "final_norm_w": torch.randn(9, generator=g).to(torch.bfloat16),
        "steps": torch.arange(3, dtype=torch.int32),
        "lm_head": tq.quantize_int4(w[0]),
        "layers": {kind: getattr(tq, f"quantize_{kind}")(w)
                   for kind in ("int8", "int4", "nf4", "fp4")}
                  | {"attn_norm_w": torch.ones((2, 256),
                                               dtype=torch.bfloat16)},
    }


def test_round_trip_is_bit_exact(tmp_path):
    tree = sample_tree()
    path = save_params(str(tmp_path / "ckpt"), tree)
    assert path == str(tmp_path / "ckpt") and os.path.isdir(path)
    same_bits(load_params(path, device="cpu"), tree)


def test_refuses_to_overwrite_and_missing(tmp_path):
    tree = sample_tree()
    path = save_params(str(tmp_path / "ckpt"), tree)
    with pytest.raises(FileExistsError):
        save_params(path, {"x": torch.zeros(2)})
    same_bits(load_params(path, device="cpu"), tree)
    save_params(path, {"x": torch.zeros(2)}, overwrite=True)
    same_bits(load_params(path, device="cpu"), {"x": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "missing"), device="cpu")


def test_load_reads_weights_only(tmp_path):
    """A file that is not the port's format is refused; a pickled object
    is refused by torch's weights-only reader, never run."""
    bad = tmp_path / "bad"
    bad.mkdir()
    torch.save({"format": "other", "tensors": {}, "containers": {}},
               bad / "params.pt")
    with pytest.raises(ValueError, match="not a"):
        load_params(str(bad), device="cpu")
    torch.save({"format": object()}, bad / "params.pt")
    with pytest.raises(Exception, match="[Ww]eights only"):
        load_params(str(bad), device="cpu")


# ---------------------------------------------------------------------------
# the loader specs that train
# ---------------------------------------------------------------------------

def test_trained_loader_spec():
    """``trained:tiny@100`` pretrains the preset at load on the JAX
    loader's stream and pairs with ``layerskip:1`` (tests/test_pretrain.py's
    assertions); its params require no grad."""
    b = tml.load_models("trained:tiny@100", drafter_model_path="layerskip:1",
                        dtype=torch.float32, device="cpu")
    t = b["target"]
    assert np.isfinite(t["pretrain_nll"])
    assert t["pretrain_nll"] < np.log(t["cfg"].vocab_size) - 0.4
    assert t["stream_spec"].entropy_nats < t["pretrain_nll"]
    assert b["drafter"]["cfg"].num_layers == 1
    assert dataclasses.asdict(t["stream_spec"]) == dataclasses.asdict(
        jp.MarkovSpec(vocab_size=2048, num_states=2048, branching=8,
                      zipf_s=1.2, order=1,
                      seed=zlib.crc32(b"tiny") % 2 ** 31))
    assert not any(p.requires_grad for p in optim.leaves(t["params"]))


def test_trained_loader_quantizes_after_training(monkeypatch):
    """A quantized ``trained:`` target is trained dense, then quantized
    (fused, as every loader quantizes); the training settings are the JAX
    loader's."""
    seen = {}

    def fake_build(cfg, spec, **kw):
        seen.update(kw)
        from specdec_tpu_torch.core.model import init_params
        return init_params(cfg, seed=0, device=kw["device"]), 1.0
    monkeypatch.setattr(tp, "build_trained_target", fake_build)
    b = tml.load_models("trained:tiny@7", quantization="int4",
                        dtype=torch.float32, device="cpu")
    assert seen == dict(steps=7, batch_size=32, seq_len=128,
                        learning_rate=1e-3,
                        seed=zlib.crc32(b"trained:tiny@7") % 2 ** 31,
                        device=torch.device("cpu"))
    assert b["target"]["quantized"] == "int4"
    assert isinstance(b["target"]["params"]["layers"]["wqkv"],
                      tq.Int4Weight)
    seen.clear()
    tml.load_models("trained:tiny", device="cpu")
    assert seen["steps"] == 2000


def test_trained_loader_refuses_before_training(monkeypatch):
    """On a CUDA device (claimed here), a 4-bit ``trained:`` preset whose
    shapes the kernels refuse (llama-70m, F = 1376) raises before a
    training step."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_training(*a, **k):
        raise AssertionError("trained before the shapes were checked")
    monkeypatch.setattr(tp, "build_trained_target", no_training)
    with pytest.raises(ValueError, match="K=1376"):
        tml.load_models("trained:llama-70m@1", quantization="int4",
                        device="cuda")


def test_eagle_train_save_and_reload(tmp_path, monkeypatch):
    """``eagle:1@5`` trains a head on the target at load and EAGLE_SAVE
    writes it; ``eagle:<dir>`` reloads it bit for bit (depth from the
    stacked layer axis) and generation runs through it."""
    from specdec_tpu_torch.sampling.eagle_speculative import eagle_generate

    save_dir = str(tmp_path / "head")
    monkeypatch.setenv("EAGLE_SAVE", save_dir)
    monkeypatch.setenv("EAGLE_TRAIN_BATCH", "2")
    monkeypatch.setenv("EAGLE_TRAIN_SEQ", "16")
    b1 = tml.load_models("synthetic:tiny", "eagle:1@5", dtype=torch.float32,
                         device="cpu")
    untrained = tml.load_models("synthetic:tiny", "eagle:1",
                                dtype=torch.float32, device="cpu")
    assert not torch.equal(b1["drafter"]["params"]["fc_w"],
                           untrained["drafter"]["params"]["fc_w"])
    assert not any(p.requires_grad
                   for p in optim.leaves(b1["drafter"]["params"]))
    monkeypatch.delenv("EAGLE_SAVE")

    b2 = tml.load_models("synthetic:tiny", f"eagle:{save_dir}",
                         dtype=torch.float32, device="cpu")
    assert b2["drafter"]["eagle"]
    assert b2["drafter"]["cfg"] == b1["drafter"]["cfg"]
    assert b2["drafter"]["cfg"].num_layers == 1
    same_bits(b2["drafter"]["params"], b1["drafter"]["params"])
    out, rate = eagle_generate(
        [5, 9, 33, 2], b2["drafter"]["cfg"], b2["drafter"]["params"],
        b2["target"]["cfg"], b2["target"]["params"], gamma=3, max_gen_len=8,
        eos_tokens_id=(), seed=3, device="cpu")
    assert len(out) == 8 and 0.0 <= rate <= 1.0
