"""The port's interactive REPL (``specdec_tpu_torch/cli/repl.py``) against
the JAX package's (``specdec_tpu/cli/repl.py``): both driven by one
scripted ``input()`` over one llama checkpoint with a word-level tokenizer
(tests/test_torch_loader.py builds both), loaded in float32. Every printed
line, the generated texts and acceptance rates of each tag included,
matches line for line once the times are masked; throughput lines, which
are ratios of times, are left out."""
import functools
import json
import random
import re

import pytest
import jax.numpy as jnp
import torch

from specdec_tpu.cli import repl as jrepl

from specdec_tpu_torch.cli import repl as trepl

from test_torch_loader import build_hf, write_tokenizer

torch.set_num_threads(2)

TAGS = ("[speculative]", "[ngram-assist]", "[target AR]", "[drafter AR]")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("repl_llama")
    build_hf("llama").save_pretrained(path)
    write_tokenizer(path)
    return str(path)


def masked(out: str):
    """The printed lines with times masked, throughput lines left out."""
    return [re.sub(r"\(\d+\.\d+s", "(<t>s", line)
            for line in out.splitlines() if "throughput" not in line]


def drive(package, path, lines, monkeypatch, capsys):
    """Build ``package``'s REPL on the checkpoint (float32, the port on the
    CPU) and run it over the scripted ``lines``; returns (the REPL, its
    masked output after construction)."""
    if package == "jax":
        module, dtype, kw = jrepl, jnp.float32, {}
    else:
        module, dtype, kw = trepl, torch.float32, {"device": "cpu"}
    with monkeypatch.context() as m:
        m.setattr(module, "load_models",
                  functools.partial(module.load_models, dtype=dtype))
        cli = module.InferenceCLI(path, path, **kw)
        capsys.readouterr()
        feed = iter(lines)

        def fake_input(*_):
            try:
                return next(feed)
            except StopIteration:
                raise EOFError
        m.setattr("builtins.input", fake_input)
        random.seed(0)   # /random and auto draw from the global generator
        cli.run()
    return cli, masked(capsys.readouterr().out)


@pytest.fixture
def env(monkeypatch, tmp_path):
    monkeypatch.setenv("GENERATION_LENGTH", "6")
    monkeypatch.setenv("GAMMA_VALUE", "3")
    monkeypatch.setenv("SHAREGPT_DIR", str(tmp_path / "missing"))
    return tmp_path


def test_repl_matches_jax(ckpt, env, monkeypatch, capsys):
    """/gamma, /length, /ngram, /drafter, /processor, two prompts around
    /set_ngramstorage: the same printed lines (every tag's text and
    acceptance) and the same state afterwards."""
    lines = ["/gamma 3", "/length 6", "/ngram", "/drafter",
             "/processor greedy", "tell me about speculative decoding",
             "/set_ngramstorage onelevel 2", "the cat sat on a mat"]
    ours, got = drive("torch", ckpt, lines, monkeypatch, capsys)
    theirs, ref = drive("jax", ckpt, lines, monkeypatch, capsys)
    assert got == ref
    for tag in TAGS:
        assert sum(line.startswith(tag) for line in got) == 2, tag
    assert "accept 1.000" in next(x for x in got
                                  if x.startswith("[speculative]"))
    for attr in ("gamma", "gen_len", "spec", "dr", "target_gen",
                 "ngram_gen", "chat", "ngram_n", "top_k_filler"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert type(ours.ngram).__name__ == type(theirs.ngram).__name__ == \
        "OneLevelNGramStorage"
    assert type(ours.processor).__name__ == "GreedyProcessor"
    assert ours.device == torch.device("cpu")


def test_repl_errors_and_random_match_jax(ckpt, env, monkeypatch, capsys):
    """Bad commands print the same usage lines; /random and auto 1 draw
    from a ShareGPT JSONL (the same prompts, seeded alike) and print the
    same runs; with no ShareGPT file the fallback prompt runs."""
    sharegpt = env / "sharegpt"
    sharegpt.mkdir()
    with open(sharegpt / "sharegpt_gpt4.jsonl", "w") as f:
        for text in ("hello world the cat sat", "what is systolic array for",
                     "tell me about drafts verify tokens"):
            f.write(json.dumps({"conversations": [
                {"from": "human", "value": text},
                {"from": "gpt", "value": "ok"}]}) + "\n")
    lines = ["/gamma", "/length", "/processor", "/processor foo",
             "/processor topk 1.0", "/processor greedy abc",
             "/set_ngramstorage basic", "/set_ngramstorage foo 2", "/bogus",
             "/random", "auto 1"]
    monkeypatch.setenv("SHAREGPT_DIR", str(sharegpt))
    _, got = drive("torch", ckpt, lines, monkeypatch, capsys)
    _, ref = drive("jax", ckpt, lines, monkeypatch, capsys)
    assert got == ref
    for usage in ("Usage: /gamma <value>", "Missing argument top_k",
                  "Invalid argument temperature (expected float)",
                  "Usage: /set_ngramstorage <basic/onelevel> <n>",
                  "Invalid ngram type", "Unknown command"):
        assert usage in got, usage
    assert sum(line.startswith("[speculative]") for line in got) == 2

    monkeypatch.setenv("SHAREGPT_DIR", str(env / "missing"))
    _, got = drive("torch", ckpt, ["/random"], monkeypatch, capsys)
    assert any("robot learning to paint" in line for line in got)
    assert any(line.startswith("[target AR]") for line in got)


def test_repl_main_takes_device(ckpt, env, monkeypatch, capsys):
    """``main()`` parses --device and the model flags and runs the REPL on
    that device; /quit exits 0."""
    monkeypatch.setattr(trepl, "load_models", functools.partial(
        trepl.load_models, dtype=torch.float32))
    feed = iter(["/quit"])
    monkeypatch.setattr("builtins.input", lambda *_: next(feed))
    with pytest.raises(SystemExit) as done:
        trepl.main(["--target-model", ckpt, "--drafter-model", ckpt,
                    "--device", "cpu"])
    assert done.value.code == 0
    assert "Goodbye!" in capsys.readouterr().out
