"""A model family is a file (``families/<model_type>.py``):

- the move of the two families into their files changed no draw by a bit
  and no reference logit: digests equal to those of the harness before
  the move;
- a family the harness has never read (``qwen2``: q/k/v biases, no
  qk-norm; the port's ``config_from_hf`` reads it), with its own
  ``build_layers``, is added in a temporary root with a configuration, a
  mix and a cell, by new files and entries alone, and runs ``correct``
  traced and untraced; a fault planted in the program's path of that
  family is not correct;
- a toy family of the yardstick alone, whose odd layers hold an expert
  stack with fewer experts than the router routes over and whose even
  layers attend over a window, draws per-layer shapes deterministically
  and layer by layer, runs through the reference, and its FLOP count
  follows the active weights and the windowed keys."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench import measure
from portbench import weights as W
from portbench.conftest import ROOT, make_root, tiny_config
from portbench.reference import Reference
from portbench.run import main

# digests of tiny_config's draws and reference logits before the move
PARENT = {
    "qwen3": {"draws": "3418658cd21c6f18",
              "logits": {"None": "3b3c9e3aa55ffb62", "fp8": "cd65b7b9b78971fb",
                         "w4a8": "4aed3f4ced97eb0b"}},
    "gpt_neox": {"draws": "f839c3952629cb32",
                 "logits": {"None": "076a0027bff6b380",
                            "fp8": "211f69c877fb7e73",
                            "w4a8": "3c6f57ee46470e52"}},
}


def _digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


@pytest.fixture
def one_thread():
    """Reductions split over threads round otherwise: one thread, as the
    digests were taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family", ["qwen3", "gpt_neox"])
def test_draws_and_reference_equal_the_parent(family, one_thread):
    cfg = tiny_config(family)
    seed = cfg["weights"]["seed"]
    d = hashlib.sha256()
    for i in range(cfg["num_hidden_layers"]):
        for k, v in W.layer(cfg, seed, i, "cpu").items():
            d.update(f"{i}{k}{tuple(v.shape)}{_digest(v)}".encode())
    d.update(_digest(W.embedding(cfg, seed, "cpu")).encode())
    d.update(_digest(W.head(cfg, seed, "cpu")).encode())
    for k, v in W.final_norm(cfg, seed, "cpu").items():
        d.update(f"{k}{_digest(v) if v is not None else None}".encode())
    g = torch.Generator().manual_seed(7)
    seqs = [torch.randint(1, cfg["vocab_size"], (n,), generator=g).tolist()
            for n in (17, 30)]
    logits = Reference(cfg, "cpu").run(seqs, [5, 12], (None, "fp8", "w4a8"))
    got = {str(q): hashlib.sha256(b"".join(
        x.contiguous().numpy().tobytes() for x in v)).hexdigest()[:16]
        for q, v in logits.items()}
    assert {"draws": d.hexdigest()[:16], "logits": got} == PARENT[family]


QWEN2 = '''"""qwen2 (Qwen2ForCausalLM): qwen3's block with q/k/v biases and no
q/k norm."""
import torch

from portbench.measure import causal_keys
from portbench.reference import rms, rope

RESIDUAL = ("wo", "w_down")


def arch(cfg):
    D, Hq = cfg["hidden_size"], cfg["num_attention_heads"]
    Dh = D // Hq
    return dict(L=cfg["num_hidden_layers"], D=D, F=cfg["intermediate_size"],
                V=cfg["vocab_size"], Hq=Hq, Hk=cfg["num_key_value_heads"],
                Dh=Dh, theta=float(cfg["rope_theta"]),
                eps=float(cfg["rms_norm_eps"]), norm="rms")


def tensors(a, i):
    D, F, Dh, Hq, Hk = a["D"], a["F"], a["Dh"], a["Hq"], a["Hk"]
    return {"wq": ((D, Hq * Dh), "proj"), "wk": ((D, Hk * Dh), "proj"),
            "wv": ((D, Hk * Dh), "proj"), "wo": ((Hq * Dh, D), "proj"),
            "w_gate": ((D, F), "proj"), "w_up": ((D, F), "proj"),
            "w_down": ((F, D), "proj"),
            "attn_norm_w": ((D,), "norm_w"), "mlp_norm_w": ((D,), "norm_w"),
            "bq": ((Hq * Dh,), "bias"), "bk": ((Hk * Dh,), "bias"),
            "bv": ((Hk * Dh,), "bias")}


def block(a, i, x, pos, lw, ops):
    T, Hq, Hk, Dh = x.shape[0], a["Hq"], a["Hk"], a["Dh"]
    h = rms(x, lw["attn_norm_w"], a["eps"])
    q = ops.mm(h, lw["wq"], lw["bq"]).view(T, Hq, Dh)
    k = ops.mm(h, lw["wk"], lw["bk"]).view(T, Hk, Dh)
    v = ops.mm(h, lw["wv"], lw["bv"]).view(T, Hk, Dh)
    q = ops.r(rope(q, pos, Dh, a["theta"]))
    k = ops.r(rope(k, pos, Dh, a["theta"]))
    x = x + ops.mm(ops.attend(q, k, v).reshape(T, Hq * Dh), lw["wo"])
    m = rms(x, lw["mlp_norm_w"], a["eps"])
    u = torch.nn.functional.silu(ops.mm(m, lw["w_gate"])) * ops.mm(
        m, lw["w_up"])
    return ops.r(x + ops.mm(u, lw["w_down"]))


def weights_per_token(a):
    D, F, Dh, Hq, Hk = a["D"], a["F"], a["Dh"], a["Hq"], a["Hk"]
    return a["L"] * (D * (Hq + 2 * Hk) * Dh + Hq * Dh * D + 3 * D * F)


def keys_scored(a, first, last):
    return a["L"] * causal_keys(first, last)


def build_layers(cfg, dense, fmt):
    """The program's stack, built as the harness builds it by default."""
    from specdec_tpu_torch.quant.core import quantize_params, stack_layers

    return stack_layers((quantize_params({"layers": d}, kind=fmt, fuse=True)
                         ["layers"] for d in dense),
                        cfg["num_hidden_layers"])
'''


def qwen2_root(tmp: Path, arrivals: str) -> Path:
    """The benchmark with a qwen2 family, a tiny qwen2 configuration, a
    mix and a cell added as new files and entries."""
    root = make_root(tmp, family="qwen3", arrivals=arrivals)
    (root / "portbench" / "families" / "qwen2.py").write_text(QWEN2)
    cfg = tiny_config("qwen3")
    cfg.update(model_type="qwen2", architectures=["Qwen2ForCausalLM"])
    for key in ("head_dim", "attention_bias"):
        cfg.pop(key)
    (root / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(cfg))
    return root


def _line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _unedited(root: Path):
    """Every file of the benchmark is in the root as it is here."""
    for p in (ROOT / "portbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            q = root / p.relative_to(ROOT)
            assert q.read_bytes() == p.read_bytes(), p


@pytest.mark.parametrize("trace", [0, 1])
def test_a_family_added_by_files_alone(tmp_path, capsys, trace):
    root = qwen2_root(tmp_path, "poisson")
    rc = main(["--workload", "tiny.poisson", "--seed", str(2 ** 31 + 21),
               "--seconds", "3", "--trace", str(trace)], root=root,
              device="cpu")
    assert rc == 0
    line = _line(capsys.readouterr().out)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["max_logit_gap"]["value"] > 0
    names = set(line["metrics"])
    assert ({"draft_device_ms", "host_syncs_per_step", "mfu"} if trace
            else {"out_tok_s", "setup_s"}) <= names
    _unedited(root)


def test_a_fault_in_the_added_family_is_not_correct(tmp_path, capsys,
                                                    monkeypatch):
    """The program serves qwen2 without its q/k/v biases."""
    from portbench import harness

    build = harness.Program.__init__

    def biasless(self, cfg, device):
        build(self, cfg, device)
        self.target["layers"]["bqkv"].zero_()
    monkeypatch.setattr(harness.Program, "__init__", biasless)
    root = qwen2_root(tmp_path, "poisson")
    rc = main(["--workload", "tiny.poisson", "--seed", str(2 ** 31 + 21),
               "--seconds", "3", "--trace", "0"], root=root, device="cpu")
    assert rc == 0
    line = _line(capsys.readouterr().out)
    assert line["correct"] is False, line["checks"]


TOY = '''"""A toy family of the yardstick alone: even layers attend over a
window of WINDOW keys through a dense SwiGLU; odd layers attend over every
key through a sigmoid-routed expert layer, of whose E experts this chip
holds the first E_held, computing their part of each routed token."""
import torch

from portbench.measure import causal_keys, window_keys

RESIDUAL = ("wo", "w_down", "experts_down")


def arch(cfg):
    return dict(L=cfg["num_hidden_layers"], D=cfg["hidden_size"],
                F=cfg["intermediate_size"], Fe=cfg["moe_intermediate_size"],
                E=cfg["n_routed_experts"], E_held=cfg["experts_held"],
                top_k=cfg["num_experts_per_tok"], window=cfg["window"],
                V=cfg["vocab_size"], Hq=cfg["num_attention_heads"],
                Hk=cfg["num_key_value_heads"], Dh=cfg["head_dim"],
                eps=1e-6, norm="rms")


def tensors(a, i):
    D, Dh, Hq, Hk = a["D"], a["Dh"], a["Hq"], a["Hk"]
    out = {"wq": ((D, Hq * Dh), "proj"), "wk": ((D, Hk * Dh), "proj"),
           "wv": ((D, Hk * Dh), "proj"), "wo": ((Hq * Dh, D), "proj"),
           "attn_norm_w": ((D,), "norm_w"), "mlp_norm_w": ((D,), "norm_w")}
    if i % 2:
        E, Fe = a["E_held"], a["Fe"]
        out.update(router=((D, a["E"]), "proj"),
                   experts_gate=((E, D, Fe), "proj"),
                   experts_up=((E, D, Fe), "proj"),
                   experts_down=((E, Fe, D), "proj"))
    else:
        out.update(w_gate=((D, a["F"]), "proj"), w_up=((D, a["F"]), "proj"),
                   w_down=((a["F"], D), "proj"))
    return out


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def block(a, i, x, pos, lw, ops):
    silu = torch.nn.functional.silu
    T, Hq, Hk, Dh = x.shape[0], a["Hq"], a["Hk"], a["Dh"]
    h = _rms(x, lw["attn_norm_w"], a["eps"])
    q = ops.mm(h, lw["wq"]).view(T, Hq, Dh)
    k = ops.mm(h, lw["wk"]).view(T, Hk, Dh)
    v = ops.mm(h, lw["wv"]).view(T, Hk, Dh)
    o = ops.attend(q, k, v, window=None if i % 2 else a["window"])
    x = x + ops.mm(o.reshape(T, Hq * Dh), lw["wo"])
    m = _rms(x, lw["mlp_norm_w"], a["eps"])
    if not i % 2:
        u = silu(ops.mm(m, lw["w_gate"])) * ops.mm(m, lw["w_up"])
        return ops.r(x + ops.mm(u, lw["w_down"]))
    score = torch.sigmoid(m @ lw["router"])
    top = score.topk(a["top_k"], dim=-1)
    gate = torch.zeros_like(score).scatter(
        -1, top.indices, top.values / top.values.sum(-1, keepdim=True))
    y = torch.zeros_like(x)
    for e in range(a["E_held"]):
        rows = gate[:, e].nonzero()[:, 0]
        if len(rows):
            me = m[rows]
            u = silu(ops.mm(me, lw["experts_gate"][e])) * ops.mm(
                me, lw["experts_up"][e])
            y[rows] += gate[rows, e, None] * ops.mm(u, lw["experts_down"][e])
    return ops.r(x + y)


def weights_per_token(a):
    D, Dh, Hq, Hk = a["D"], a["Dh"], a["Hq"], a["Hk"]
    attn = D * (Hq + 2 * Hk) * Dh + Hq * Dh * D
    moe = D * a["E"] + a["top_k"] * 3 * D * a["Fe"]
    dense = 3 * D * a["F"]
    odd = a["L"] // 2
    return a["L"] * attn + odd * moe + (a["L"] - odd) * dense


def keys_scored(a, first, last):
    odd = a["L"] // 2
    return (odd * causal_keys(first, last)
            + (a["L"] - odd) * window_keys(first, last, a["window"]))
'''


@pytest.fixture
def toy(tmp_path):
    (tmp_path / "toy_moe.py").write_text(TOY)
    return {"model_type": "toy_moe", "family_dir": str(tmp_path),
            "num_hidden_layers": 4, "hidden_size": 64,
            "intermediate_size": 128, "moe_intermediate_size": 64,
            "n_routed_experts": 8, "experts_held": 3,
            "num_experts_per_tok": 2, "window": 4, "vocab_size": 128,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 32,
            "weights": {"seed": 3, "init_scale": 0.08, "norm_jitter": 0.05},
            "drafter": {"exit_layer": 2, "tail_damp": 0.08}}


def test_toy_family_draws_layer_by_layer(toy):
    seed = 2 ** 33 + 1
    layers = [W.layer(toy, seed, i, "cpu") for i in range(4)]
    for i, lw in enumerate(layers):
        assert ("experts_up" in lw) == bool(i % 2)
        assert ("w_up" in lw) != bool(i % 2)
    assert layers[1]["experts_gate"].shape == (1, 3, 64, 64)
    assert layers[3]["experts_down"].shape == (1, 3, 64, 64)
    assert layers[1]["router"].shape == (1, 64, 8)   # routes over all 8
    # a layer drawn alone, after another or again is the same draw
    for i in (3, 0, 2):
        again = W.layer(toy, seed, i, "cpu")
        assert all(torch.equal(again[k], v) for k, v in layers[i].items())
    # the tail damping scales the expert layer's residual output alone
    undamped = W.layer(dict(toy, drafter={"exit_layer": 4,
                                          "tail_damp": 0.08}), seed, 3,
                       "cpu")
    for k, v in layers[3].items():
        ratio = 0.08 if k in ("wo", "experts_down") else 1.0
        assert torch.allclose(v.float(), undamped[k].float() * ratio,
                              rtol=1e-2, atol=1e-6), k


def test_toy_family_runs_through_the_reference(toy):
    g = torch.Generator().manual_seed(1)
    seqs = [torch.randint(0, 128, (n,), generator=g).tolist()
            for n in (9, 13)]
    out = Reference(toy, "cpu").run(seqs, [3, 6], (None, "fp8", "w4a8"))
    for q in (None, "fp8", "w4a8"):
        assert [x.shape for x in out[q]] == [(6, 128), (7, 128)]
        assert all(torch.isfinite(x).all() for x in out[q])
    assert not torch.equal(out[None][0], out["fp8"][0])


def test_toy_family_flops_follow_the_active_weights(toy):
    fam = W.family(toy)
    a = fam.arch(toy)
    attn = 64 * 4 * 32 + 2 * 32 * 64
    assert fam.weights_per_token(a) == (
        4 * attn + 2 * (64 * 8 + 2 * 3 * 64 * 64) + 2 * 3 * 64 * 128)
    # one more expert a token adds its three matrices in each expert layer
    more = fam.arch(dict(toy, num_experts_per_tok=3))
    assert fam.weights_per_token(more) - fam.weights_per_token(a) == \
        2 * 3 * 64 * 64
    # a 10-token prompt: the window layers score min(p + 1, 4) keys
    keys = 2 * 55 + 2 * (1 + 2 + 3 + 4 * 7)
    per_key = 4.0 * 2 * 32
    assert measure.required_flops(fam, a, [10], []) == (
        2.0 * fam.weights_per_token(a) * 10 + per_key * keys)
