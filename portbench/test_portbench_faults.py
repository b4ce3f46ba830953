"""``correct`` comes out false when the timed path is broken underneath:
the harness's look for a card is skipped (``device="cpu"``) and the rest
of a run is driven at tiny widths, once for each fault a serving cell can
have. The exchange between chips is no fault of these one-chip cells. And
the control, the reference with float8 activations in the program's
place, comes out not correct by the checks that the program's own runs
pass."""
import json

import pytest
import torch

from portbench.calibrate import main as calibrate
from portbench.run import main

SEED = 2 ** 31 + 77


def _state_unchanged(monkeypatch):
    from specdec_tpu_torch.serve import scheduler

    def same(*args, **kw):
        return args[4]
    monkeypatch.setattr(scheduler, "batch_spec_windows", same)
    monkeypatch.setattr(scheduler, "batch_spec_window", same)


def _half_batch(monkeypatch):
    """The windows advance the first half of the slots only."""
    from specdec_tpu_torch.serve import scheduler

    real = scheduler.batch_spec_windows

    def half(*args, **kw):
        old = args[4]
        keep = {k: getattr(old, k).clone() for k in
                ("pos", "finished", "accepted", "speculated")}
        new = real(*args, **kw)
        h = new.pos.shape[0] // 2
        for k, v in keep.items():
            getattr(new, k)[h:] = v[h:]
        return new
    monkeypatch.setattr(scheduler, "batch_spec_windows", half)


def _token_altered(monkeypatch):
    """Each window's last committed token is replaced by its neighbour in
    the vocabulary where the commit step produces it."""
    from specdec_tpu_torch.engine import batch_engine

    real = batch_engine.commit_step

    def altered(drafts, n, next_tok, remaining, eos_ids):
        return real(drafts, n, (next_tok + 1) % 1024, remaining, eos_ids)
    monkeypatch.setattr(batch_engine, "commit_step", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(tiny_root, capsys, monkeypatch, fault):
    root = tiny_root(family="qwen3", arrivals="poisson")
    fault(monkeypatch)
    rc = main(["--workload", "tiny.poisson", "--seed", str(SEED),
               "--seconds", "2", "--trace", "0"], root=root, device="cpu")
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


def test_control_fails_the_limit(tiny_root, capsys):
    root = tiny_root(family="qwen3", arrivals="poisson")
    limit = json.loads((root / "portbench" / "configs" / "tiny.json"
                        ).read_text())["check"]["max_logit_gap"]
    seeds = [SEED, SEED + 1, SEED + 2]
    assert calibrate(["--workload", "tiny.poisson", "--seconds", "2",
                      "--seeds", ",".join(map(str, seeds))], root=root,
                     device="cpu") == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["seed"] for r in rows] == seeds
    for r in rows:
        assert r["correct"] is True, r
        assert r["max_logit_gap"] <= limit
        assert r["control_correct"] is False, r
        assert r["control_max_logit_gap"] > limit, r
    assert torch.float8_e4m3fn  # the control's type exists here
