"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, a sample
of the requests that finished in the window, drawn from the seed and
always holding the one with the most served tokens, goes through the
plain reference (``reference.py``) once, prompt and served tokens
together. Each served token is greedy, so its logit should be the
reference's best at its position: ``max_logit_gap`` is the widest gap by
which a served token's reference logit lies below the reference's best.
The run is also held to exact rules: every finished request served the
tokens it asked for, every request live when the window opened made
progress in it, no request live at its close sits at its first token, and
at least one request finished in it.

The control (``calibrate.py`` and the tests) reads, at each position of
the same sequences, the gap of the token that the reference computed a
precision lower puts first: ``fp8`` (every bf16 tensor in float8), and
beside it ``w4a8`` (float8 weight-product inputs only). ``control`` judges
that reading by ``decide`` and ``passed``, the rules the program's run is
held to.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import Reference

# the sample: requests until this many served tokens, at most MAX_SAMPLE
# (some tens of requests, so that one slot at fault is likely among them)
MIN_TOKENS = 2048
MAX_SAMPLE = 32


def sample(run, seed: int) -> List[int]:
    """Ids of the sampled requests: the finished one with the most served
    tokens, then others drawn from the seed until MIN_TOKENS are served."""
    done = sorted(rid for rid, q in run.reqs.items()
                  if run.in_window(q.end) and rid in run.outputs)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(run.outputs[r]), -r))
    rest = [r for r in done if r != longest]
    rest = list(np.random.default_rng([seed % 2 ** 64, 2]).permutation(rest))
    out, n = [longest], len(run.outputs[longest])
    for r in rest:
        if n >= MIN_TOKENS or len(out) >= MAX_SAMPLE:
            break
        out.append(int(r))
        n += len(run.outputs[r])
    return out


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """ref [n, V] reference logits; chosen [n] token ids: the gap of each
    chosen token below the row's best."""
    return ref.max(dim=-1).values - ref.gather(1, chosen[:, None])[:, 0]


def readings(run, traffic, device, control: bool = False) -> Dict[str, float]:
    """The sample's widest served-token gap under the reference, and with
    ``control`` the widest gap of the lower-precision references' first
    choices (``control_max_logit_gap``: fp8; ``w4a8_max_logit_gap``)."""
    ids = sample(run, run.seed)
    out: Dict[str, float] = {"sampled_requests": len(ids),
                             "sampled_tokens": 0}
    if not ids:
        return out
    seqs, starts, served = [], [], []
    for rid in ids:
        p = traffic.prompt(rid)
        o = run.outputs[rid]
        seqs.append(p + o)
        starts.append(len(p))
        served.append(torch.tensor(o, dtype=torch.int64, device=device))
    quants = (None, "fp8", "w4a8") if control else (None,)
    logits = Reference(run.config, device).run(seqs, starts, quants)
    g = torch.cat([gaps(r, s) for r, s in zip(logits[None], served)])
    out["sampled_tokens"] = int(g.numel())
    out["max_logit_gap"] = float(g.max())
    for q, key in (("fp8", "control_max_logit_gap"),
                   ("w4a8", "w4a8_max_logit_gap")):
        if q in logits:
            c = torch.cat([gaps(r, f.argmax(dim=-1))
                           for r, f in zip(logits[None], logits[q])])
            out[key] = float(c.max())
    return out


def live_at_start(run, q) -> bool:
    """Whether request ``q`` had committed tokens and was unfinished when
    the window opened."""
    return q.at_start > 0 and not (q.end is not None and q.end < run.t_start)


def stalled_ids(run) -> List[int]:
    """Requests that a healthy engine would have advanced: live when the
    window opened and neither finished in it nor committed a token in it,
    or live at its close with no token past the admission's first (the
    step that admits a request runs its windows too)."""
    return [rid for rid, q in run.reqs.items()
            if (live_at_start(run, q) and not run.in_window(q.end)
                and q.at_end <= q.at_start)
            or (q.first is not None and q.end is None and q.at_end <= 1)]


def decide(run, reading: Dict[str, float], limit: float
           ) -> Dict[str, Dict[str, float]]:
    """Each number compared, with its limit ("max" or "min")."""
    done = [q for q in run.reqs.values() if run.in_window(q.end)]
    gap = reading.get("max_logit_gap")
    return {
        "finished_in_window": {"value": len(done), "min": 1},
        "short_outputs": {"value": sum(q.generated != q.asked for q in done),
                          "max": 0},
        "stalled_requests": {"value": len(stalled_ids(run)), "max": 0},
        "max_logit_gap": {"value": gap, "max": limit},
    }


def control(run, reading: Dict[str, float], limit: float,
            key: str = "control_max_logit_gap"
            ) -> Dict[str, Dict[str, float]]:
    """The checks of the run with the control's widest gap in place of the
    program's: the control has to come out not correct."""
    return decide(run, {"max_logit_gap": reading.get(key)}, limit)


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number present and within its limit."""
    return all(c["value"] is not None
               and ("max" not in c or c["value"] <= c["max"])
               and ("min" not in c or c["value"] >= c["min"])
               for c in checks.values())


def free_memory():
    """Collect the program's freed state and return the cache to the card
    before the reference runs."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
