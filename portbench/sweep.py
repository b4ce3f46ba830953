"""The chat mix's rate sweep: one program, one window at each offered
rate, one JSON line a rate on standard output (offered and completed
requests a second, output tokens a second, the queue at the window's open
and close, TTFT percentiles). The knee is the highest rate whose queue
does not grow through the window; the cell's rate is about four fifths of
it, written into the mix file.

    python3 -m portbench.sweep --workload qwen3-8b-ls8.chat --rates 3,4,5,6 --seconds 30

Card only, like the run.
"""
import argparse
import copy
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None, root=None, device=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    root = Path(root or os.getcwd())
    import torch

    from portbench.harness import Program, run_window
    from portbench.measure import percentile
    from portbench.run import Cell, log

    if device is None and not torch.cuda.is_available():
        log("portbench: no CUDA device; the sweep runs on the card only")
        return 2
    device = torch.device(device or "cuda")
    cell = Cell(root, args.workload)
    program = Program(cell.config, device)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(cell.mix)
        mix["arrivals"]["rate_per_s"] = rate
        run = run_window(program, cell.config, mix, cell.name, args.seed,
                         args.seconds, time.time())
        qs, w = list(run.reqs.values()), run.window_s
        ttft = [((q.first if q.first is not None and q.first <= run.t_end
                  else run.t_end) - q.due) * 1e3
                for q in qs if run.in_window(q.due)]
        print(json.dumps({
            "rate_per_s": rate, "window_s": w,
            "due_per_s": sum(run.in_window(q.due) for q in qs) / w,
            "admitted_per_s": sum(run.in_window(q.admit) for q in qs) / w,
            "finished_per_s": sum(run.in_window(q.end) for q in qs) / w,
            "out_tok_s": sum(q.at_end - q.at_start for q in qs) / w,
            "queued_open": run.queued[0], "queued_close": run.queued[1],
            "slot_occupancy": run.live_sum / max(run.steps, 1) / run.num_slots,
            "ttft_p50_ms": percentile(ttft, 50),
            "ttft_p90_ms": percentile(ttft, 90)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
