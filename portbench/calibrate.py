"""Readings that set the limit of ``max_logit_gap``: for each seed, one
process builds the cell's program, runs a window at the cell's own load,
frees the program and reads, on the same sample, the program's widest
served-token gap and the control's (the reference with float8
activations, ``reference.py``), each judged by the run's own checks
(``check.decide``): ``correct`` for the program, ``control_correct`` for
the control, which has to read false. One JSON line a seed on standard
output, with the window's memory peak.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 30

Card only, like the run; the benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None, root=None, device=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    root = Path(root or os.getcwd())
    import torch

    from portbench import check
    from portbench.harness import Program, run_window
    from portbench.run import Cell, log

    if device is None and not torch.cuda.is_available():
        log("portbench: no CUDA device; the calibration runs on the card only")
        return 2
    device = torch.device(device or "cuda")
    cell = Cell(root, args.workload)
    limit = cell.config["check"]["max_logit_gap"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        program = Program(cell.config, device)
        run = run_window(program, cell.config, cell.mix, cell.name, seed,
                         args.seconds, t0)
        del program
        check.free_memory()
        t1 = time.time()
        r = check.readings(run, run.traffic, device, control=True)
        checks = check.decide(run, r, limit)
        control = check.control(run, r, limit)
        print(json.dumps({
            "workload": cell.name, "seed": seed, **r,
            "correct": check.passed(checks), "checks": checks,
            "control_correct": check.passed(control),
            "w4a8_correct": check.passed(
                check.control(run, r, limit, "w4a8_max_logit_gap")),
            "setup_s": run.setup_s, "window_s": run.window_s,
            "check_s": time.time() - t1,
            "memory_peak_bytes": run.memory_peak_bytes,
            "kv_tokens": run.kv_tokens,
            "out_tok_s": sum(q.at_end - q.at_start
                             for q in run.reqs.values()) / run.window_s}),
            flush=True)
        del run
        check.free_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
