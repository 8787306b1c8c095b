#!/usr/bin/env python3
"""Readings that set a cell's comparison limits (not run by the benchmark).

    python3 frame_bench/control.py --workload <cell> --seeds 1,2,3 [--control] [--seconds 2]

Runs the cell once per seed in one process, each with a short window at
the cell's own size and load, and prints each seed's compared numbers
(worst over the run's compared frames) as one JSON line, then the
largest of each over the seeds. Without ``--control`` these are the
program's readings (the lower end of each limit); with ``--control``
the program runs its 11-bit HDR path (bf16 accumulator and color /
emission history: the step below the configuration's 64-bit HDR target),
whose readings must fail the limits (the upper end). Needs a CUDA device.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()

    import torch

    from bench_core import spec
    from bench_core.harness import run_cell

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t,
                       hdr_64bit=False if args.control else None)
        values = {k: c["value"] for k, c in out["checks"].items()}
        for k, v in values.items():
            worst[k] = max(worst.get(k, v), v)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": out["correct"], "frames": out["attempted"],
                          "numbers": values, "run_s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control, "worst": worst,
                      "total_s": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
