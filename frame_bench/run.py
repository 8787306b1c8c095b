#!/usr/bin/env python3
"""The frame benchmark of the PyTorch + CUDA port.

    python3 frame_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. It renders
the cell's frames through ``Renderer.render_frame`` for ``--seconds``,
checks the run's frames against the frozen plain reference
(``frame_bench/sspt_plain``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(with ``--trace 1`` also ``breakdown``) and, last, ``checks``: each
number compared beside its limit, which also end standard error.
Without a CUDA device, or with JAX or the JAX package loaded, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]  # the port, then the harness


def fail(msg: str) -> int:
    print(f"frame_bench: {msg}", file=sys.stderr)
    return 2


def device_block(out: dict, chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": out["memory_peak_bytes"]}


def result_line(out: dict, device: dict, trace: bool) -> dict:
    """The last line's keys in order; ``checks`` comes last."""
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if trace:
        line["device"] = {**device, "busy_s": out["busy_s"], "window_s": out["window_s"]}
        line["breakdown"] = out["breakdown"]
    # A number that is not finite (a frame with NaN) is written as text,
    # so the line stays strict JSON.
    line["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                          "limit": c["limit"]} for k, c in out["checks"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_core import guard, spec
    from bench_core.harness import run_cell

    cell = spec.load_cell(args.workload)
    need = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        return fail(f"needs {need} CUDA device(s); torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}")
    bad = guard.reference_violations(BENCH_DIR / "sspt_plain")
    if bad:
        return fail(f"the reference imports {bad}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   T_START)
    loaded = guard.forbidden_loaded()
    if loaded:
        return fail(f"modules of JAX or the JAX package were loaded: {loaded}")
    line = result_line(out, device_block(out, cell.chips), bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
