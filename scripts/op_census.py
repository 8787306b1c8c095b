#!/usr/bin/env python3
"""Device ops and device time of the real-time classroom frame, by the
port function that launched them.

    python3 scripts/op_census.py [--frames 4] [--height 1080 --width 1920]

From the repository root, on a machine with an NVIDIA GPU. Renders
chip_smoke.py's cell (h) (the classroom, SPATIAL_TEMPORAL, 2 bounces,
spp 1 adaptive to 4, hashed noise, the camera alternating between two
poses) for 9 warm-up frames, then profiles ``--frames`` more with
torch.profiler (CUPTI). Each device op is tied to the host call that
launched it by its correlation id and charged to the innermost of the
ranges put around these functions: the RNG's ``draw`` / ``draw2``,
``evaluate_brdf`` (outside its draws), the packed decode
(``hit_surface_from_packed``), the hiz march (``ray_march_hiz``), pass
0 (``trace_frame_hiz``, outside the others) and the frame (the rest).
Prints the ops and the device ms a frame of each, and the shares of
pixels that adaptive spp boosts to 4 samples: smoothness > 0.5 at each
pose, and a history count of 1 after the warm-up frames.
"""

from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (label, module, attribute): where the callers look each function up.
RANGES = (
    ("frame", "unitysspathtracingurp_tpu_torch.models.renderer", "Renderer.render_frame"),
    ("pass 0", "unitysspathtracingurp_tpu_torch.models.renderer", "trace_frame_hiz"),
    ("hiz march", "unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz", "ray_march_hiz"),
    ("decode", "unitysspathtracingurp_tpu_torch.ops.pathtrace", "hit_surface_from_packed"),
    ("evaluate_brdf", "unitysspathtracingurp_tpu_torch.ops.pathtrace", "evaluate_brdf"),
    ("draw", "unitysspathtracingurp_tpu_torch.ops.pathtrace", "draw"),
    ("draw2", "unitysspathtracingurp_tpu_torch.ops.pathtrace", "draw2"),
)
WARM_UP = 9


def install(record_function):
    """Wrap each function of ``RANGES`` in a profiler range; returns what
    to restore."""
    import importlib

    saved = []
    for label, module, attr in RANGES:
        owner = importlib.import_module(module)
        *path, name = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        orig = getattr(owner, name)

        def ranged(*args, _orig=orig, _label=label, **kwargs):
            with record_function(_label):
                return _orig(*args, **kwargs)

        setattr(owner, name, functools.wraps(orig)(ranged))
        saved.append((owner, name, orig))
    return saved


def census(prof, labels) -> dict:
    """{label: [device ops, device seconds]} of the innermost range that
    held each device op's launch; ops launched outside every range go to
    "outside"."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges, launch_t, device = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            if name not in labels:  # host ranges are mirrored on the device
                device.append(ev)
        elif name in labels:
            ranges.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name))
        elif name.startswith(("cuda", "cu")):
            launch_t[ev.correlation_id()] = ev.start_ns()
    out = {label: [0, 0.0] for label in labels + ("outside",)}
    for ev in device:
        t = launch_t.get(ev.correlation_id(), ev.start_ns())
        held = [r for r in ranges if r[0] <= t <= r[1]]
        label = max(held)[2] if held else "outside"  # nested: the latest start
        out[label][0] += 1
        out[label][1] += ev.duration_ns() * 1e-9
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("op_census: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    h, w = args.height, args.width
    cycle = cs.realtime_frames("spatial_temporal", h, w, dev)
    r = cs.realtime_renderer("spatial_temporal", h, w, dev)
    step = {"i": 0}

    def frame():
        gb, cam = cycle[step["i"] % len(cycle)]
        step["i"] += 1
        r.render_frame(gb, cam)

    for _ in range(WARM_UP):
        frame()
    torch.cuda.synchronize()
    hist1 = float((r.temporal_state.history_sample == 1.0).float().mean())
    smooth = [float((gb.smoothness > 0.5).float().mean()) for gb, _ in cycle]
    labels = tuple(label for label, _, _ in RANGES)
    saved = install(record_function)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.frames):
                frame()
            torch.cuda.synchronize()
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)
    counts = census(prof, labels)
    n = args.frames
    total = sum(c for c, _ in counts.values())
    print(f"op_census {w}x{h}, {n} frames after {WARM_UP}, {torch.cuda.get_device_name(0)}: "
          f"{total / n:.1f} device ops a frame")
    for label, (c, s) in counts.items():
        print(f"op_census   {label:14s} {c / n:8.1f} ops/frame {s * 1e3 / n:9.3f} ms/frame")
    print(f"op_census boosted pixels: smoothness > 0.5 at the poses "
          + " / ".join(f"{x:.4f}" for x in smooth)
          + f", history count 1 after the warm-up {hist1:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
