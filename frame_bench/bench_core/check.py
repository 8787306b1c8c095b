"""Whether the frames ``render_frame`` returned in the run are correct.

The reference is the frozen plain path (``sspt_plain``), run on the same
device after the program's state is freed. It works everything out
again from the inputs: depth tiles, probe mips, history. Two parts:

1. The replay from the run's start: a fresh reference Renderer renders
   the run's first frames (the warm-up and the first timed frames) with
   the same first frame index, poses and scene keys; each is compared
   with the program's frame.
2. One frame of the window drawn from the seed: the reference steps once
   from the program's own state just before it (``Renderer.save``, taken
   with the window's clock stopped) and is compared with the program's
   frame. This follows the program from its state; the replay checks the
   start by itself.

Numbers compared, the worst over the frames: ``rel_rmse``, the pooled
relative RMSE (sqrt of the summed squared difference over the summed
squared reference, every pixel and channel, in float64), and
``max_abs``, the largest absolute difference of any channel. A frame
that is not finite fails.
"""

from __future__ import annotations

import io
import math


def frame_numbers(img, ref) -> dict:
    import torch

    a, b = img.double(), ref.double()
    d = a - b
    denom = float((b * b).sum())
    finite = bool(torch.isfinite(a).all())
    return {
        "rel_rmse": math.sqrt(float((d * d).sum()) / denom) if finite and denom > 0 else math.inf,
        "max_abs": float(d.abs().max()) if finite else math.inf,
    }


def worst(rows: list) -> dict:
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def snapshot(renderer) -> io.BytesIO:
    """The program's state through its public ``save`` (to memory)."""
    buf = io.BytesIO()
    renderer.save(buf)
    buf.seek(0)
    return buf


def compare(ref_side, config: dict, inputs, traffic, device, record: dict) -> dict:
    """Run the reference over ``record`` and return the compared numbers
    (worst over the frames) and the count of frames that failed them.

    ``record``: ``frame_index`` (the first frame's), ``keys`` (scene key of
    every frame from the first), ``start`` (the program's first frames),
    and ``step``: ``{"index", "state", "image"}`` or None."""
    import torch

    gbs = [ref_side.gbuffers(p, device) for p in inputs.poses]
    cams = [ref_side.cam(p, device) for p in inputs.poses]
    keys = record["keys"]
    rows = []
    with torch.no_grad():
        ref = ref_side.make_renderer(config, inputs, device)
        ref.frame_index = record["frame_index"]
        for i, img in enumerate(record["start"]):
            p = traffic.pose(i)
            out = ref.render_frame(gbs[p], cams[p], scene_key=keys[i])
            rows.append(frame_numbers(img, out))
        del ref
        step = record.get("step")
        if step is not None:
            j = step["index"]
            ref = ref_side.make_renderer(config, inputs, device)
            ref.load(step["state"])
            p = traffic.pose(j)
            out = ref.render_frame(gbs[p], cams[p], scene_key=keys[j])
            rows.append(frame_numbers(step["image"], out))
    return {"frames": len(rows), "rows": rows, "worst": worst(rows)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, failed frames, checks): each compared number beside its
    limit; a number that is not a number fails."""
    checks = {k: {"value": numbers["worst"][k], "limit": lim} for k, lim in limits.items()}
    failed = sum(1 for row in numbers["rows"]
                 if not all(row[k] <= lim for k, lim in limits.items()))
    correct = numbers["frames"] > 0 and failed == 0
    return correct, failed, checks
