#!/usr/bin/env python3
"""Ablation of kernel P1 (``csrc/ray_march.cu``, the parity march) on one
NVIDIA GPU: where its step goes, and which design is fastest.

    python3 scripts/march_ablation.py [--parent DIR] [--out FILE]   # repository root, a GPU

Writes patched copies of ``ray_march.cu`` (``COPIES``: each a list of
exact text replacements, each of which must match once) into
``build/march_ablation/``, builds them and the unpatched file, one
``nvcc`` per copy, all started together, and prints each copy's
registers, shared memory and spills (``-Xptxas -v``) and the SASS
instructions of its loop (``cuobjdump -sass``). With ``--parent DIR``
(an unpacked earlier tree, e.g. ``git archive`` of the parent commit)
that tree's own ``ray_march.cu`` is built too, as "parent", with the
``parent-*`` copies patched from it (a copy whose anchor that file lacks
is reported and left out). Then, through the port's own wrapper, it
times each copy with ``chip_smoke.cuda_ms`` (20 launches, twice, in
forward and reverse order) and holds its outputs against the plain
version, on:

- the phase-3 test rays of ``chip_smoke.py`` at 1920x1080 (BoxScene
  bounce-0 reflections, tilted, 24 steps);
- every bounce's own inputs of a 1080p parity headline frame and of a
  parity dual frame, caught on the way through ``trace_frame``.

Exact copies are held bit for bit on all five outputs. ``no-read`` and
``fast-div`` (and their ``parent-*`` forms) are timing only and write
each lane's own steps in the distance row: ``no-read`` makes each depth
from the texel index with no memory access (the read's term),
``fast-div`` replaces the five IEEE divides and reciprocals with
``__fdividef`` (the divide term). Each is compared per step-loop pass,
since it changes where the lanes stop. ``no-store`` drops the alive
lanes' output stores (timing only). The exact design choices:
``compact-all`` / ``compact-none`` (a block compacts its alive lanes
always or never; the shipped file does where that frees a warp),
``dead-alone`` (a dead lane of a block that
keeps its lanes writes alone, not with its warp), ``reg-camera`` / ``parent-reg-camera`` (the camera
in registers instead of shared memory), ``idx64`` / ``parent-idx32``
(the texel index in 64 or 32 bits), ``t64`` / ``t256`` / ``parent-t256``
(threads a block) and ``min8`` / ``parent-min12`` (blocks an SM asked of
ptxas).

For each input set it prints the lanes, the lane-steps (the plain
version's ``steps_out``), the warp-steps one thread a lane issues and
the lane-steps over 32 (perfect refill), the bound of
``chip_smoke.p1_reference``, and for each copy its time, its step-loop
passes (``chip_smoke.round_steps`` of its span, or ``warp_steps`` one
thread a lane), and the issue-limited time: passes x the step loop's
SASS / (132 x 4 x 1.98 GHz). Then P1 summed over each frame's bounces.
Writes every number to ``--out`` (default
``build/march_ablation/march_ablation.json``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from unitysspathtracingurp_tpu_torch.config import PTSettings  # noqa: E402
from unitysspathtracingurp_tpu_torch.kernels import build  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt  # noqa: E402

OUT_DIR = ROOT / "build" / "march_ablation"

# Anchors in both the shipped file and the parent's (one thread a lane).
READ = "__ldg(test_img + texel)"
READ_BACK = "__ldg(back_img + texel)"
FAKE = "(0.5f + 1e-8f * static_cast<float>(texel & 1023))"
FAKE_BACK = "(0.25f + 1e-8f * static_cast<float>(texel & 1023))"
NO_READ = [(READ, FAKE), (READ_BACK, FAKE_BACK)]
FAST_DIV = [
    ("  u = cx / w * 0.5f + 0.5f;\n  v = cy / w * 0.5f + 0.5f;\n  raw = cz / w;\n",
     "  u = __fdividef(cx, w) * 0.5f + 0.5f;\n  v = __fdividef(cy, w) * 0.5f + 0.5f;\n"
     "  raw = __fdividef(cz, w);\n"),
    ("1.0f / (device_depth * zz + zw)", "__fdividef(1.0f, device_depth * zz + zw)"),
    ("1.0f / (raw * zz + zw)", "__fdividef(1.0f, raw * zz + zw)"),
    ("1.0f / (device_back * zz + zw)", "__fdividef(1.0f, device_back * zz + zw)"),
]
THREADS = "constexpr int THREADS = 128;\n"
BOUNDS = "__global__ void __launch_bounds__(THREADS) ray_march_kernel(Args a) {\n"


def threads(t: int) -> list:
    return [(THREADS, f"constexpr int THREADS = {t};\n")]


def min_blocks(b: int) -> list:
    return [(BOUNDS, BOUNDS.replace("(THREADS)", f"(THREADS, {b})"))]


# Both files: the camera in shared memory (into registers instead).
REG_CAMERA = [("  __shared__ float s_m[18];\n",
               "  float s_m[18];\n#pragma unroll\n"
               "  for (int k = 0; k < 18; ++k) s_m[k] = __ldg(a.scalars + k);\n"),
              ("  if (threadIdx.x < 18) s_m[threadIdx.x] = a.scalars[threadIdx.x];\n", "")]
IDX32 = "const int texel = pixel_index(v, a.gh) * a.gw + pixel_index(u, a.gw);"
IDX64 = ("const size_t texel = static_cast<size_t>(pixel_index(v, a.gh)) * a.gw\n"
         "                           + pixel_index(u, a.gw);")

# Both files: the lane's own steps in row 3 (a counting copy).
COUNT = [
    ("bool hit = false, back_hit = false;\n",
     "bool hit = false, back_hit = false;\n  int steps_run = 0;\n"),
    ("for (int i = 1; i <= a.s_max; ++i) {\n",
     "for (int i = 1; i <= a.s_max; ++i) {\n      ++steps_run;\n"),
    ("a.out[3 * nn + lane] = hdist;\n",
     "a.out[3 * nn + lane] = static_cast<float>(steps_run) + 0.0f * hdist;\n"),
]

# The shipped file: blocks that compact their alive lanes where that
# frees a warp.
STORES = ("  a.out[lane] = hx;\n  a.out[nn + lane] = hy;\n"
          "  a.out[2 * nn + lane] = hz;\n  a.out[3 * nn + lane] = hdist;\n"
          "  a.out[4 * nn + lane] = hu;\n  a.out[5 * nn + lane] = hv;\n"
          "  a.flags[lane] = hit;\n  a.flags[nn + lane] = back_hit;\n")
NO_STORE = [(STORES, "  if (hdist < 0.0f) {\n" + STORES + "  }\n")]
COMPACT = "  if (total <= THREADS - 32) {\n"
# Dead lanes of a block that keeps its lanes in place write alone, at once.
DEAD_ALONE = [("  } else if (!in) {\n    return;\n  }\n",
               "  } else if (!in) {\n    return;\n  } else if (!alive) {\n"
               "    a.out[j] = 0.0f;\n    a.out[nn + j] = 0.0f;\n    a.out[2 * nn + j] = 0.0f;\n"
               "    a.out[3 * nn + j] = REAL_EPS;\n    a.out[4 * nn + j] = 0.0f;\n"
               "    a.out[5 * nn + j] = 0.0f;\n    a.flags[j] = 0;\n    a.flags[nn + j] = 0;\n"
               "    return;\n  }\n")]


def compact(when: str) -> list:
    return [(COMPACT, f"  if ({when}) {{\n")]


class Copy(NamedTuple):
    """A copy of ray_march.cu: its replacements, the file they patch
    ("library": the shipped one; "parent": ``--parent``'s), and what its
    outputs are: "exact" (all five bit for bit), "count" (timing only;
    the lane's steps in the distance row) or "timing"."""

    patches: list
    base: str = "library"
    outputs: str = "exact"
    most_compacted: int | None = None  # chip_smoke.round_steps's; None: span - 32


COPIES = {
    "library": Copy([]),
    "compact-all": Copy(compact("true"), most_compacted=128),
    "compact-none": Copy(compact("false"), most_compacted=-1),
    "dead-alone": Copy(DEAD_ALONE),
    "reg-camera": Copy(REG_CAMERA),
    "idx64": Copy([(IDX32, IDX64)]),
    "t64": Copy(threads(64)),
    "t256": Copy(threads(256)),
    "min8": Copy(min_blocks(8)),
    "no-read": Copy(COUNT + NO_READ, outputs="count"),
    "fast-div": Copy(COUNT + FAST_DIV, outputs="count"),
    "no-store": Copy(NO_STORE, outputs="timing"),
    "parent": Copy([], base="parent"),
    "parent-no-read": Copy(COUNT + NO_READ, base="parent", outputs="count"),
    "parent-fast-div": Copy(COUNT + FAST_DIV, base="parent", outputs="count"),
    "parent-reg-camera": Copy(REG_CAMERA, base="parent"),
    "parent-idx32": Copy([(IDX64, IDX32)], base="parent"),
    "parent-t256": Copy(threads(256), base="parent"),
    "parent-min12": Copy(min_blocks(12), base="parent"),
}
ENTRY = "sspt_ray_march"


def patched(src: str, patches: list) -> str:
    """``src`` with each (old, new) replacement applied in turn; each old
    text must occur exactly once."""
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def file_name(copy: str) -> str:
    return re.sub(r"[^\w-]", "_", copy)


def build_copies(parent: Path | None) -> dict:
    """{copy: (library, ptxas rows, SASS loops)}, all nvcc processes at
    once. A copy that does not apply or fails to build is reported and
    left out."""
    nvcc = build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    bases = {"library": build.SRC_DIR / "ray_march.cu"}
    if parent is not None:
        bases["parent"] = parent / "unitysspathtracingurp_tpu_torch" / "csrc" / "ray_march.cu"
    procs = {}
    for name, copy in COPIES.items():
        if copy.base not in bases:
            continue
        src = bases[copy.base]
        path = OUT_DIR / f"{file_name(name)}.cu"
        try:
            path.write_text(patched(src.read_text(), copy.patches))
        except RuntimeError as e:
            print(f"copy {name} left out: {e}")
            continue
        so = OUT_DIR / f"{file_name(name)}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            print(f"nvcc failed for copy {name}, left out:\n{out}")
            continue
        lib = ctypes.CDLL(str(so))
        for entry in (ENTRY, "sspt_ray_march_span"):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = build._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, build.parse_ptxas(out), build.sass_loops(so))
    return libs


@contextlib.contextmanager
def use(lib):
    """The wrapper launches ``lib``'s kernel."""
    real = build.load_library
    build.load_library = lambda: lib
    try:
        yield
    finally:
        build.load_library = real


def loop_sass(libs, name: str, args) -> int | None:
    """The SASS instructions of the step loop (the longest loop with no
    warp vote, shuffle, atomic or global store) of the instance of copy
    ``name`` that ``args`` launch."""
    _, opaque, back = pt.march_depth_images(args[3], args[2])
    loops = libs[name][2].get(f"ray_march_kernel<{int(opaque is not None)},"
                              f"{int(back is not None)}>")
    return max(loops["inner_loops"]) if loops and loops["inner_loops"] else None


def passes(libs, name: str, steps, alive) -> float:
    """The step-loop passes copy ``name`` issues for lanes that take
    ``steps``: ``chip_smoke.round_steps`` of its blocks
    (``sspt_ray_march_span``), or one thread a lane (each warp as many as
    its longest lane) in a file without that entry point."""
    span = getattr(libs[name][0], "sspt_ray_march_span", None)
    if span is None:
        return cs.warp_steps(steps)
    return cs.round_steps(steps, alive, span(), COPIES[name].most_compacted)


def run_set(label, args, libs, results):
    """Time and check every copy on one input set."""
    ref, steps, b = cs.p1_reference(args)
    n, lane_steps = steps.numel(), float(steps.sum())
    alive = args[-1].expand(args[5].shape[:-1]).reshape(-1)
    ws = cs.warp_steps(steps)
    row = dict(label=label, n=n, alive=float(args[-1].sum()), lane_steps=lane_steps,
               warp_steps_one_thread_a_lane=ws, perfect_refill_steps=lane_steps / 32,
               warp_efficiency=lane_steps / max(32 * ws, 1.0), runs={}, **b)
    fns = {}
    for name, copy in COPIES.items():
        if name not in libs:
            continue

        def fn(lib=libs[name][0]):
            with use(lib):
                return pt.ray_march(*args)

        got = fn()
        torch.cuda.synchronize()
        run = dict(equal=None, sass=loop_sass(libs, name, args))
        if copy.outputs == "exact":
            run["equal"] = all(cs.bits_equal(g, r) for g, r in zip(got, ref))
            run["passes"] = passes(libs, name, steps, alive)
        elif copy.outputs == "count":
            own = got.distance.reshape(-1).round().to(torch.int64)
            run["passes"] = passes(libs, name, own * alive, alive)
        else:
            run["passes"] = None
        fns[name] = fn
        row["runs"][name] = run
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            row["runs"][name].setdefault("ms_each", []).append(cs.cuda_ms(fns[name], 20))
    print(f"ablation P1 {label}: N {n}, alive {row['alive']:.0f}, lane-steps {lane_steps:.0f}, "
          f"warp-steps one thread a lane {ws:.0f} (warp efficiency "
          f"{row['warp_efficiency']:.4f}), lane-steps / 32 {lane_steps / 32:.0f}, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    for name, r in row["runs"].items():
        r["ms"] = sum(r["ms_each"]) / 2
        r["issue_ms"] = (cs.issue_ms(r["passes"], r["sass"])
                         if r["passes"] is not None and r["sass"] else None)
        per = (f", {r['ms'] * 1e-3 * cs.ISSUE_PER_S / r['passes']:.1f} issue slots a pass"
               if r["passes"] else "")
        print(f"  {name:18s} {r['ms']:.4f} ms ({r['ms_each'][0]:.4f} / {r['ms_each'][1]:.4f}), "
              f"{b['bound_ms'] / r['ms']:.3f} of bound, passes "
              f"{'n/a' if r['passes'] is None else format(r['passes'], '.0f')}{per}, loop SASS "
              f"{r['sass']}, issue-limited "
              f"{'n/a' if r['issue_ms'] is None else format(r['issue_ms'], '.4f')} ms, equal "
              f"{'n/a' if r['equal'] is None else r['equal']}")
    results.append(row)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier tree: also time its ray_march.cu")
    parser.add_argument("--out", type=Path, default=OUT_DIR / "march_ablation.json",
                        help="where the JSON of every number goes")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("march_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build_copies(opts.parent)
    print(f"built {len(libs)} copies of ray_march.cu in {time.perf_counter() - t0:.1f} s")
    for name, (_, rows, loops) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r['regs']} regs, {r['smem']} B static smem, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B" for r in rows))
        print(f"sass {name}: " + "; ".join(
            f"{k} {v['instructions']} instructions, loops {v['loops']}"
            for k, v in loops.items()))

    results = []
    gb, cam = cs.boxscene(cs.H_FULL, cs.W_FULL, dev)
    x = cs.march_inputs(gb, cam)
    run_set("test rays 1080p", cs.p1_call(gb, cam, x, PTSettings(maximum_steps=24)), libs,
            results)
    for path in ("parity", "parity_dual"):
        calls, _ = cs.parity_calls(dev, path)
        for b, a in enumerate(calls):
            run_set(f"{path} frame bounce {b} rays", a, libs, results)
    frames = {}
    for path in ("parity", "parity_dual"):
        sets = [r for r in results if r["label"].startswith(f"{path} frame")]
        frames[path] = {name: sum(r["runs"][name]["ms"] for r in sets)
                        for name in sets[0]["runs"]}
        print(f"frame {path}: P1 summed over {len(sets)} bounces: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in frames[path].items()))

    ok = all(r["equal"] is not False for row in results for r in row["runs"].values())
    out = opts.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        card=card, ptxas={k: v[1] for k, v in libs.items()},
        sass={k: v[2] for k, v in libs.items()}, sets=results, frames=frames), indent=1))
    print(f"every compared copy equal to the plain version: {ok}")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
