#!/usr/bin/env python3
"""Ablation of kernels K1, K4 and K6 (``csrc/schedule_pack.cu``) on one
NVIDIA GPU: where their time goes, and which design is fastest.

    python3 scripts/pack_ablation.py [--parent DIR] [--out FILE]   # repository root, a GPU

Writes patched copies of ``schedule_pack.cu`` (``COPIES``: each a list of
exact text replacements, each of which must match once) into
``build/pack_ablation/``, builds them and the unpatched file, one
``nvcc`` per copy, all started together, and prints each copy's
registers, shared memory and spills (``-Xptxas -v``). Then, through the
port's own wrappers, it times each copy with CUDA events (20 launches,
twice, in forward and reverse order) and holds its outputs against the
plain version bit for bit (the copies without slots: ``n_cand`` only) on:

- the phase-3 test rays of ``chip_smoke.py`` at 1920x1080 (BoxScene
  bounce-0 reflections, tilted): K1, K6, and K4 on the glass box with
  insideObject 0;
- the frames' own rays: K1's inputs in each bounce of a 1080p headline
  frame, K4's in each bounce of a 1080p dual frame, and K6 on the
  headline's bounce-0 rays, caught on the way through
  ``trace_frame_hiz``.

The split of the earlier design, which stored each slot to device memory
at the step that found it (copy ``device``, 128 threads):
(a) its scattered slot stores = device - none, (b) no early exit =
device - device+exit, (c) what is left with neither = none+exit, beside
the bound; ``library`` is the unpatched file. Loop iterations a lane and
a warp run with the exit come from the ``none+exit`` copy. With
``--parent DIR`` (an unpacked earlier tree,
e.g. ``git archive`` of the parent commit) that tree's own
``schedule_pack.cu`` is built and timed beside the copies, as "parent".
Writes every number to ``--out`` (default
``build/pack_ablation/pack_ablation.json``).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings  # noqa: E402
from unitysspathtracingurp_tpu_torch.kernels import build  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops.depth_tiles import (  # noqa: E402
    build_depth_tiles, build_home_strips,
)
from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe  # noqa: E402

OUT_DIR = ROOT / "build" / "pack_ablation"

# Anchors in schedule_pack.cu and what the copies put in their place.
LOOP = "  for (int i = 1; i <= p.s_max && marching && run < k; ++i) {\n"
STAGED = "  constexpr bool STAGED = !HOME;\n"
WRITE_ROWS = ("  float* const outs[4] = {a.pk_cum, a.pk_scode, a.pk_hist, dual.pk_step};\n"
              "  write_rows<DUAL ? 4 : 3>(stage, outs, p.n, p.k, blockIdx.x * blockDim.x);\n")
STORE = ("        slot(0, run) = cum;\n        slot(1, run) = scode;\n"
         "        slot(2, run) = hist;\n        if (DUAL) slot(3, run) = qstep;\n")
ZERO = ("  for (int j = cnt; j < k; ++j) {\n#pragma unroll\n"
        "    for (int f = 0; f < NF; ++f) slot(f, j) = 0.0f;\n  }\n")
N_CAND = "  if (!HOME) {\n    a.n_cand[lane] = cnt;\n"
SLOT_NOTE = "  // Field f of slot j: staged on chip, or in the (K, N) output.\n"
SLOT_STAGED = "      return stage_col[(f * k + j) * static_cast<int>(blockDim.x)];\n"
COMBO = "  const int combo_off = DUAL ? dual.combo[lane] * dual.combo_words : 0;\n"
LDG = ("      const uint32_t word = __ldg(mini_table + mini);\n"
       "      const uint32_t bword = __ldg(dual.bmax_table + mini);\n")
TABLE = ("  const int table_words = DUAL ? 0 : p.n_mini_words;\n"
         "  for (int i = threadIdx.x; i < table_words; i += blockDim.x) s_dyn[i] = mini_table[i];\n")
HOME_CALL = ("    pack_lane<false, true>(lane_base + threadIdx.x, a, s_mini, p, none, home, "
             "nullptr);\n")

# Every lane runs s_max steps.
NO_EXIT = [(LOOP, "  for (int i = 1; i <= p.s_max; ++i) {\n")]
# K1 / K4 store each slot to device memory at the step that finds it
# (the earlier design; K6's stores), zeros past the count after the loop.
DEVICE = [(STAGED, "  constexpr bool STAGED = false;\n"), (WRITE_ROWS, "")]
# No slots at all: only n_cand, one checksum word per lane in row 0 of
# pk_cum and the lane's loop iterations in row 0 of pk_scode (the other
# rows are left as allocated).
NO_SLOTS = DEVICE + [
    ("  int run = 0;\n", "  int run = 0;\n  uint32_t checksum = 0u;\n  int steps_run = 0;\n"),
    ("    if (i == p.max_small + 1)", "    ++steps_run;\n    if (i == p.max_small + 1)"),
    (STORE, "        checksum ^= __float_as_uint(cum) ^ (__float_as_uint(scode) * 3u) ^\n"
            "                    (__float_as_uint(hist) * 5u) ^ (__float_as_uint(qstep) * 7u);\n"),
    (ZERO, ""),
    (N_CAND, "  slot(0, 0) = __uint_as_float(checksum);\n"
             "  slot(1, 0) = static_cast<float>(steps_run);\n" + N_CAND),
]
# Each lane writes its own column, row by row, instead of the warp's
# 16-byte row copies.
LANES = [
    (ZERO, "#pragma unroll\n  for (int f = 0; f < NF; ++f) {\n"
           "    for (int j = 0; j < k; ++j)\n"
           "      outs[f][static_cast<size_t>(j) * n + lane] = j < cnt ? slot(f, j) : 0.0f;\n"
           "  }\n"),
    (WRITE_ROWS, ""),
]
# The slots in per-thread local arrays instead of shared memory.
LOCAL = LANES + [(SLOT_NOTE, "  float local_slots[4][16];\n" + SLOT_NOTE),
                 (SLOT_STAGED, "      return local_slots[f][j];\n")]
# K4: the combo of the block's first lane (mini then bmax words) staged
# in shared memory before the slot staging, other combos through __ldg.
TABLES = [
    (COMBO, COMBO + "  const int s_off = DUAL ? dual.combo[min(static_cast<int>(blockIdx.x * "
                    "blockDim.x), n - 1)] * dual.combo_words : 0;\n"),
    (LDG, "      extern __shared__ uint32_t s_tab[];\n"
          "      const unsigned local = static_cast<unsigned>(mini - s_off);\n"
          "      const bool in = local < static_cast<unsigned>(dual.combo_words);\n"
          "      const uint32_t word = in ? s_tab[local] : __ldg(mini_table + mini);\n"
          "      const uint32_t bword = in ? s_tab[dual.combo_words + local]\n"
          "                                : __ldg(dual.bmax_table + mini);\n"),
    (TABLE, "  const int cw = dual.combo_words;\n"
            "  const int table_words = DUAL ? 2 * cw : p.n_mini_words;\n"
            "  if (DUAL) {\n"
            "    const int off = dual.combo[min(static_cast<int>(blockIdx.x * blockDim.x), "
            "p.n - 1)] * cw;\n"
            "    for (int i = threadIdx.x; i < cw; i += blockDim.x) {\n"
            "      s_dyn[i] = mini_table[off + i];\n"
            "      s_dyn[cw + i] = dual.bmax_table[off + i];\n"
            "    }\n"
            "  } else {\n"
            "    for (int i = threadIdx.x; i < table_words; i += blockDim.x) "
            "s_dyn[i] = mini_table[i];\n"
            "  }\n"),
]
# K6 stages its slots as K1 does, after the table and the strip.
HOME_STAGED = [
    (STAGED, "  constexpr bool STAGED = true;\n"),
    (HOME_CALL, "    float* stage = reinterpret_cast<float*>(s_strip + HOME_ROWS * 128);\n"
                "    pack_lane<false, true>(lane_base + threadIdx.x, a, s_mini, p, none, home,\n"
                "                           stage + threadIdx.x);\n"
                "    float* const outs[3] = {a.pk_cum, a.pk_scode, a.pk_hist};\n"
                "    write_rows<3>(stage, outs, p.n, p.k, lane_base);\n"
                "    __syncwarp();  // before a lane stages its next lane block\n"),
]


class Copy(NamedTuple):
    """A copy of schedule_pack.cu: its replacements; whether K1 / K4 stage
    slots in shared memory, K4 its combo's tables, K6 its slots (the
    budget the wrappers pass); whether it has slots at all."""

    patches: list
    staged: bool = True
    tables: bool = False
    home_staged: bool = False
    slots: bool = True


# "library" is schedule_pack.cu itself, as the wrappers load it (K1 / K4
# staged with the warp's row copies and the exit; K6 device stores with
# the exit).
# "parent": with --parent, that tree's own schedule_pack.cu (128-thread
# blocks, its own entry points).
COPIES = {
    "device": Copy(DEVICE + NO_EXIT, staged=False),
    "device+exit": Copy(DEVICE, staged=False),
    "none": Copy(NO_SLOTS + NO_EXIT, staged=False, slots=False),
    "none+exit": Copy(NO_SLOTS, staged=False, slots=False),
    # 1,536 threads an SM: is the loop latency-bound?
    "none+exit+occ3": Copy(NO_SLOTS + [("__global__ void __launch_bounds__(512, 2)\n",
                                        "__global__ void __launch_bounds__(512, 3)\n")],
                           staged=False, slots=False),
    "shared": Copy(NO_EXIT),
    "library": Copy([]),
    "shared-lanes+exit": Copy(LANES),
    "local+exit": Copy(LOCAL, staged=False),
    "shared+exit+tables": Copy(TABLES, tables=True),
    "home-shared+exit": Copy(HOME_STAGED, home_staged=True),
}
# (copy, threads a block) timed per kernel; None: the budget's choice.
RUNS = {
    "K1": [("parent", 128), ("device", 128), ("device+exit", 128), ("none", 128),
           ("none+exit", 128), ("none+exit+occ3", 512), ("shared", None),
           ("library", 128), ("library", 256), ("library", 512),
           ("shared-lanes+exit", None), ("local+exit", 128), ("local+exit", 512)],
    "K4": [("parent", 128), ("device", 128), ("device+exit", 128), ("none", 128),
           ("none+exit", 128), ("none+exit+occ3", 512), ("shared", None),
           ("library", 128), ("library", 256), ("library", 512),
           ("shared-lanes+exit", None), ("local+exit", 128), ("local+exit", 512),
           ("shared+exit+tables", 128), ("shared+exit+tables", 256)],
    "K6": [("parent", 128), ("device", 128), ("library", 128), ("none+exit", 128),
           ("home-shared+exit", 128)],
}
ENTRIES = ("sspt_schedule_pack", "sspt_schedule_pack_dual", "sspt_schedule_pack_home")


def patched(src: str, patches: list) -> str:
    """``src`` with each (old, new) replacement applied in turn; each old
    text must occur exactly once."""
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# An earlier tree's entry points: no threads / smem arguments.
PARENT_SIGNATURES = {
    "sspt_schedule_pack": [P] * 12 + [I] * 9 + [F] * 8 + [P],
    "sspt_schedule_pack_dual": [P] * 15 + [I] * 10 + [F] * 8 + [P],
    "sspt_schedule_pack_home": [P] * 14 + [I] * 10 + [F] * 8 + [P],
}


class ParentEntries:
    """An earlier tree's library under the wrappers' argument lists: it
    drops the block size and shared bytes it chose itself."""

    def __init__(self, lib):
        self.lib = lib

    def sspt_schedule_pack(self, *a):
        return self.lib.sspt_schedule_pack(*a[:-3], a[-1])

    def sspt_schedule_pack_dual(self, *a):
        return self.lib.sspt_schedule_pack_dual(*a[:-3], a[-1])

    def sspt_schedule_pack_home(self, *a):
        return self.lib.sspt_schedule_pack_home(*a[:-2], a[-1])


def build_copies(parent: Path | None) -> dict:
    """{copy: (ctypes library, ptxas rows)}, all nvcc processes at once."""
    nvcc = build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.SRC_DIR / "schedule_pack.cu"
    jobs = {}
    for name, copy in COPIES.items():
        path = src
        if copy.patches:
            path = OUT_DIR / f"{name.replace('+', '_')}.cu"
            path.write_text(patched(src.read_text(), copy.patches))
        jobs[name] = path
    if parent is not None:
        jobs["parent"] = parent / "unitysspathtracingurp_tpu_torch" / "csrc" / "schedule_pack.cu"
    procs = {}
    for name, path in jobs.items():
        so = OUT_DIR / f"{name.replace('+', '_')}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for copy {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        sigs = PARENT_SIGNATURES if name == "parent" else build._SIGNATURES
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = sigs[entry]
            fn.restype = ctypes.c_int
        libs[name] = (ParentEntries(lib) if name == "parent" else lib, build.parse_ptxas(out))
    return libs


@contextlib.contextmanager
def use(lib, copy: Copy, forced: int | None, dual_table_words: int = 0):
    """The wrappers launch ``lib``'s kernels with ``forced`` threads a
    block (None: the budget's choice; K6 always 128) and the shared
    memory ``copy`` needs: staging only where it stages in shared memory,
    K4's combo tables where it stages those."""
    real = build.load_library, fs.pack_budget

    def budget(table_words, k, n_fields, threads=None):
        if threads is not None:  # K6
            return real[1](table_words, k, 3 if copy.home_staged else n_fields, threads=threads)
        extra = dual_table_words if copy.tables and n_fields == 4 else 0
        return real[1](table_words + extra, k, n_fields if copy.staged else 0, threads=forced)

    build.load_library, fs.pack_budget = (lambda: lib), budget
    try:
        yield
    finally:
        build.load_library, fs.pack_budget = real


def test_rays(dev, glass: bool):
    """The phase-3 test inputs of chip_smoke.py at 1080p: K1 (and K6's
    extra arguments), or K4 with insideObject 0."""
    h, w, n = cs.H_FULL, cs.W_FULL, cs.H_FULL * cs.W_FULL
    gb, cam = cs.boxscene(h, w, dev, glass=glass)
    x = cs.march_inputs(gb, cam)
    settings = cs.dual_settings() if glass else PTSettings(maximum_steps=24, dithering=False)
    tiles = (ph.build_tiles_for(gb, cam, settings.variants()) if glass
             else build_depth_tiles(gb.depth, cam.near, cam.far))
    large = settings.step_size + (20.0 - settings.step_size) * x["scene_dist"] * 0.001
    is_back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
    lane = (x["origin"].reshape(n, 3), x["d"].reshape(n, 3), torch.zeros(n, device=dev),
            large.reshape(n), x["alive"].reshape(n))
    kw = fs.march_kwargs(PTConfig(), tiles, 24)
    if glass:
        combo = torch.zeros(n, dtype=torch.int32, device=dev)
        return ((*lane, combo, is_back, tiles.mini_table, tiles.bmax_table,
                 fs.schedule_scalars(cam)), dict(kw, chunks_per_combo=tiles.chunks_per_combo))
    return (*lane, is_back, tiles.mini_table, fs.schedule_scalars(cam)), kw, tiles


def frame_calls(dev, path: str, name: str):
    """(args, kwargs) of every call of ``pathtrace_hiz.<name>`` in one 1080p
    frame of ``path``, and the frame's tiles (plain versions: the inputs
    do not depend on the kernels, which equal them bit for bit)."""
    s, cfg, bde, glass = cs.path_config(path)
    gb, cam = cs.boxscene(cs.H_FULL, cs.W_FULL, dev, glass=glass)
    probes = ProbeSet(probe0=constant_probe(cs.PROBE, device=dev))
    tiles = ph.build_tiles_for(gb, cam, s.variants())
    calls = []
    with cs.plain_kernels():
        real = getattr(ph, name)

        def spy(*a, **kw):
            calls.append((a, kw))
            return real(*a, **kw)

        setattr(ph, name, spy)
        ph.trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), 99, tiles=tiles,
                           back_depth_enabled=bde)
        torch.cuda.synchronize()
    return calls, tiles


def bound_ms(kernel: str, n: int, k: int, table_bytes: int) -> float:
    """chip_smoke.py's bytes for the kernel at N lanes (every bound of
    these kernels is set by bytes)."""
    per_lane = {"K1": 34 + k * 12 + 4, "K4": 38 + k * 16 + 4,
                "K6": 34 + k * 12 + 4 + 11 * 4}[kernel]
    return (n * per_lane + table_bytes) / cs.HBM_BYTES_PER_S * 1e3


def run_set(label, kernel, wrapper, ref_fn, args, kw, libs, results, dual_table_words=0,
            table_bytes=0):
    """Time and check every RUNS[kernel] entry on one input set."""
    ref = ref_fn(*args, **kw)
    n, k = args[0].shape[0], kw["k"]
    count = ref[4] if kernel == "K4" else ref[3]
    row = dict(label=label, kernel=kernel, n=n, k=k,
               bound_ms=bound_ms(kernel, n, k, table_bytes),
               lanes_with_candidates=float((count > 0).float().mean()),
               lanes_at_k=float((count == k).float().mean()), runs={})
    fns = {}
    for copy, threads in RUNS[kernel]:
        if copy not in libs:
            continue
        lib, _ = libs[copy]
        spec = COPIES.get(copy, Copy([], staged=False))

        def fn(lib=lib, spec=spec, threads=threads):
            with use(lib, spec, threads, dual_table_words):
                return wrapper(*args, **kw)

        key = f"{copy} t{threads or 'budget'}"
        got = fn()
        torch.cuda.synchronize()
        if not spec.slots:
            equal = torch.equal(count, got[4] if kernel == "K4" else got[3])
            if kernel == "K6":
                equal = equal and torch.equal(got[4], ref[4])
            if copy == "none+exit":
                it = got[1][0]
                pad = (-n) % 32
                warp = torch.cat([it, it.new_zeros(pad)]).view(-1, 32).amax(1)
                row["loop_iterations"] = dict(lane_mean=float(it.mean()),
                                              warp_max_mean=float(warp.mean()),
                                              of=kw["s_max"])
        else:
            equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        fns[key] = fn
        row["runs"][key] = dict(equal=bool(equal))
    for order in (list(fns), list(fns)[::-1]):
        for key in order:
            row["runs"][key].setdefault("ms", []).append(cs.cuda_ms(fns[key], 20))
    it = row.get("loop_iterations")
    print(f"ablation {kernel} {label}: N {n}, bound {row['bound_ms']:.4f} ms, lanes with "
          f"candidates {row['lanes_with_candidates']:.4f}, at K {row['lanes_at_k']:.4f}"
          + (f", loop iterations with the exit: lane mean {it['lane_mean']:.3f}, warp max "
             f"mean {it['warp_max_mean']:.3f} of {it['of']}" if it else ""))
    for key, r in row["runs"].items():
        ms = sum(r["ms"]) / 2
        print(f"  {key:26s} {ms:.4f} ms ({r['ms'][0]:.4f} / {r['ms'][1]:.4f}), "
              f"{row['bound_ms'] / ms:.3f} of bound, equal to the plain version {r['equal']}")
    results.append(row)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier tree: also time its schedule_pack.cu")
    parser.add_argument("--out", type=Path, default=OUT_DIR / "pack_ablation.json",
                        help="where the JSON of every number goes")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("pack_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build_copies(opts.parent)
    print(f"built {len(libs)} copies of schedule_pack.cu in {time.perf_counter() - t0:.1f} s")
    for name, (_, rows) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r['regs']} regs, {r['smem']} B static smem, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B, stack {r['stack']} B" for r in rows))
    results = []

    args, kw, tiles = test_rays(dev, glass=False)
    tb = tiles.mini_table.numel() * 4
    run_set("test rays 1080p", "K1", fs.schedule_pack, fs.schedule_pack_ref, args, kw, libs,
            results, table_bytes=tb)
    strips = build_home_strips(tiles, cs.H_FULL, cs.W_FULL)
    k6_args = (*args[:7], strips, args[7])
    k6_kw = dict(kw, home_shape=(cs.H_FULL, cs.W_FULL))
    run_set("test rays 1080p", "K6", fs.schedule_pack_home, fs.schedule_pack_home_ref, k6_args,
            k6_kw, libs, results, table_bytes=tb + strips.numel() * 4)

    calls, tiles = frame_calls(dev, "headline", "schedule_pack")
    tb = tiles.mini_table.numel() * 4
    for b, (a, kwc) in enumerate(calls):
        run_set(f"headline frame bounce {b} rays", "K1", fs.schedule_pack,
                fs.schedule_pack_ref, a, kwc, libs, results, table_bytes=tb)
    a, kwc = calls[0]
    strips = build_home_strips(tiles, cs.H_FULL, cs.W_FULL)
    run_set("headline frame bounce 0 rays", "K6", fs.schedule_pack_home,
            fs.schedule_pack_home_ref, (*a[:7], strips, a[7]),
            dict(kwc, home_shape=(cs.H_FULL, cs.W_FULL)), libs, results,
            table_bytes=tb + strips.numel() * 4)

    args, kw = test_rays(dev, glass=True)
    cw = kw["chunks_per_combo"] * 128
    tb = (args[7].numel() + args[8].numel()) * 4
    run_set("test rays 1080p inside 0", "K4", fs.schedule_pack_dual, fs.schedule_pack_dual_ref,
            args, kw, libs, results, dual_table_words=2 * cw, table_bytes=tb)
    calls, tiles = frame_calls(dev, "dual", "schedule_pack_dual")
    for b, (a, kwc) in enumerate(calls):
        run_set(f"dual frame bounce {b} rays", "K4", fs.schedule_pack_dual,
                fs.schedule_pack_dual_ref, a, kwc, libs, results,
                dual_table_words=2 * kwc["chunks_per_combo"] * 128, table_bytes=tb)

    ok = all(r["equal"] for row in results for r in row["runs"].values())
    out = opts.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, ptxas={k: v[1] for k, v in libs.items()},
                                   sets=results), indent=1))
    print(f"every copy equal to its plain version: {ok}")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
