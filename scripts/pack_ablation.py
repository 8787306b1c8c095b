#!/usr/bin/env python3
"""Ablation of kernels K1, K4 and K6 (``csrc/schedule_pack.cu``) on one
NVIDIA GPU: where their time goes, and which design is fastest.

    python3 scripts/pack_ablation.py [--parent DIR] [--out FILE] [--kernels K1,K4,K6]
                                     [--copies NAME,...]   # repository root, a GPU

Writes patched copies of ``schedule_pack.cu`` (``COPIES``: each a list of
exact text replacements, each of which must match once) into
``build/pack_ablation/``, builds them and the unpatched file, one
``nvcc`` per copy, all started together, and prints each copy's
registers, shared memory and spills (``-Xptxas -v``) and, with
``--parent``, whether K1's and K4's SASS (``cuobjdump -sass``) is the
parent's instruction for instruction. Then, through the port's own
wrappers, it times each copy with CUDA events (20 launches,
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
a warp run with the exit come from the ``none+exit`` copy. K6's copies
run in the copy's own block (``Copy.home_*``): ``home-rR`` change its
rows a block (and the blocks an SM asked of ptxas), ``home-table*`` hold
the minitile table in shared memory before the staging,
``home-eager-budget`` computes the search budget for every test, and
``home-no-tests`` drops the post-loop exact tests (its packs only are
compared). ``--kernels`` and ``--copies`` pick what is built and timed. With
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
from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings  # noqa: E402
from unitysspathtracingurp_tpu_torch.kernels import build  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops.depth_tiles import (  # noqa: E402
    build_depth_tiles, build_home_strips,
)

OUT_DIR = ROOT / "build" / "pack_ablation"

# Anchors in schedule_pack.cu and what the copies put in their place.
LOOP = "  for (int i = 1; i <= p.s_max && marching && run < k; ++i) {\n"
SLOT_FN = ("  // Field f of slot j, staged on chip.\n"
           "  auto slot = [&](int f, int j) -> float& {\n"
           "    return stage_col[(f * k + j) * static_cast<int>(blockDim.x)];\n"
           "  };\n")
OUTS = "  float* const outs[4] = {a.pk_cum, a.pk_scode, a.pk_hist, dual.pk_step};\n"
WRITE_ROWS = (OUTS + "  write_rows<DUAL ? 4 : 3>(stage, outs, p.n, p.k, "
                     "blockIdx.x * blockDim.x);\n")
WRITE_ROWS_HOME = ("  float* const outs[3] = {a.pk_cum, a.pk_scode, a.pk_hist};\n"
                   "  write_rows<3>(stage, outs, p.n, p.k, lane - threadIdx.x);\n")
STORE = ("        slot(0, run) = cum;\n        slot(1, run) = scode;\n"
         "        slot(2, run) = hist;\n        if (DUAL) slot(3, run) = qstep;\n")
ZERO = ("  for (int j = cnt; j < k; ++j) {\n#pragma unroll\n"
        "    for (int f = 0; f < NF; ++f) slot(f, j) = 0.0f;\n  }\n")
N_CAND = "  if (!HOME) {\n    a.n_cand[lane] = cnt;\n"
COMBO = "  const int combo_off = DUAL ? dual.combo[lane] * dual.combo_words : 0;\n"
LDG = ("      const uint32_t word = __ldg(mini_table + mini);\n"
       "      const uint32_t bword = __ldg(dual.bmax_table + mini);\n")
TABLE = ("  const int table_words = DUAL ? 0 : p.n_mini_words;\n"
         "  for (int i = threadIdx.x; i < table_words; i += blockDim.x) s_dyn[i] = mini_table[i];\n")
HOME_HEAD = ("  extern __shared__ float stage[];\n"
             "  const int row = blockIdx.y * HOME_BLOCK_ROWS + (threadIdx.x >> 7);\n")
HOME_CALL = "  pack_lane<false, true>(lane, a, mini_table, p, none, home, stage + threadIdx.x);\n"
HOME_READ = "        word = __ldg(mini_table + mini);\n"
HOME_SMEM = "  if (smem < 3 * k * threads * 4)"
LAZY_BUDGET = ("    bool hit = (dd <= 0.0f) && !is_sky;\n"
               "    if (hit && !(dd >= -th_q)) {\n"
               "      hit = false;\n"
               "      if (backray) {\n"
               "        const float halv = ceilf(log2f(fmaxf(-dd / fmaxf(th_q, 1e-6f), 1.0f)));\n"
               "        hit = sidx + 1.0f + halv <= static_cast<float>(p.s_max);\n"
               "      }\n"
               "    }\n")

# Every lane runs s_max steps.
NO_EXIT = [(LOOP, "  for (int i = 1; i <= p.s_max; ++i) {\n")]
# Each slot stored to device memory at the step that finds it (the
# earlier design of K1 / K4, and of K6 before it staged), zeros past the
# count after the loop.
DEVICE = [(SLOT_FN, OUTS + "  auto slot = [&](int f, int j) -> float& {\n"
                           "    return outs[f][static_cast<size_t>(j) * n + lane];\n  };\n"),
          (WRITE_ROWS, ""), (WRITE_ROWS_HOME, "")]
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
COLUMN = ("#pragma unroll\n  for (int f = 0; f < NF; ++f) {\n"
          "    for (int j = 0; j < k; ++j)\n"
          "      outs[f][static_cast<size_t>(j) * n + lane] = j < cnt ? slot(f, j) : 0.0f;\n"
          "  }\n")
LANES = [(SLOT_FN, OUTS + SLOT_FN), (ZERO, COLUMN), (WRITE_ROWS, ""), (WRITE_ROWS_HOME, "")]
# The slots in per-thread local arrays instead of shared memory.
LOCAL = [(SLOT_FN, OUTS + "  float local_slots[4][16];\n"
                          "  auto slot = [&](int f, int j) -> float& "
                          "{ return local_slots[f][j]; };\n"),
         (ZERO, COLUMN), (WRITE_ROWS, ""), (WRITE_ROWS_HOME, "")]
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


def home_rows(rows: int, min_blocks: int) -> list:
    """K6 with blocks of ``rows`` screen rows (rows x 128 threads) and
    ``min_blocks`` blocks an SM asked of ptxas."""
    return [("constexpr int HOME_BLOCK_ROWS = 2;\n", f"constexpr int HOME_BLOCK_ROWS = {rows};\n"),
            ("constexpr int HOME_MIN_BLOCKS = 4;\n",
             f"constexpr int HOME_MIN_BLOCKS = {min_blocks};\n")]


# K6 with the minitile table in shared memory, before the staging.
HOME_SHARED_TABLE = [
    (HOME_HEAD, "  extern __shared__ float stage_all[];\n"
                "  uint32_t* s_tab = reinterpret_cast<uint32_t*>(stage_all);\n"
                "  for (int i = threadIdx.x; i < p.n_mini_words; i += blockDim.x) "
                "s_tab[i] = mini_table[i];\n"
                "  __syncthreads();\n"
                "  float* stage = stage_all + p.n_mini_words;\n"
                "  const int row = blockIdx.y * HOME_BLOCK_ROWS + (threadIdx.x >> 7);\n"),
    (HOME_CALL, "  pack_lane<false, true>(lane, a, s_tab, p, none, home, stage + threadIdx.x);\n"),
    (HOME_READ, "        word = mini_table[mini];\n"),
    (HOME_SMEM, "  if (smem < (n_mini_words + 3 * k * threads) * 4)"),
]
# K6 computing the search budget for every test.
HOME_EAGER = [(LAZY_BUDGET,
               "    const float halv = ceilf(log2f(fmaxf(-dd / fmaxf(th_q, 1e-6f), 1.0f)));\n"
               "    const bool budget_ok = sidx + 1.0f + halv <= static_cast<float>(p.s_max);\n"
               "    const bool hit = (dd <= 0.0f) && !is_sky && ((dd >= -th_q) || "
               "(backray && budget_ok));\n")]
# K6 without the post-loop exact tests of the home slots (the routing
# stays; n_cand and the (11, N) rows are then not K6's).
HOME_NO_TESTS = [("    if (j >= run_home || hitf) continue;\n", "    if (true) continue;\n")]
STRIP_WORDS = 3 * 6 * 128  # a lane block's home strip (the parent's K6 held it)


class Copy(NamedTuple):
    """A copy of schedule_pack.cu: its replacements; whether K1 / K4 stage
    slots in shared memory, K4 its combo's tables (the budget the wrappers
    pass); K6's block (threads, and what its shared memory holds: the
    table, the strip, the staging); whether it has slots at all, and
    whether all its outputs are the plain version's (else K6's packs only)."""

    patches: list
    staged: bool = True
    tables: bool = False
    home_threads: int = 256
    home_table: bool = False
    home_strip: bool = False
    home_stage: bool = True
    slots: bool = True
    exact: bool = True


# "library" is schedule_pack.cu itself, as the wrappers load it (K1 / K4
# / K6 staged with the warp's row copies and the exit; K6 in 256-thread
# blocks of 2 rows, four an SM, the table and the strip read through
# __ldg, the lazy search budget). "parent": with --parent, that tree's own
# schedule_pack.cu (entry points with the same arguments; its K6 marched
# a lane block's 8 rows with 128 threads, the table and the strip in
# shared memory, and stored each slot at once).
PARENT = Copy([], home_threads=128, home_table=True, home_strip=True, home_stage=False)
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
    "home-r1": Copy(home_rows(1, 8), home_threads=128),
    "home-r2-min3": Copy(home_rows(2, 3)),
    "home-r4": Copy(home_rows(4, 2), home_threads=512),
    "home-r8": Copy(home_rows(8, 1), home_threads=1024),
    "home-table": Copy(HOME_SHARED_TABLE, home_table=True),
    "home-table-r4": Copy(HOME_SHARED_TABLE + home_rows(4, 2), home_threads=512,
                          home_table=True),
    "home-eager-budget": Copy(HOME_EAGER),
    "home-no-tests": Copy(HOME_NO_TESTS, exact=False),
}
# (copy, threads a block) timed per kernel; None: the budget's choice
# (K6: the copy's own block).
RUNS = {
    "K1": [("parent", None), ("device", 128), ("device+exit", 128), ("none", 128),
           ("none+exit", 128), ("none+exit+occ3", 512), ("shared", None),
           ("library", 128), ("library", 256), ("library", 512),
           ("shared-lanes+exit", None), ("local+exit", 128), ("local+exit", 512)],
    "K4": [("parent", None), ("device", 128), ("device+exit", 128), ("none", 128),
           ("none+exit", 128), ("none+exit+occ3", 512), ("shared", None),
           ("library", 128), ("library", 256), ("library", 512),
           ("shared-lanes+exit", None), ("local+exit", 128), ("local+exit", 512),
           ("shared+exit+tables", 128), ("shared+exit+tables", 256)],
    "K6": [("parent", None), ("library", None), ("device+exit", None), ("none+exit", None),
           ("shared-lanes+exit", None), ("home-r1", None), ("home-r2-min3", None),
           ("home-r4", None), ("home-r8", None), ("home-table", None), ("home-table-r4", None),
           ("home-eager-budget", None), ("home-no-tests", None)],
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


def build_copies(parent: Path | None, names=None) -> dict:
    """{copy: (ctypes library, ptxas rows)} of ``names`` (default all),
    all nvcc processes at once."""
    nvcc = build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.SRC_DIR / "schedule_pack.cu"
    jobs = {}
    for name, copy in COPIES.items():
        if names is not None and name not in names:
            continue
        path = src
        if copy.patches:
            path = OUT_DIR / f"{name.replace('+', '_')}.cu"
            path.write_text(patched(src.read_text(), copy.patches))
        jobs[name] = path
    if parent is not None:
        jobs["parent"] = parent / "unitysspathtracingurp_tpu_torch" / "csrc" / "schedule_pack.cu"
    # The copies include the package's shared headers.
    include = ["-I", str(build.SRC_DIR)]
    procs = {}
    for name, path in jobs.items():
        so = OUT_DIR / f"{name.replace('+', '_')}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *include, "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for copy {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = (lib, build.parse_ptxas(out))
    return libs


def sass(so: Path) -> dict:
    """{kernel: its SASS instructions} from ``cuobjdump -sass`` (empty
    where cuobjdump is missing)."""
    nvcc = build.nvcc_path()
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True).stdout
    code, name = {}, None
    for line in out.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = build._kernel_name(m.group(1))
            code[name] = []
        elif name is not None and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)):
            code[name].append(m.group(1).strip())
    return code


@contextlib.contextmanager
def use(lib, copy: Copy, forced: int | None, dual_table_words: int = 0,
        home_table_words: int = 0):
    """The wrappers launch ``lib``'s kernels with ``forced`` threads a
    block (None: the budget's choice; K6 the copy's block) and the shared
    memory ``copy`` needs: staging only where it stages in shared memory,
    K4's combo tables where it stages those, K6 what its block holds."""
    real = build.load_library, fs.pack_budget

    def budget(table_words, k, n_fields, threads=None):
        if threads is not None:  # K6: the copy's block
            words = home_table_words * copy.home_table + STRIP_WORDS * copy.home_strip
            return real[1](words, k, 3 * copy.home_stage, threads=copy.home_threads)
        extra = dual_table_words if copy.tables and n_fields == 4 else 0
        return real[1](table_words + extra, k, n_fields if copy.staged else 0, threads=forced)

    build.load_library, fs.pack_budget = (lambda: lib), budget
    try:
        yield
    finally:
        build.load_library, fs.pack_budget = real


def test_rays(dev, glass: bool):
    """The phase-3 test inputs of chip_smoke.py at 1080p, (args, kwargs,
    tiles): K1 (and K6's extra arguments), or K4 with insideObject 0."""
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
                 fs.schedule_scalars(cam)), dict(kw, chunks_per_combo=tiles.chunks_per_combo),
                tiles)
    return (*lane, is_back, tiles.mini_table, fs.schedule_scalars(cam)), kw, tiles


def bound_ms(kernel: str, n: int, k: int, table_bytes: int) -> float:
    """chip_smoke.py's bytes for the kernel at N lanes (every bound of
    these kernels is set by bytes)."""
    per_lane = {"K1": 34 + k * 12 + 4, "K4": 38 + k * 16 + 4,
                "K6": 34 + k * 12 + 4 + 11 * 4}[kernel]
    return (n * per_lane + table_bytes) / cs.HBM_BYTES_PER_S * 1e3


def run_set(label, kernel, wrapper, ref_fn, args, kw, libs, results, dual_table_words=0,
            table_bytes=0, home_table_words=0):
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
        spec = PARENT if copy == "parent" else COPIES[copy]

        def fn(lib=lib, spec=spec, threads=threads):
            with use(lib, spec, threads, dual_table_words, home_table_words):
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
        elif not spec.exact:
            equal = all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3]))
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
    parser.add_argument("--kernels", default="K1,K4,K6",
                        help="the kernels to time, comma-separated (default all)")
    parser.add_argument("--copies", default=None,
                        help="the copies to build and time, comma-separated (default all)")
    opts = parser.parse_args()
    only = set(opts.kernels.split(","))
    names = None if opts.copies is None else set(opts.copies.split(","))
    if not torch.cuda.is_available():
        print("pack_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build_copies(opts.parent, names)
    print(f"built {len(libs)} copies of schedule_pack.cu in {time.perf_counter() - t0:.1f} s")
    for name, (_, rows) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r['regs']} regs, {r['smem']} B static smem, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B, stack {r['stack']} B" for r in rows))
    results = []
    same_sass = {}
    if "parent" in libs and "library" in libs:
        new, old = (sass(OUT_DIR / f"{name}.so") for name in ("library", "parent"))
        for kernel in ("schedule_pack_kernel<0>", "schedule_pack_kernel<1>"):
            if kernel in new and kernel in old:
                same_sass[kernel] = new[kernel] == old[kernel]
                print(f"SASS of {kernel}: library {len(new[kernel])} instructions, parent "
                      f"{len(old[kernel])}, identical {same_sass[kernel]}")

    args, kw, tiles = test_rays(dev, glass=False)
    tb = tiles.mini_table.numel() * 4
    if "K1" in only:
        run_set("test rays 1080p", "K1", fs.schedule_pack, fs.schedule_pack_ref, args, kw, libs,
                results, table_bytes=tb)
    strips = build_home_strips(tiles, cs.H_FULL, cs.W_FULL)
    k6_args = (*args[:7], strips, args[7])
    k6_kw = dict(kw, home_shape=(cs.H_FULL, cs.W_FULL))
    if "K6" in only:
        run_set("test rays 1080p", "K6", fs.schedule_pack_home, fs.schedule_pack_home_ref,
                k6_args, k6_kw, libs, results, table_bytes=tb + strips.numel() * 4,
                home_table_words=tiles.mini_table.numel())

    calls, tiles = cs.frame_calls(dev, "headline", "schedule_pack")
    tb = tiles.mini_table.numel() * 4
    for b, (a, kwc) in enumerate(calls if "K1" in only else []):
        run_set(f"headline frame bounce {b} rays", "K1", fs.schedule_pack,
                fs.schedule_pack_ref, a, kwc, libs, results, table_bytes=tb)
    a, kwc = calls[0]
    strips = build_home_strips(tiles, cs.H_FULL, cs.W_FULL)
    if "K6" in only:
        run_set("headline frame bounce 0 rays", "K6", fs.schedule_pack_home,
                fs.schedule_pack_home_ref, (*a[:7], strips, a[7]),
                dict(kwc, home_shape=(cs.H_FULL, cs.W_FULL)), libs, results,
                table_bytes=tb + strips.numel() * 4, home_table_words=tiles.mini_table.numel())

    if "K4" in only:
        args, kw, _ = test_rays(dev, glass=True)
        cw = kw["chunks_per_combo"] * 128
        tb = (args[7].numel() + args[8].numel()) * 4
        run_set("test rays 1080p inside 0", "K4", fs.schedule_pack_dual,
                fs.schedule_pack_dual_ref, args, kw, libs, results, dual_table_words=2 * cw,
                table_bytes=tb)
        calls, tiles = cs.frame_calls(dev, "dual", "schedule_pack_dual")
        for b, (a, kwc) in enumerate(calls):
            run_set(f"dual frame bounce {b} rays", "K4", fs.schedule_pack_dual,
                    fs.schedule_pack_dual_ref, a, kwc, libs, results,
                    dual_table_words=2 * kwc["chunks_per_combo"] * 128, table_bytes=tb)

    ok = all(r["equal"] for row in results for r in row["runs"].values())
    out = opts.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, ptxas={k: v[1] for k, v in libs.items()},
                                   same_sass_as_parent=same_sass, sets=results), indent=1))
    print(f"every copy equal to its plain version: {ok}")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
