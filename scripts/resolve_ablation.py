#!/usr/bin/env python3
"""Ablation of kernels R1 and R1-dual (``csrc/resolve_rounds.cu``) on one
NVIDIA GPU: where their time goes, and which design is fastest.

    python3 scripts/resolve_ablation.py [--parent DIR] [--out FILE]   # repository root, a GPU

Writes patched copies of ``resolve_rounds.cu`` (``COPIES``: each a list
of exact text replacements, each of which must match as often as it
says) into ``build/resolve_ablation/``, builds them and the unpatched
file, one ``nvcc`` per copy, all started together, and prints each
copy's registers and spills (``-Xptxas -v``) and, from ``cuobjdump
-sass``, the SASS instructions of each loop of each kernel. Then, through
the port's own wrappers, it times each copy with ``chip_smoke.cuda_ms``
(20 launches, twice, in forward and reverse order) and holds the exact
copies' outputs against the plain version bit for bit, on:

- the phase-3 test rays of ``chip_smoke.py`` at 1920x1080 (BoxScene
  bounce-0 reflections, tilted): R1 from the zero state and from K6's
  state, R1-dual on the glass box with insideObject 0;
- the frames' own inputs: R1's in each bounce of a 1080p headline frame
  and in bounce 0 of a home frame (from K6's state), R1-dual's in each
  bounce of a 1080p dual frame, caught on the way through
  ``trace_frame_hiz``.

The split. The copies named ``fixed*`` drop the round structure: a lane
tests every link in [ptr, n_cand) and the script passes ptr plus the
number of links the plain version tested (``links_out``) as n_cand, so
every such copy does the same work on every lane. ``fixed`` keeps every
link's work and is exact; (a) ``fixed-slots`` makes the slot fields
from the lane and link index instead of reading them; (b)
``fixed-table`` takes the table word from a register; (c)
``fixed-arith`` replaces the IEEE divides with one approximate
reciprocal and drops the search budget. Each term is ``fixed`` minus
its copy; the round structure's own cost is the unpatched kernel minus
``fixed``. (d), SIMT divergence, is the warp efficiency of the plain
version's link counts (``chip_smoke.warp_efficiency``). The design's
choices, each exact: ``float-decode`` and ``eager-budget`` put back the
earlier f32 decode and the budget on every link; ``plain-loads`` reads
the slots and the table without ``__ldg``; ``prefetch`` loads the next
link's slot fields while the current one is tested; ``t64`` / ``t256``
and ``min*`` change the block size and the blocks an SM that
``__launch_bounds__`` asks for (``free-regs``: none); ``stream-rows``
and ``stream-slots`` store the rows and read the slots evict-first. With ``--parent
DIR`` (an unpacked earlier tree, e.g. ``git archive`` of the parent
commit) that tree's own ``resolve_rounds.cu`` is built and timed beside
the copies, as "parent". Writes every number to ``--out`` (default
``build/resolve_ablation/resolve_ablation.json``).
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pack_ablation as pa  # noqa: E402
from unitysspathtracingurp_tpu_torch.kernels import build  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph  # noqa: E402
from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_home_strips  # noqa: E402

OUT_DIR = ROOT / "build" / "resolve_ablation"
ENTRIES = ("sspt_resolve_rounds", "sspt_resolve_rounds_dual")

# A copy is a list of replacements (old, new, times old occurs).

# The flat loop without its round structure: a lane tests every link in
# [ptr, n_cand), the script passing ptr + the plain version's link count
# as n_cand.
FIXED = [("    if (j > 0 && pair != pair0) {\n", "    if (false) {\n", 1),
         ("    if (more && ++j == a.chain) {\n", "    if (false) {\n", 1)]
# (a) The slot fields made from the lane and the link.
SLOTS_MADE = [
    ("    const float cd = __ldg(a.pk_cum + o);\n"
     "    const int sc = static_cast<int>(__ldg(a.pk_scode + o));\n",
     "    const float cd = 0.25f * static_cast<float>(ptr + 1);\n"
     "    const int sc = ptr + 65 * (ptr + 1) + 8192 * (lane & 63);\n", 1),
    ("      const float step = __ldg(dual.pk_step + o) * 0.025f;\n",
     "      const float step = static_cast<float>(ptr + 1) * 0.025f;\n", 1),
]
# (b) The table word from registers.
TABLE_MADE = [
    ("      const uint32_t word = __ldg(a.table + (row_off + pair) * 128 + texel);\n",
     "      const uint32_t word = 0x3C003C00u ^ static_cast<uint32_t>(texel + pair);\n", 1),
    ("      const uint32_t word = __ldg(a.table + static_cast<size_t>(pair) * 128 + texel);\n",
     "      const uint32_t word = 0x3C003C00u ^ static_cast<uint32_t>(texel + pair);\n", 1),
]
# (c) One approximate reciprocal for the divides, no search budget, the
# step index by a mask.
ARITH = [
    ("    const float u = cx / w * 0.5f + 0.5f;\n    const float v = cy / w * 0.5f + 0.5f;\n"
     "    const float hitd = 1.0f / (cz / w * zz + zw);\n",
     "    const float rw = __fdividef(1.0f, w);\n    const float u = cx * rw * 0.5f + 0.5f;\n"
     "    const float v = cy * rw * 0.5f + 0.5f;\n"
     "    const float hitd = __fdividef(1.0f, cz * rw * zz + zw);\n", 1),
    ("1.0f / (t_raw * zz + zw)", "__fdividef(1.0f, t_raw * zz + zw)", 1),
    ("1.0f / (b_raw * zz + zw)", "__fdividef(1.0f, b_raw * zz + zw)", 1),
    ("1.0f / (d_raw * zz + zw)", "__fdividef(1.0f, d_raw * zz + zw)", 1),
    ("        const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));\n",
     "        const float halvings = 0.0f;\n", 2),
    ("    const int s_idx = (sc & 8191) % 65;\n", "    const int s_idx = sc & 63;\n", 1),
]
# The earlier decode: f32 floorf / fmodf (same values).
FLOAT_DECODE = [
    ("    const int sc = static_cast<int>(__ldg(a.pk_scode + o));\n",
     "    const float scode = __ldg(a.pk_scode + o);\n"
     "    const int sc = static_cast<int>(scode);\n", 1),
    ("    const float th = static_cast<float>(sc >> 13) * 0.025f;\n"
     "    const int s_idx = (sc & 8191) % 65;\n",
     "    const float th = floorf(scode / 8192.0f) * 0.025f;\n"
     "    const int s_idx = static_cast<int>(fmodf(fmodf(scode, 8192.0f), 65.0f));\n", 1),
]
# The earlier budget: computed for every link (same values).
EAGER_BUDGET = [
    ("      hit_now = !is_sky && base_hit;\n"
     "      // The search budget only where it decides the result.\n"
     "      if (!is_sky && !base_hit && search_ok && d <= 0.0f) {\n"
     "        const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));\n"
     "        hit_now = static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(a.s_max);\n"
     "      }\n",
     "      const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));\n"
     "      const bool budget_ok =\n"
     "          static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(a.s_max);\n"
     "      hit_now = !is_sky && (base_hit || (search_ok && (d <= 0.0f) && budget_ok));\n", 1),
    ("      hit_now = (d <= 0.0f) && (d >= -th) && !is_sky;\n"
     "      if (!hit_now && backray && d <= 0.0f && !is_sky) {\n"
     "        const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));\n"
     "        hit_now = static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(a.s_max);\n"
     "      }\n",
     "      const float halvings = ceilf(log2f(fmaxf(-d / fmaxf(th, 1e-6f), 1.0f)));\n"
     "      const bool budget_ok =\n"
     "          static_cast<float>(s_idx + 1) + halvings <= static_cast<float>(a.s_max);\n"
     "      hit_now = (d <= 0.0f) && ((d >= -th) || (backray && budget_ok)) && !is_sky;\n", 1),
]
BOUNDS = "__launch_bounds__(THREADS, DUAL ? 8 : 12)"
# The slot and table reads as plain loads, not through the read-only
# data cache (__ldg).
PLAIN_LOADS = [
    ("__ldg(a.pk_cum + o)", "a.pk_cum[o]", 1),
    ("__ldg(a.pk_scode + o)", "a.pk_scode[o]", 1),
    ("__ldg(dual.pk_step + o)", "dual.pk_step[o]", 1),
    ("__ldg(a.table + (row_off + pair) * 128 + texel)", "a.table[(row_off + pair) * 128 + texel]",
     1),
    ("__ldg(a.table + static_cast<size_t>(pair) * 128 + texel)",
     "a.table[static_cast<size_t>(pair) * 128 + texel]", 1),
]
# The next link's slot fields loaded while the current link is tested.
PREFETCH = [
    ("  int r = 0, j = 0, pair0 = 0;\n  while (more) {\n",
     "  int r = 0, j = 0, pair0 = 0;\n"
     "  float cd_n = 0.0f, step_n = 0.0f;\n"
     "  int sc_n = 0;\n"
     "  if (more) {\n"
     "    const size_t o0 = static_cast<size_t>(ptr) * nn + lane;\n"
     "    cd_n = __ldg(a.pk_cum + o0);\n"
     "    sc_n = static_cast<int>(__ldg(a.pk_scode + o0));\n"
     "    if (DUAL) step_n = __ldg(dual.pk_step + o0);\n"
     "  }\n"
     "  while (more) {\n", 1),
    ("    const float cd = __ldg(a.pk_cum + o);\n"
     "    const int sc = static_cast<int>(__ldg(a.pk_scode + o));\n",
     "    const float cd = cd_n;\n"
     "    const int sc = sc_n;\n"
     "    const float step_c = step_n;\n"
     "    if (ptr + 1 < nc) {\n"
     "      cd_n = __ldg(a.pk_cum + o + nn);\n"
     "      sc_n = static_cast<int>(__ldg(a.pk_scode + o + nn));\n"
     "      if (DUAL) step_n = __ldg(dual.pk_step + o + nn);\n"
     "    }\n", 1),
    ("__ldg(dual.pk_step + o) * 0.025f", "step_c * 0.025f", 1),
]

def streaming_rows(src: str) -> str:
    """Every row store as a streaming store (``__stcs``: evict first), so
    the rows do not push the table and the slot sectors out of L2."""
    out, n = re.subn(r"(out\[[^\]]+\]) = ([^;]+);", r"__stcs(&\1, \2);", src)
    if n != 27:
        raise RuntimeError(f"{n} row stores, not 27")
    return out


# The slot fields read as streaming loads (``__ldcs``: evict first).
STREAMING_SLOTS = [
    ("__ldg(a.pk_cum + o)", "__ldcs(a.pk_cum + o)", 1),
    ("__ldg(a.pk_scode + o)", "__ldcs(a.pk_scode + o)", 1),
    ("__ldg(dual.pk_step + o)", "__ldcs(dual.pk_step + o)", 1),
]


def shape(threads: int | None, plain: int | None, dual: int | None = None) -> list:
    """The block size and the blocks an SM ``__launch_bounds__`` asks for
    (plain, dual; None: none)."""
    patches = []
    if threads is not None:
        patches.append(("constexpr int THREADS = 128;\n", f"constexpr int THREADS = {threads};\n",
                        1))
    bounds = ("__launch_bounds__(THREADS)" if plain is None
              else f"__launch_bounds__(THREADS, DUAL ? {dual} : {plain})")
    return patches + [(BOUNDS, bounds, 1)]


# name: (replacements, exact, fixed-count); a replacement may also be a
# function of the source. "library" is
# resolve_rounds.cu itself; "parent", with --parent, that tree's.
COPIES = {
    "library": ([], True, False),
    "free-regs": (shape(None, None), True, False),
    "min8/6": (shape(None, 8, 6), True, False),
    "min10/8": (shape(None, 10, 8), True, False),
    "t64": (shape(64, 24, 16), True, False),
    "stream-rows": ([streaming_rows], True, False),
    "stream-slots": (STREAMING_SLOTS, True, False),
    "t64+stream-rows": (shape(64, 24, 16) + [streaming_rows], True, False),
    "t256": (shape(256, 6, 4), True, False),
    "plain-loads": (PLAIN_LOADS, True, False),
    "prefetch": (PREFETCH, True, False),
    "float-decode": (FLOAT_DECODE, True, False),
    "eager-budget": (EAGER_BUDGET, True, False),
    "fixed": (FIXED, True, True),
    "fixed-slots": (FIXED + SLOTS_MADE, False, True),
    "fixed-table": (FIXED + TABLE_MADE, False, True),
    "fixed-arith": (FIXED + ARITH, False, True),
}


def patched(src: str, patches: list) -> str:
    """``src`` with each replacement applied in turn; each old text must
    occur exactly as often as it says."""
    for patch in patches:
        if callable(patch):
            src = patch(src)
            continue
        old, new, times = patch
        if src.count(old) != times:
            raise RuntimeError(f"anchor found {src.count(old)} times, not {times}: {old!r}")
        src = src.replace(old, new)
    return src


def file_name(copy: str) -> str:
    return re.sub(r"[^\w-]", "_", copy)


def build_copies(parent: Path | None) -> dict:
    """{copy: (ctypes library, ptxas rows, SASS loops)}, all nvcc
    processes at once. A copy that fails to build is reported and left out."""
    nvcc = build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.SRC_DIR / "resolve_rounds.cu"
    jobs = {}
    for name, (patches, _, _) in COPIES.items():
        path = src
        if patches:
            path = OUT_DIR / f"{file_name(name)}.cu"
            path.write_text(patched(src.read_text(), patches))
        jobs[name] = path
    if parent is not None:
        jobs["parent"] = parent / "unitysspathtracingurp_tpu_torch" / "csrc" / "resolve_rounds.cu"
    procs = {}
    for name, path in jobs.items():
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
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = (lib, build.parse_ptxas(out), build.sass_loops(so))
    return libs


@contextlib.contextmanager
def use(lib):
    """The wrappers launch ``lib``'s kernels."""
    real = build.load_library
    build.load_library = lambda: lib
    try:
        yield
    finally:
        build.load_library = real


def run_set(label, dual, args, kw, libs, results):
    """Time and check every copy on one input set of R1 (``dual``:
    R1-dual)."""
    wrapper = ph.resolve_rounds_dual if dual else ph.resolve_rounds
    ref, links, b = cs.r1_reference(args, kw, dual)
    n = args[0].shape[1]
    n_links = float(links.sum())
    state = kw.get("state")
    ptr0 = (state[0].to(torch.int32) if state is not None
            else torch.zeros(n, dtype=torch.int32, device=links.device))
    # The fixed-count copies: n_cand = ptr + the links the plain version tested.
    ci = 4 if dual else 3
    fixed_args = list(args)
    fixed_args[ci] = ptr0 + links.to(torch.int32)
    row = dict(label=label, kernel="R1-dual" if dual else "R1", n=n, rounds=kw["n_rounds"],
               state_in=state is not None, links_per_lane=n_links / n,
               warp_efficiency=cs.warp_efficiency(links), runs={}, **b)
    fns = {}
    for name in [*COPIES, "parent"]:
        if name not in libs:
            continue
        _, exact, is_fixed = COPIES.get(name, ([], True, False))
        a = fixed_args if is_fixed else args

        def fn(lib=libs[name][0], a=a):
            with use(lib):
                return wrapper(*a, **kw)

        got = fn()
        torch.cuda.synchronize()
        equal = torch.equal(got.view(torch.int32), ref.view(torch.int32)) if exact else None
        fns[name] = fn
        row["runs"][name] = dict(equal=equal)
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            row["runs"][name].setdefault("ms", []).append(cs.cuda_ms(fns[name], 20))
    ms = {name: sum(r["ms"]) / 2 for name, r in row["runs"].items()}
    row["split"] = {term: ms["fixed"] - ms[copy] for term, copy in (
        ("a_slot_reads", "fixed-slots"), ("b_table_reads", "fixed-table"),
        ("c_arithmetic", "fixed-arith")) if copy in ms and "fixed" in ms}
    if "fixed" in ms:
        row["split"]["rounds_control"] = ms["library"] - ms["fixed"]
    print(f"ablation {row['kernel']} {label}: N {n}, {kw['n_rounds']} rounds"
          f"{', state in' if state is not None else ''}, {row['links_per_lane']:.3f} links a "
          f"lane, warp efficiency {row['warp_efficiency']:.4f}, bound {row['bound_ms']:.4f} ms")
    for name, r in row["runs"].items():
        print(f"  {name:14s} {ms[name]:.4f} ms ({r['ms'][0]:.4f} / {r['ms'][1]:.4f}), "
              f"{row['bound_ms'] / ms[name]:.3f} of bound, equal to the plain version "
              f"{'n/a' if r['equal'] is None else r['equal']}")
    print("  split (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in row["split"].items()))
    results.append(row)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier tree: also time its resolve_rounds.cu")
    parser.add_argument("--out", type=Path, default=OUT_DIR / "resolve_ablation.json",
                        help="where the JSON of every number goes")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("resolve_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build_copies(opts.parent)
    print(f"built {len(libs)} copies of resolve_rounds.cu in {time.perf_counter() - t0:.1f} s")
    for name, (_, rows, loops) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r['regs']} regs, spills {r['spill_stores']}/{r['spill_loads']} B, "
            f"stack {r['stack']} B" for r in rows))
        for kernel, sass in loops.items():
            print(f"sass {name} {kernel}: {sass['instructions']} instructions, loops "
                  f"{sass['loops']}")
    results = []

    args, kw, tiles = pa.test_rays(dev, glass=False)
    packs = fs.schedule_pack(*args, **kw)
    r_args = (*packs, args[0], args[1], args[5], tiles.pair_table, args[7])
    r_kw = dict(gh=cs.H_FULL, gw=cs.W_FULL, pairs_x=tiles.pairs_x, n_rounds=4, chain=4,
                s_max=24)
    run_set("test rays 1080p", False, r_args, r_kw, libs, results)
    strips = build_home_strips(tiles, cs.H_FULL, cs.W_FULL)
    *hpacks, home = fs.schedule_pack_home(*args[:7], strips, args[7], **kw,
                                          home_shape=(cs.H_FULL, cs.W_FULL))
    state = torch.cat([torch.zeros_like(home[:1]), home])
    run_set("test rays 1080p from K6's state", False, (*hpacks, *r_args[4:]),
            dict(r_kw, state=state), libs, results)
    del packs, hpacks, home, state

    args, kw, tiles = pa.test_rays(dev, glass=True)
    packs = fs.schedule_pack_dual(*args, **kw)
    d_args = (*packs, args[0], args[1], args[6], args[5], args[6], tiles.tile_table, args[9])
    d_kw = dict(gh=cs.H_FULL, gw=cs.W_FULL, tiles_x=tiles.tiles_x,
                tiles_per_combo=tiles.tiles_per_combo, n_rounds=4, chain=4, s_max=24,
                has_back=True)
    run_set("test rays 1080p inside 0", True, d_args, d_kw, libs, results)
    del packs

    for path, dual, bounces in (("headline", False, None), ("home", False, 1),
                                ("dual", True, None)):
        calls, _ = cs.frame_calls(dev, path, "resolve_rounds_dual" if dual else "resolve_rounds")
        for b, (a, kwc) in enumerate(calls[:bounces]):
            run_set(f"{path} frame bounce {b}", dual, a, kwc, libs, results)
        del calls

    ok = all(r["equal"] is not False for row in results for r in row["runs"].values())
    out = opts.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, ptxas={k: v[1] for k, v in libs.items()},
                                   sass={k: v[2] for k, v in libs.items()}, sets=results),
                              indent=1))
    print(f"every exact copy equal to its plain version: {ok}")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
