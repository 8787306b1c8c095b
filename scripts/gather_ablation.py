#!/usr/bin/env python3
"""Ablation of kernel K3 (``pack_by_slot``, ``csrc/pallas_gather.cu``) on
one NVIDIA GPU: where its time goes, and which design is fastest.

    python3 scripts/gather_ablation.py [--parent DIR] [--out FILE]   # repository root, a GPU

Each copy (``COPIES``) is ``pallas_gather.cu`` with exact text
replacements (each anchor must occur once): K3's kernel replaced by a
variant, its block size, its loads, its launch's shared memory and grid.
The copies go to ``build/gather_ablation/``, one ``nvcc`` per copy, all
started together; the script prints each copy's registers and spills
(``-Xptxas -v``). Then, through the port's own wrapper
(``pallas_gather.pack_by_slot``), it times each copy with
``chip_smoke.cuda_ms`` (20 launches, twice, in forward and reverse order)
and holds its outputs against the plain version bit for bit, on:

- the phase-3 test shape of ``chip_smoke.py``: the 1080p BoxScene test
  rays' 24 steps x 2,073,600 lanes, flags ``proc & rand < 0.5``, with 3
  fields (cum, th, hitd) and with 4 (step added);
- the diagnostic march's own inputs: K3's call in each bounce of the
  1080p headline frame that ``chip_smoke.diagnostic_report`` marches
  (``chip_smoke.frame_calls`` "diagnostic").

Every copy is timed on (S, N) uint8 flags; ``library, bool flags`` times
the unpatched file on the bool flags the march passes, so it includes
whatever the wrapper does with them (the earlier wrapper copied them to
uint8; the wrapper now views their bytes). ``library`` is the shipped
design: one thread a lane, every row's loads four rows at a time, the
slots staged in shared memory ([field][K][block], thread index fastest)
and the warp's rows written as 16-byte stores (``csrc/write_rows.cuh``),
256 threads a block. The split (one thread a lane unless named):

- ``scattered``: the earlier design (each flagged row's loads under the
  branch, each slot stored to row ``run`` of the (K, N) tables at once,
  then the zeros past the count, both scattered across a warp);
- ``branchless``: the same stores, every row's flag and fields loaded
  four rows at a time, then selected: (b) the branchy loads = scattered
  - branchless;
- ``staged-branchy``: the library with the loads under the branch: (a)
  the scattered stores = scattered - staged-branchy;
- ``staged``: the library at another block size;
- ``quad``: four lanes a thread, a 4-byte flag load and 16-byte field
  loads a row, each thread's four lanes staged and written as one
  16-byte store a row;
- ``-tN``: N threads a block, the block size term.

With ``--parent DIR`` (an unpacked earlier tree) that tree's own
``pallas_gather.cu`` is built and timed beside the copies, as "parent".
Writes every number to ``--out`` (default
``build/gather_ablation/gather_ablation.json``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from unitysspathtracingurp_tpu_torch.ops import pallas_gather as pg  # noqa: E402

OUT_DIR = ROOT / "build" / "gather_ablation"

# Anchors in pallas_gather.cu (each must occur once) and what the copies
# put in their place. KERNEL: K3's kernel, from its comment up to the
# next kernel.
THREADS = "constexpr int PACK_THREADS = 256;\n"
KERNEL = ("// Dynamic shared memory: the staging, NF x k x blockDim f32.\n",
          "__global__ void extract_chain_kernel")
SMEM = "    const int smem = nf * k * PACK_THREADS * static_cast<int>(sizeof(float));\n"
BLOCKS = "    const int blocks = (n + PACK_THREADS - 1) / PACK_THREADS;\n"
LOOP_HEAD = """    for (int r = 0; r < s; r += PACK_ROWS) {
      uint8_t c[PACK_ROWS];
"""

# The earlier design: each flagged row's loads under the branch, each
# slot stored to row `run` at once, the zeros past the count after.
SCATTERED = r"""template <int NF>
__global__ void pack_by_slot_kernel(const uint8_t* __restrict__ cand, Fields f,
                                    int32_t* __restrict__ count, int s, int n, int k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int run = 0;
  for (int r = 0; r < s; ++r) {
    const size_t o = static_cast<size_t>(r) * n + lane;
    if (cand[o] == 0) continue;
    if (run < k) {
      const size_t d = static_cast<size_t>(run) * n + lane;
#pragma unroll
      for (int q = 0; q < NF; ++q) f.out[q][d] = f.in[q][o] + 0.0f;
    }
    ++run;
  }
  for (int j = run; j < k; ++j) {
    const size_t d = static_cast<size_t>(j) * n + lane;
#pragma unroll
    for (int q = 0; q < NF; ++q) f.out[q][d] = 0.0f;
  }
  count[lane] = min(run, k);
}

"""

# The same stores, every row's flag and fields loaded four rows at a time.
BRANCHLESS = r"""template <int NF>
__global__ void pack_by_slot_kernel(const uint8_t* __restrict__ cand, Fields f,
                                    int32_t* __restrict__ count, int s, int n, int k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int run = 0;
  for (int r = 0; r < s; r += PACK_ROWS) {
    uint8_t c[PACK_ROWS];
    float v[NF][PACK_ROWS];
#pragma unroll
    for (int u = 0; u < PACK_ROWS; ++u) {
      const size_t o = static_cast<size_t>(min(r + u, s - 1)) * n + lane;
      c[u] = r + u < s ? __ldg(cand + o) : 0;
#pragma unroll
      for (int q = 0; q < NF; ++q) v[q][u] = __ldg(f.in[q] + o);
    }
#pragma unroll
    for (int u = 0; u < PACK_ROWS; ++u) {
      if (c[u] != 0) {
        if (run < k) {
          const size_t d = static_cast<size_t>(run) * n + lane;
#pragma unroll
          for (int q = 0; q < NF; ++q) f.out[q][d] = v[q][u] + 0.0f;
        }
        ++run;
      }
    }
  }
  for (int j = run; j < k; ++j) {
    const size_t d = static_cast<size_t>(j) * n + lane;
#pragma unroll
    for (int q = 0; q < NF; ++q) f.out[q][d] = 0.0f;
  }
  count[lane] = min(run, k);
}

"""

# Staged, with each row's loads under its flag (the span: K3's row loop).
LOOP_END = "  }\n  const int cnt = min(run, k);\n"
BRANCHY = [((LOOP_HEAD, LOOP_END), """    for (int r = 0; r < s; ++r) {
      const size_t o = static_cast<size_t>(r) * n + lane;
      if (cand[o] == 0) continue;
      if (run < k) {
#pragma unroll
        for (int q = 0; q < NF; ++q) col[(q * k + run) * t] = f.in[q][o] + 0.0f;
      }
      ++run;
    }
""")]

# Four lanes a thread: staging [NF][k][4][blockDim], a 4-byte flag load
# and 16-byte field loads a row, one 16-byte store a row from each thread.
QUAD = r"""template <int NF>
__global__ void __launch_bounds__(PACK_THREADS)
pack_by_slot_kernel(const uint8_t* __restrict__ cand, Fields f, int32_t* __restrict__ count,
                    int s, int n, int k) {
  extern __shared__ float stage[];
  const int t = blockDim.x;
  const int lane0 = 4 * (blockIdx.x * t + threadIdx.x);
  float* col = stage + threadIdx.x;
  const bool vec = (n & 3) == 0 && lane0 + 3 < n;
  int run[4] = {0, 0, 0, 0};
  if (lane0 < n) {
    for (int r = 0; r < s; ++r) {
      const size_t o = static_cast<size_t>(r) * n + lane0;
      uint32_t c = 0;
      float v[NF][4];
      if (vec) {
        c = __ldg(reinterpret_cast<const unsigned int*>(cand + o));
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(f.in[q] + o));
          v[q][0] = x.x; v[q][1] = x.y; v[q][2] = x.z; v[q][3] = x.w;
        }
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const bool in = lane0 + l < n;
          c |= static_cast<uint32_t>(in ? cand[o + l] : 0) << (8 * l);
#pragma unroll
          for (int q = 0; q < NF; ++q) v[q][l] = in ? f.in[q][o + l] : 0.0f;
        }
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const bool hit = ((c >> (8 * l)) & 0xFFu) != 0;
        if (hit && run[l] < k) {
#pragma unroll
          for (int q = 0; q < NF; ++q) col[((q * k + run[l]) * 4 + l) * t] = v[q][l] + 0.0f;
        }
        run[l] += hit;
      }
    }
  }
  int cnt[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    cnt[l] = min(run[l], k);
    for (int j = cnt[l]; j < k; ++j) {
#pragma unroll
      for (int q = 0; q < NF; ++q) col[((q * k + j) * 4 + l) * t] = 0.0f;
    }
  }
  if (lane0 >= n) return;
  if (vec) {
    *reinterpret_cast<int4*>(count + lane0) = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
  } else {
    for (int l = 0; l < 4 && lane0 + l < n; ++l) count[lane0 + l] = cnt[l];
  }
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    for (int j = 0; j < k; ++j) {
      const float* sv = col + (q * k + j) * 4 * t;
      float* dst = f.out[q] + static_cast<size_t>(j) * n + lane0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(sv[0], sv[t], sv[2 * t], sv[3 * t]);
      } else {
        for (int l = 0; l < 4 && lane0 + l < n; ++l) dst[l] = sv[l * t];
      }
    }
  }
}

"""

NO_SMEM = [(SMEM, "    const int smem = 0;\n")]
QUAD_LAUNCH = [(SMEM, SMEM.replace("nf * k *", "nf * k * 4 *")),
               (BLOCKS, BLOCKS.replace("(n + PACK_THREADS - 1) / PACK_THREADS",
                                       "(n + 4 * PACK_THREADS - 1) / (4 * PACK_THREADS)"))]


def threads(t: int) -> list:
    return [(THREADS, f"constexpr int PACK_THREADS = {t};\n")]


def kernel(text: str) -> list:
    """Replace K3's kernel (the KERNEL span) with ``text``."""
    return [(KERNEL, text)]


# "library" is pallas_gather.cu itself (one thread a lane, branchless
# loads, staged, 256 threads); "parent" (with --parent) that tree's file.
COPIES = {
    **{f"scattered-t{t}": kernel(SCATTERED) + NO_SMEM + threads(t) for t in (128, 256, 512)},
    **{f"branchless-t{t}": kernel(BRANCHLESS) + NO_SMEM + threads(t) for t in (128, 256)},
    "staged-branchy-t256": BRANCHY,
    **{f"staged-t{t}": threads(t) for t in (128, 512)},
    **{f"quad-t{t}": kernel(QUAD) + QUAD_LAUNCH + threads(t) for t in (32, 64, 128)},
}


def patched(src: str, patches: list) -> str:
    """``src`` with each replacement applied in turn: an (old, new) pair
    replaces text that occurs exactly once; a ((start, end), new) pair
    the text from ``start`` up to ``end``, each occurring once."""
    for old, new in patches:
        start, end = old if isinstance(old, tuple) else (old, None)
        for anchor in (start, end):
            if anchor is not None and src.count(anchor) != 1:
                raise RuntimeError(f"anchor found {src.count(anchor)} times: {anchor!r}")
        i = src.index(start)
        j = src.index(end) if end is not None else i + len(start)
        src = src[:i] + new + src[j:]
    return src


def build_copies(parent: Path | None) -> dict:
    """{copy: (ctypes library, ptxas rows)}, all nvcc processes at once."""
    nvcc = build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.SRC_DIR / "pallas_gather.cu"
    jobs = {"library": src}
    for name, patches in COPIES.items():
        path = OUT_DIR / f"{name}.cu"
        path.write_text(patched(src.read_text(), patches))
        jobs[name] = path
    if parent is not None:
        jobs["parent"] = parent / "unitysspathtracingurp_tpu_torch" / "csrc" / "pallas_gather.cu"
    procs = {}
    for name, path in jobs.items():
        so = OUT_DIR / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-shared", "-o", str(so),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for copy {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        fn = lib.sspt_pack_by_slot
        fn.argtypes = build._SIGNATURES["sspt_pack_by_slot"]
        fn.restype = ctypes.c_int
        libs[name] = (lib, [r for r in build.parse_ptxas(out) if "pack_by_slot" in r["kernel"]])
    return libs


def test_inputs(dev):
    """The phase-3 test shape: (flags as uint8, 4 fields, k) from the 1080p
    test rays' 24 steps; flags proc & rand < 0.5 from a seeded generator."""
    args, kw, _ = pa.test_rays(dev, glass=False)
    steps = list(fs.march_steps(*args[:5], args[7], **kw))
    proc = torch.stack([st["proc"] for st in steps])
    g = torch.Generator(device=dev).manual_seed(0)
    cand = proc & (torch.rand(proc.shape, device=dev, generator=g) < 0.5)
    fields = [torch.stack([st[key] for st in steps]) for key in ("cum", "th", "hitd", "step")]
    return cand, fields, kw["k"]


def run_set(label, cand, fields, k, libs, results):
    """Time and check every copy on one input set."""
    ref = pg.pack_by_slot_ref(cand, fields, k)
    flags = cand.to(torch.uint8)
    s, n = cand.shape
    b = cs.k3_bound(s, n, k, len(fields))
    row = dict(label=label, s=s, n=n, k=k, fields=len(fields), bound_ms=b["bound_ms"],
               flags_set=float(cand.float().mean()), runs={})
    fns = {}
    runs = [(name, flags) for name in libs] + [("library, bool flags", cand)]
    for name, c in runs:
        lib = libs[name.split(",")[0]][0]

        def fn(lib=lib, c=c):
            real = build.load_library
            build.load_library = lambda: lib
            try:
                return pg.pack_by_slot(c, fields, k)
            finally:
                build.load_library = real

        got = fn()
        torch.cuda.synchronize()
        equal = torch.equal(got[1], ref[1]) and all(
            torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got[0], ref[0]))
        fns[name] = fn
        row["runs"][name] = dict(equal=bool(equal))
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            row["runs"][name].setdefault("ms", []).append(cs.cuda_ms(fns[name], 20))
    print(f"ablation K3 {label}: S {s}, N {n}, K {k}, {len(fields)} fields, flags set "
          f"{row['flags_set']:.4f}, bound {row['bound_ms']:.4f} ms")
    for name, r in row["runs"].items():
        ms = sum(r["ms"]) / 2
        print(f"  {name:22s} {ms:.4f} ms ({r['ms'][0]:.4f} / {r['ms'][1]:.4f}), "
              f"{row['bound_ms'] / ms:.3f} of bound, equal to the plain version {r['equal']}")
    results.append(row)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier tree: also time its pallas_gather.cu")
    parser.add_argument("--out", type=Path, default=OUT_DIR / "gather_ablation.json",
                        help="where the JSON of every number goes")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("gather_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build_copies(opts.parent)
    print(f"built {len(libs)} copies of pallas_gather.cu in {time.perf_counter() - t0:.1f} s")
    for name, (_, rows) in libs.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r['regs']} regs, spills {r['spill_stores']}/{r['spill_loads']} B"
            for r in rows))
    results = []
    cand, fields, k = test_inputs(dev)
    run_set("test shape 1080p, 3 fields", cand, fields[:3], k, libs, results)
    run_set("test shape 1080p, 4 fields", cand, fields, k, libs, results)
    del cand, fields
    calls, _ = cs.frame_calls(dev, "diagnostic", "pack_by_slot")
    for b, (a, _) in enumerate(calls):
        run_set(f"diagnostic march bounce {b}", *a, libs, results)
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
