"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface, at first use, into ``build/kernels/``
beside the package, under a name keyed on a hash of the sources, the
headers they share (``csrc/*.cuh``) and the flags. The library is
loaded with ``ctypes``; every entry point returns ``cudaGetLastError()``
and ``check`` raises when it is not 0.

``--fmad=false`` (and no ``--use_fast_math``) keeps each kernel on the
same f32 operation chain as its plain PyTorch version: torch's
elementwise ops round after every operation.

``-Xptxas -v`` makes ptxas report each kernel's registers, static
shared memory and spills; the report is kept beside the library and
``resource_usage`` reads it.

``LAUNCHES`` counts kernel launches per wrapper; only the wrappers add
to it, once per launch.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()

P, I, F, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_uint
_SIGNATURES = {
    # pointers: ray_pos, ray_dir, dither, large_step, alive, is_back,
    # mini_table, scalars, pk_cum, pk_scode, pk_hist, n_cand; then ints
    # n, gh, gw, minis_x, n_mini_words, s_max, k, max_small, max_medium;
    # floats small_step, medium_step, thickness, th_inc, step_growth,
    # th_cap, texel_x, texel_y; ints threads, smem (the block and its
    # dynamic shared bytes, fused_schedule.pack_budget); stream.
    "sspt_schedule_pack": [P] * 12 + [I] * 9 + [F] * 8 + [I] * 2 + [P],
    # pointers: ray_pos, ray_dir, dither, large_step, alive, combo,
    # search, mini_table, bmax_table, scalars, pk_cum, pk_scode, pk_hist,
    # pk_step, n_cand; ints n, gh, gw, minis_x, n_mini_words,
    # combo_words, s_max, k, max_small, max_medium; the same 8 floats;
    # ints threads, smem; stream.
    "sspt_schedule_pack_dual": [P] * 15 + [I] * 10 + [F] * 8 + [I] * 2 + [P],
    # pointers: ray_pos, ray_dir, dither, large_step, alive, is_back,
    # mini_table, strips, scalars, pk_cum, pk_scode, pk_hist, n_cand,
    # home_out; ints h, w (lanes), gh, gw, minis_x, n_mini_words, s_max,
    # k, max_small, max_medium; the same 8 floats; int smem; stream.
    "sspt_schedule_pack_home": [P] * 14 + [I] * 10 + [F] * 8 + [I] + [P],
    # pointers: pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir,
    # is_back, pair_table, scalars, state (or null), out; ints n, k, gh,
    # gw, pairs_x, n_rounds, chain, s_max; stream.
    "sspt_resolve_rounds": [P] * 11 + [I] * 8 + [P],
    # pointers: pk_cum, pk_scode, pk_hist, pk_step, n_cand, ray_pos,
    # ray_dir, is_back, combo, search, tile_table, scalars, state (or
    # null), out; ints n, k, gh, gw, tiles_x, tiles_per_combo, n_rounds,
    # chain, s_max, has_back; stream.
    "sspt_resolve_rounds_dual": [P] * 14 + [I] * 10 + [P],
    # pointers: table, idx, out; int n_words; long long n; stream.
    "sspt_broadcast_table_select": [P] * 3 + [I, L] + [P],
    # pointers: cand, 4 fields in, 4 fields out (null past nf), count;
    # ints s, n, k, nf; stream.
    "sspt_pack_by_slot": [P] * 10 + [I] * 4 + [P],
    # pointers: ptr, 4 fields in, 4 fields out (null past nf); ints n, k,
    # chain, slot_hi, nf; stream.
    "sspt_extract_chain": [P] * 9 + [I] * 5 + [P],
    # pointers: blocks, idx, out; ints n, k; stream.
    "sspt_rowwise_select": [P] * 3 + [I] * 2 + [P],
    # pointers: ray_pos, ray_dir, view_dir, inside, dither, large_step,
    # alive, scalars, layer1, opaque (or null), back (or null), out,
    # flags; ints n, gh, gw, s_max, max_small, max_medium; floats
    # small_step, medium_step, thickness, th_inc, step_growth, texel_x,
    # texel_y; stream.
    "sspt_ray_march": [P] * 13 + [I] * 6 + [F] * 7 + [P],
    # P1's span: the lanes one block compacts and marches.
    "sspt_ray_march_span": [],
    # pointers: color, emission, normal, albedo, count, depth, t_type,
    # t_normal, t_albedo (the last three null without refraction), out;
    # ints h, w, row_offset, refr; floats max_n, inv_n; stream.
    "sspt_atrous": [P] * 10 + [I] * 4 + [F] * 2 + [P],
    # pointers: current, emission, depth, normal, smoothness, history
    # count, depth, color, emission, t_type, t_normal, t_smoothness (null
    # without refraction), motion (or null), cams, color out, count out;
    # ints h, w, refr, bf16; floats max_n, intensity, spread, proj_eps,
    # max_dist, max_tol, clamp_hi, rough_thr, curve, base_power; stream.
    "sspt_temporal": [P] * 16 + [I] * 4 + [F] * 10 + [P],
    # pointers: pix_x, pix_y, sobol, ranking, scrambling (the tables null
    # in Sobol-Owen mode), out; long long n; int mode; unsigned
    # frame_index, first; int count; stream.
    "sspt_sampler": [P] * 6 + [L, I, U, U, I] + [P],
    # pointers: the field descriptors (16 x data, row, column and
    # component strides, long long), out; ints rows, cols, refr, disney;
    # stream.
    "sspt_brdf": [P] * 2 + [I] * 4 + [P],
}


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


def _library_path() -> Path:
    """The library's path, keyed on the flags, the sources and the
    headers they share (``csrc/*.cuh``)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsspt_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.
    Raises RuntimeError when nvcc is missing or the build fails."""
    so = _library_path()
    if not so.exists():
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the "
                "CUDA kernels cannot be built"
            )
        so.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        objs = [so.parent / f"{tag}.{src.stem}.o" for src in sorted(SRC_DIR.glob("*.cu"))]
        try:
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for obj, src in zip(objs, sorted(SRC_DIR.glob("*.cu")))]
            done = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
            failed = [(src, rc, out) for src, out, rc in done if rc != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"{src} ({rc}):\n{out}" for src, rc, out in failed))
            so.with_suffix(".ptxas.txt").write_text(
                "".join(f"// {src}\n{out}" for src, out, _ in done))
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                                   f"{link.stdout}\n{link.stderr}")
            os.replace(tmp, so)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _kernel_name(mangled: str) -> str:
    """``_ZN<len>_GLOBAL__N__..<len>schedule_pack_kernelILb1EEEv...`` ->
    ``schedule_pack_kernel<1>``: the innermost name and its bool or int
    template arguments (``pack_by_slot_kernelILi3EEEv...`` ->
    ``pack_by_slot_kernel<3>``)."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while m := re.match(r"\d+", mangled[i:]):
        n = int(m.group())
        name = mangled[i + m.end():i + m.end() + n]
        i += m.end() + n
    if args := re.match(r"I((?:L[bi]\d+E)+)E", mangled[i:]):
        name += "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1))) + ">"
    return name


def parse_ptxas(report: str) -> list[dict]:
    """Per kernel of an ``-Xptxas -v`` report: registers a thread, static
    shared bytes a block, spill store / load bytes and stack frame bytes
    a thread."""
    rows, cur = [], None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = dict(kernel=_kernel_name(m.group(1)), regs=0, smem=0, spill_stores=0,
                       spill_loads=0, stack=0)
            rows.append(cur)
        elif cur is not None and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["regs"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                cur["smem"] = int(sm.group(1))
    return rows


def resource_usage() -> list[dict]:
    """``parse_ptxas`` of the built library's report."""
    load_library()
    return parse_ptxas(_library_path().with_suffix(".ptxas.txt").read_text())


def sass_text(so) -> str | None:
    """``cuobjdump -sass`` of the library ``so``; None where cuobjdump is
    missing."""
    nvcc = nvcc_path()
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.exists():
        return None
    return subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True).stdout


def _sass_functions(listing: str) -> list:
    """[(mangled name, [(address, predicate, instruction)], {label:
    address})] of each function in ``cuobjdump -sass`` text."""
    funcs, pending = [], []
    for line in listing.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            funcs.append((m.group(1), [], {}))
            pending = []
        elif not funcs:
            continue
        elif m := re.match(r"\s*(\.L_x_\d+):", line):
            pending.append(m.group(1))
        elif m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?(.*?)\s*;", line):
            at = int(m.group(1), 16)
            for label in pending:
                funcs[-1][2][label] = at
            pending = []
            funcs[-1][1].append((at, (m.group(2) or "").strip(), m.group(3)))
    return funcs


def _opcode(text: str) -> str:
    return text.split()[0].split(".")[0]


def _branch_target(text: str, labels: dict):
    """The address a BRA jumps to, or None for any other instruction."""
    if b := re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", text):
        return labels.get(b.group(1)) if b.group(1) else int(b.group(2), 16)
    return None


def sass_loops(so) -> dict:
    """{kernel: {"instructions": all of its SASS, "loops": the SASS
    instructions of each loop, fewest first, "inner_loops": those of the
    loops with no warp vote, shuffle, atomic or global store in them}}
    from ``cuobjdump
    -sass`` of the library ``so``: a loop is a backward branch and the
    code it jumps back over. Empty where cuobjdump is missing."""
    listing = sass_text(so)
    loops = {}
    for name, instrs, labels in _sass_functions(listing or ""):
        addrs = [a for a, _, _ in instrs]
        warp_ops = {a for a, _, text in instrs
                    if re.search(r"\b(VOTE|SHFL|ATOMG?|RED|STG)\b", text)}
        spans, lane = [], []
        for at, _, text in instrs:
            dest = _branch_target(text, labels)
            if dest is not None and dest <= at:
                span = [a for a in addrs if dest <= a <= at]
                spans.append(len(span))
                if not warp_ops.intersection(span):
                    lane.append(len(span))
        loops[_kernel_name(name)] = dict(instructions=len(addrs), loops=sorted(spans),
                                         inner_loops=sorted(lane))
    return loops


def library_sass_loops() -> dict:
    """``sass_loops`` of the built library."""
    load_library()
    return sass_loops(_library_path())


# SASS opcodes by the sm_90 pipe that executes them, and its lanes an SM
# a clock (the CUDA C++ Programming Guide's throughput table for compute
# capability 9.0): integer add, compare, shift, logic and select on the
# ALU pipe (64); integer multiply-add on the heavy half of the FMA pipe
# (64); f32 add and multiply on either half (128 with the integer
# multiply-adds); bit reversal, bit counts, conversions and special
# functions (16). Every other instruction (moves, memory, control,
# uniform-datapath) is counted only where it takes an issue slot: four
# schedulers of 32 lanes an SM a clock.
SASS_PIPES = {
    "alu": ({"LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "ISETP", "LEA", "SEL", "FSEL",
             "FSETP", "FMNMX", "IMNMX", "PRMT", "PLOP3", "IABS", "SGXT", "BMSK"}, 64),
    "imad": ({"IMAD", "IMUL", "IDP"}, 64),
    "fp32": ({"FADD", "FMUL", "FFMA"}, 128),
    "xu": ({"BREV", "POPC", "FLO", "I2F", "F2I", "F2F", "FRND", "MUFU"}, 16),
}
SASS_ISSUE_LANES = 128


def sass_must_run(listing: str) -> dict:
    """{kernel: {"static": its SASS instructions, "must_run": {pipe:
    count, "issue": count}}} from ``cuobjdump -sass`` text: the
    instructions of the basic blocks that dominate the block of the
    kernel's last global store, which every thread that stores executes
    whatever the arguments (a predicated instruction issues all the
    same). Code a branch can skip is left out, so the counts are a lower
    bound on what a storing thread executes."""
    kernels = {}
    for name, instrs, labels in _sass_functions(listing):
        index = {a: i for i, (a, _, _) in enumerate(instrs)}
        ends = ("BRA", "EXIT", "RET")
        leaders = {0}
        for i, (_, _, text) in enumerate(instrs):
            if _opcode(text) in ends:
                leaders.add(i + 1)
            if (t := index.get(_branch_target(text, labels))) is not None:
                leaders.add(t)
        starts = sorted(x for x in leaders if x < len(instrs))
        bounds = list(zip(starts, starts[1:] + [len(instrs)]))
        block_of = {i: b for b, (lo, hi) in enumerate(bounds) for i in range(lo, hi)}
        succ = {b: set() for b in range(len(bounds))}
        for b, (_, hi) in enumerate(bounds):
            _, pred, text = instrs[hi - 1]
            if (t := index.get(_branch_target(text, labels))) is not None:
                succ[b].add(block_of[t])
            if (pred or _opcode(text) not in ends) and hi < len(instrs):
                succ[b].add(block_of[hi])
        stores = [i for i, (_, _, text) in enumerate(instrs) if _opcode(text) == "STG"]
        if not stores:
            continue
        preds = {b: [a for a in succ if b in succ[a]] for b in succ}
        dom = {b: ({0} if b == 0 else set(succ)) for b in succ}
        changed = True
        while changed:
            changed = False
            for b in list(succ)[1:]:
                new = {b} | (set.intersection(*(dom[p] for p in preds[b])) if preds[b] else set())
                if new != dom[b]:
                    dom[b], changed = new, True
        mix = collections.Counter()
        for i, (_, _, text) in enumerate(instrs):
            if block_of[i] in dom[block_of[stores[-1]]]:
                mix["issue"] += 1
                mix.update(pipe for pipe, (ops, _) in SASS_PIPES.items() if _opcode(text) in ops)
        kernels[_kernel_name(name)] = dict(static=len(instrs), must_run=dict(mix))
    return kernels


def sass_lane_clocks(mix: dict) -> tuple[float, str]:
    """The least SM clocks a lane of the instruction ``mix`` takes
    (``sass_must_run``'s counts), and the pipe or issue limit that sets
    it: each pipe's instructions over its lanes a clock, the two FMA
    halves' together, and every instruction over the issue slots."""
    limits = {pipe: mix.get(pipe, 0) / lanes for pipe, (_, lanes) in SASS_PIPES.items()}
    limits["fma"] = (mix.get("imad", 0) + mix.get("fp32", 0)) / SASS_PIPES["fp32"][1]
    limits["issue"] = mix.get("issue", 0) / SASS_ISSUE_LANES
    pipe = max(limits, key=limits.get)
    return limits[pipe], pipe


def library_sass_must_run() -> dict:
    """``sass_must_run`` of the built library; empty without cuobjdump."""
    load_library()
    return sass_must_run(sass_text(_library_path()) or "")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require_cuda(name: str, *tensors) -> None:
    """The kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise RuntimeError(f"{name}: needs CUDA tensors on one device, got {t.device}")
        if not t.is_contiguous():
            raise RuntimeError(f"{name}: needs contiguous tensors")


def flag_bytes(t):
    """A contiguous uint8 tensor of the flags ``t``: a bool tensor's own
    bytes (a view, no copy; torch stores bool as 0 / 1 bytes), any other
    dtype converted."""
    import torch

    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t.to(torch.uint8)


def stream_of(tensor):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)
