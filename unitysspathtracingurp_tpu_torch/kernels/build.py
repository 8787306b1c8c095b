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

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
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
