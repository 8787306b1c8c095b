"""The hiz front half: march schedule + minitile filter + candidate pack.

``schedule_pack`` is the wrapper of kernel K1 (``csrc/schedule_pack.cu``),
the counterpart of ``unitysspathtracingurp_tpu.ops.fused_schedule.
fused_schedule_pack`` in its plain-layout mode; ``schedule_pack_dual``
wraps kernel K4, the same source's dual mode (``DualDepthTiles``: the
refraction / backface variants). ``schedule_pack_ref`` and
``schedule_pack_dual_ref`` are their plain PyTorch versions: the torch
port of the JAX package's unfused phases 1-3
(``ops/pathtrace_hiz.py:293-464``), streamed step by step instead of
stacked over (S, N). ``schedule_pack_home`` wraps kernel K6, the home
mode (the home-prefix resolve on bounce 0 of a screen-ordered frame);
``schedule_pack_home_ref`` is its plain version.

Outputs, per lane n and slot j < K: ``pk_cum[j, n]`` (march distance),
``pk_scode[j, n]`` = step + 65*(prev_step + 1) + 8192*q40(thickness),
``pk_hist[j, n]`` = 4096*q40(last_cumdist) + q40(last_hitdepth), zero
past the lane's count; ``n_cand[n]`` the count clamped to K. q40 is
round-half-even to 2.5 cm. The dual mode adds ``pk_step[j, n]`` =
q40(step), the step size the backed hit window needs (hlsl:181).

The wrapper picks by device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..camera import depth_coeffs
from .depth_tiles import f16_from_bits, mini_of


# Home-prefix geometry (kernel K6): per 8x128-px lane block, the pair
# rows of 3 bands x 6 pair windows centred on it; the prefix exact-tests
# at most HOME_SLOTS leading in-strip candidates per lane.
HOME_BANDS = 3
HOME_PAIRS = 6
HOME_SLOTS = 4


# The shared-memory budget of K1 / K4 / K6 on one H100 SM: its capacity,
# the most one block may take (dynamic, above 48 KB only after
# cudaFuncSetAttribute, which the C entry points call), and what the
# runtime reserves per resident block. The kernels are built with
# __launch_bounds__(512, 2), at most 64 registers a thread, so registers
# hold 1,024 threads an SM; shared memory decides how many are resident.
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
SMEM_RESERVED = 1024
THREADS_PER_SM = 1024
PACK_BLOCKS = (128, 256, 512)


def pack_budget(table_words: int, k: int, n_fields: int,
                threads: int | None = None) -> tuple[int, int]:
    """(threads a block, dynamic shared bytes a block) of a K1 / K4 / K6
    launch. A block holds ``table_words`` 32-bit table words, then its
    slot staging: ``n_fields`` x ``k`` x threads f32. With ``threads``
    None, the size in ``PACK_BLOCKS`` that keeps the most threads
    resident on an SM, the smaller on a tie. Raises when the block cannot
    fit: there is no other path."""
    best = None
    for t in (PACK_BLOCKS if threads is None else (threads,)):
        smem = (table_words + n_fields * k * t) * 4
        if smem > SMEM_PER_BLOCK:
            continue
        resident = min(SMEM_PER_SM // (smem + SMEM_RESERVED), THREADS_PER_SM // t) * t
        if best is None or resident > best[0]:
            best = (resident, t, smem)
    if best is None:
        raise RuntimeError(
            f"schedule_pack: {table_words} table words + {n_fields} x {k} staged slots a "
            f"thread exceed the {SMEM_PER_BLOCK} B of shared memory a block may use")
    return best[1], best[2]


def f32(x: float) -> float:
    """``x`` rounded to f32, as JAX converts a weak-typed Python float."""
    return float(np.float32(x))


def schedule_scalars(cam) -> torch.Tensor:
    """(18,) f32: view_proj row-major + the linear-eye-depth coefficients."""
    zz, zw = depth_coeffs(cam.near, cam.far)
    return torch.cat([
        cam.view_proj.reshape(16).to(torch.float32),
        torch.stack([zz, zw]).to(torch.float32),
    ]).contiguous()


def march_kwargs(cfg, tiles, s_max: int) -> dict:
    """The keyword arguments K1 and K4 (and their plain versions) take
    from a ``PTConfig`` and the depth tiles, for ``s_max`` steps."""
    return dict(
        gh=tiles.height, gw=tiles.width, minis_x=tiles.minis_x, s_max=s_max,
        k=min(16, s_max), max_small_step=cfg.max_small_step,
        max_medium_step=cfg.max_medium_step, small_step_size=cfg.small_step_size,
        medium_step_size=cfg.medium_step_size, marching_thickness=cfg.marching_thickness,
        step_growth=cfg.step_growth, thickness_growth=cfg.thickness_growth,
    )


def thickness_cap(marching_thickness: float, thickness_growth: float, s_max: int) -> float:
    return float(math.ceil(40.0 * marching_thickness * (1.0 + thickness_growth * s_max)))


def q40(x, mx):
    return torch.clamp(torch.round(x * 40.0), 0.0, mx)


def project(m, x, y, z):
    """world -> (u, v, raw) from the 16 row-major view_proj entries."""
    clipx = x * m[0] + y * m[1] + z * m[2] + m[3]
    clipy = x * m[4] + y * m[5] + z * m[6] + m[7]
    clipz = x * m[8] + y * m[9] + z * m[10] + m[11]
    w = x * m[12] + y * m[13] + z * m[14] + m[15]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return clipx / w * 0.5 + 0.5, clipy / w * 0.5 + 0.5, clipz / w


def pixel_index(t, size: int):
    return torch.clamp(torch.floor(t * size).to(torch.int64), 0, size - 1)


def march_steps(ray_pos, ray_dir, dither, large_step, alive, scalars, *, gh, gw, s_max,
                max_small_step, max_medium_step, small_step_size, medium_step_size,
                marching_thickness, step_growth, thickness_growth, **_):
    """The march schedule of phase 1 (``pathtrace_hiz.py:293-360``), lanes
    on the leading axis: yields, for each step i = 1..s_max, the values
    the candidate filter and the pack read (position iterative, before
    the step's post-test update). K1 / K4 / K6's plain versions stream
    them; the diagnostic march stacks them over (S, N)."""
    n = ray_pos.shape[0]
    dev = ray_pos.device
    m = [scalars[i] for i in range(16)]
    zz, zw = scalars[16], scalars[17]
    texel_x, texel_y = f32(1.0 / gw), f32(1.0 / gh)
    th_inc = f32(marching_thickness * thickness_growth)
    px, py, pz = ray_pos[:, 0], ray_pos[:, 1], ray_pos[:, 2]
    dx, dy, dz = ray_dir[:, 0], ray_dir[:, 1], ray_dir[:, 2]
    last_u, last_v, _ = project(m, px, py, pz)
    step = torch.full((n,), f32(small_step_size), dtype=torch.float32, device=dev)
    th = torch.full((n,), f32(marching_thickness), dtype=torch.float32, device=dev)
    cum = torch.zeros(n, dtype=torch.float32, device=dev)
    lcum = torch.zeros_like(cum)
    lhd = torch.zeros_like(cum)
    pidx = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    marching = alive.clone()
    for i in range(1, s_max + 1):
        if i == max_small_step + 1:
            step = torch.full_like(step, f32(medium_step_size))
            th = torch.full_like(th, f32(marching_thickness))
        if i == max_medium_step + 1:
            step = large_step.clone()
            th = torch.full_like(th, f32(marching_thickness))
        adv = step + step * dither
        cum = cum + adv
        px = px + adv * dx
        py = py + adv * dy
        pz = pz + adv * dz
        u, v, raw = project(m, px, py, pz)
        if i <= max_medium_step:
            skip = (torch.abs(u - last_u) < texel_x) & (torch.abs(v - last_v) < texel_y)
        else:
            skip = torch.zeros_like(marching)
        in_screen = (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
        exit_now = marching & ~skip & ~in_screen
        proc = marching & ~skip & in_screen
        hitd = 1.0 / (raw * zz + zw)
        yield dict(i=i, cum=cum, th=th, step=step, lcum=lcum, lhd=lhd, pidx=pidx, proc=proc,
                   ix=pixel_index(u, gw), iy=pixel_index(v, gh), hitd=hitd)

        step = torch.where(proc, step + step * f32(step_growth), step)
        th = torch.where(proc, th + th_inc, th)
        last_u = torch.where(proc, u, last_u)
        last_v = torch.where(proc, v, last_v)
        lcum = torch.where(proc, cum, lcum)
        lhd = torch.where(proc, hitd, lhd)
        pidx = torch.where(proc, torch.full_like(pidx, float(i - 1)), pidx)
        marching = marching & ~exit_now


def _pack_plain(ray_pos, ray_dir, dither, large_step, alive, is_back, mini_table,
                scalars, dual, home=None, **params):
    """The plain versions of K1 (``dual`` and ``home`` None), K4 (``dual``
    = (combo, search, bmax_table, chunks_per_combo)) and K6 (``home`` =
    (strips, h, w), lanes the screen-ordered (h, w) grid), N lanes."""
    n = ray_pos.shape[0]
    dev = ray_pos.device
    k, minis_x = params["k"], params["minis_x"]
    th_cap = thickness_cap(params["marching_thickness"], params["thickness_growth"],
                           params["s_max"])
    mini_words = mini_table.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    if dual is not None:
        combo, search, bmax_table, chunks_per_combo = dual
        combo_off = combo.to(torch.int64) * (chunks_per_combo * 128)
        bmax_words = bmax_table.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    run = torch.zeros(n, dtype=torch.int64, device=dev)
    lane = torch.arange(n, device=dev)
    # Slot j of lane n lives at flat j*n + n; one spare word takes the
    # writes of non-packing lanes.
    n_fields = 3 if dual is None else 4
    outs = [torch.zeros(k * n + 1, dtype=torch.float32, device=dev) for _ in range(n_fields)]
    if home is not None:
        hp = min(HOME_SLOTS, k)
        hw = home[2]
        y0 = (lane // hw) // 8 * 8
        x0 = (lane % hw) // 128 * 128
        prefix = torch.ones(n, dtype=torch.bool, device=dev)
        run_home = torch.zeros_like(run)
        # The routed candidates' (cum, th, lcum, lhd, pidx, step index),
        # slot j of lane n at j*n + n, as the pack's.
        slots = [torch.zeros(hp * n + 1, dtype=torch.float32, device=dev) for _ in range(6)]

    for st in march_steps(ray_pos, ray_dir, dither, large_step, alive, scalars, **params):
        i, th, lcum, lhd, pidx = st["i"], st["th"], st["lcum"], st["lhd"], st["pidx"]
        ix, iy, hitd, proc = st["ix"], st["iy"], st["hitd"], st["proc"]
        mini = mini_of(ix, iy, minis_x)
        if dual is None:
            word = mini_words[mini]
            mmin = f16_from_bits(word & 0xFFFF)
            mmax = f16_from_bits(word >> 16)
            cand = proc & (hitd >= mmin) & ((hitd - th <= mmax) | is_back)
        else:
            # Conservative dual rule (pathtrace_hiz.py:398-404): the backed
            # window's margin is max(th, step); search lanes and front
            # rays below the minitile's max back depth escape the window.
            mini = mini + combo_off
            word = mini_words[mini]
            mmin = f16_from_bits(word & 0xFFFF)
            umax = f16_from_bits(word >> 16)
            bmax = f16_from_bits(bmax_words[mini] & 0xFFFF)
            margin = torch.maximum(th, st["step"])
            cand = proc & (hitd >= mmin) & (
                (hitd - margin <= umax) | search | (hitd <= bmax))
        if home is not None:
            # Prefix routing (fused_schedule.py:392-422): the leading
            # candidates whose iterative pixel lies in the lane block's
            # strip shrunk by one pixel go to the home slots; the first
            # candidate not routed ends the prefix.
            route = (cand & prefix & (run_home < hp) & (iy >= y0 - 7) & (iy <= y0 + 14)
                     & (ix >= x0 - 31) & (ix <= x0 + 158))
            cand = cand & ~route
            prefix = prefix & ~cand
            dst = torch.where(route, run_home * n + lane, torch.full_like(lane, hp * n))
            sidx = torch.full_like(th, float(i - 1))
            for buf, val in zip(slots, (st["cum"], th, lcum, lhd, pidx, sidx)):
                buf.scatter_(0, dst, val)
            run_home = run_home + route.to(torch.int64)

        scode = float(i - 1) + 65.0 * (pidx + 1.0) + q40(th, th_cap) * 8192.0
        hist = q40(lcum, 4095.0) * 4096.0 + q40(lhd, 4095.0)
        vals = (st["cum"], scode, hist)
        if dual is not None:
            vals = vals + (q40(st["step"], 4095.0),)
        pack = cand & (run < k)
        dst = torch.where(pack, run * n + lane, torch.full_like(lane, k * n))
        for out, val in zip(outs, vals):
            out.scatter_(0, dst, val)
        run = run + cand.to(torch.int64)

    pk = [o[: k * n].reshape(k, n) for o in outs]
    n_cand = torch.clamp(run, max=k).to(torch.int32)
    if home is None:
        return (*pk, n_cand)
    hit, state = _home_tests([b[: hp * n].reshape(hp, n) for b in slots], run_home, ray_pos,
                             ray_dir, is_back, scalars, home, th_cap, params)
    return (*pk, torch.where(hit, torch.zeros_like(n_cand), n_cand), state)


def _home_tests(slots, run_home, ray_pos, ray_dir, is_back, scalars, home, th_cap, params):
    """K6's post-loop prefix tests (fused_schedule.py:447-539): the home
    slots in slot order under R1's plain hit rule, on the position
    re-derived as origin + cum * dir, the quantized metadata and the
    strip's f16 raw depth (widened exactly). Returns the prefix-hit mask
    and the (11, N) resolve-state init (``pathtrace_hiz.RESOLVE_FIELDS``)."""
    strips, _, hw = home
    hs_cum, hs_th, hs_lcum, hs_lhd, hs_pidx, hs_sidx = slots
    n = ray_pos.shape[0]
    gh, gw, s_max = params["gh"], params["gw"], params["s_max"]
    m = [scalars[i] for i in range(16)]
    zz, zw = scalars[16], scalars[17]
    lane = torch.arange(n, device=ray_pos.device)
    by, bx = (lane // hw) // 8, (lane % hw) // 128
    nbx = hw // 128
    words = strips.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    z = torch.zeros(n, dtype=torch.float32, device=ray_pos.device)
    hit = torch.zeros(n, dtype=torch.bool, device=ray_pos.device)
    h = dict(cum=z, diff=z, th=z, hitd=z, lcum=z, lhd=z, pidx=z, ixy=z)
    pdiff, psidx = z, torch.full_like(z, -1.0)
    for j in range(hs_cum.shape[0]):
        cum = hs_cum[j]
        th_q = q40(hs_th[j], th_cap) * 0.025
        u, v, raw = project(m, ray_pos[:, 0] + cum * ray_dir[:, 0],
                             ray_pos[:, 1] + cum * ray_dir[:, 1],
                             ray_pos[:, 2] + cum * ray_dir[:, 2])
        hitd = 1.0 / (raw * zz + zw)
        ix, iy = pixel_index(u, gw), pixel_index(v, gh)
        srow = torch.clamp(((iy >> 3) - (by - 1)) * HOME_PAIRS + ((ix >> 5) - (bx * 4 - 1)),
                           0, HOME_BANDS * HOME_PAIRS - 1)
        texel = ((iy & 7) << 4) | (ix & 15)
        word = words[((by * nbx + bx) * (HOME_BANDS * HOME_PAIRS) + srow) * 128 + texel]
        bits16 = torch.where(((ix >> 4) & 1) == 1, word >> 16, word & 0xFFFF)
        dd = 1.0 / (f16_from_bits(bits16) * zz + zw) - hitd
        halv = torch.ceil(torch.log2(torch.clamp(-dd / torch.clamp(th_q, min=1e-6), min=1.0)))
        budget_ok = hs_sidx[j] + 1.0 + halv <= float(s_max)
        ok = (run_home > j) & ~hit
        hit_j = ok & (dd <= 0.0) & (bits16 != 0) & ((dd >= -th_q) | (is_back & budget_ok))
        fail_j = ok & ~hit_j
        hit = hit | hit_j
        for key, val in (("cum", cum), ("diff", dd), ("th", th_q), ("hitd", hitd),
                         ("lcum", q40(hs_lcum[j], 4095.0) * 0.025),
                         ("lhd", q40(hs_lhd[j], 4095.0) * 0.025), ("pidx", hs_pidx[j]),
                         ("ixy", (iy * gw + ix).to(torch.float32))):
            h[key] = torch.where(hit_j, val, h[key])
        pdiff = torch.where(fail_j, dd, pdiff)
        psidx = torch.where(fail_j, hs_sidx[j], psidx)
    state = torch.stack([hit.to(torch.float32), h["cum"], h["diff"], h["th"], h["hitd"],
                         h["lcum"], h["lhd"], h["pidx"], h["ixy"], pdiff, psidx])
    return hit, state


def schedule_pack_ref(ray_pos, ray_dir, dither, large_step, alive, is_back,
                      mini_table, scalars, **params):
    """Plain PyTorch version of K1: (pk_cum, pk_scode, pk_hist, n_cand)."""
    return _pack_plain(ray_pos, ray_dir, dither, large_step, alive, is_back,
                       mini_table, scalars, None, **params)


def schedule_pack_dual_ref(ray_pos, ray_dir, dither, large_step, alive, combo, search,
                           mini_table, bmax_table, scalars, *, chunks_per_combo,
                           **params):
    """Plain PyTorch version of K4: (pk_cum, pk_scode, pk_hist, pk_step,
    n_cand). ``combo`` (N,) int picks each lane's table rows, ``search``
    (N,) bool marks the lanes that may run the binary search."""
    return _pack_plain(ray_pos, ray_dir, dither, large_step, alive, None, mini_table,
                       scalars, (combo, search, bmax_table, chunks_per_combo), **params)


def schedule_pack_home_ref(ray_pos, ray_dir, dither, large_step, alive, is_back,
                           mini_table, home_strips, scalars, *, home_shape, **params):
    """Plain PyTorch version of K6, the home mode (the torch port of
    ``fused_schedule.py:283-550``): (pk_cum, pk_scode, pk_hist, n_cand,
    home_out). Lanes are the screen-ordered ``home_shape`` = (h, w) grid,
    h % 8 == 0 and w % 128 == 0; ``home_strips`` is ``build_home_strips``'
    (h/8, w/128, 18, 128). ``home_out`` is the (11, N) resolve-state init
    (``pathtrace_hiz.RESOLVE_FIELDS``); n_cand is 0 where the prefix hit."""
    _check_home_shape(ray_pos, home_strips, home_shape)
    return _pack_plain(ray_pos, ray_dir, dither, large_step, alive, is_back, mini_table,
                       scalars, None, (home_strips, *home_shape), **params)


def _check_home_shape(ray_pos, home_strips, home_shape):
    h, w = home_shape
    if h % 8 or w % 128 or h * w != ray_pos.shape[0]:
        raise ValueError(f"home mode: lanes must be the screen-ordered grid with h % 8 == 0 "
                         f"and w % 128 == 0, got {home_shape} for {ray_pos.shape[0]} lanes")
    if tuple(home_strips.shape) != (h // 8, w // 128, HOME_BANDS * HOME_PAIRS, 128):
        raise ValueError(f"home mode: strips of shape {tuple(home_strips.shape)} for {home_shape}")


def _march_params(p):
    """The scalar march parameters every schedule kernel entry takes,
    f32-rounded as JAX rounds weak-typed Python floats."""
    return (
        p["s_max"], p["k"], p["max_small_step"], p["max_medium_step"],
        f32(p["small_step_size"]), f32(p["medium_step_size"]),
        f32(p["marching_thickness"]),
        f32(p["marching_thickness"] * p["thickness_growth"]),
        f32(p["step_growth"]),
        thickness_cap(p["marching_thickness"], p["thickness_growth"], p["s_max"]),
        f32(1.0 / p["gw"]), f32(1.0 / p["gh"]),
    )


def schedule_pack(ray_pos, ray_dir, dither, large_step, alive, is_back,
                  mini_table, scalars, **params):
    """K1 wrapper. CPU tensors: ``schedule_pack_ref``. CUDA tensors: the
    kernel, or an exception; there is no fallback. The kernel reads the
    camera scalars from the library's one constant copy, which each K1,
    K4 and K6 launch overwrites: launch them from one stream at a time."""
    if ray_pos.device.type == "cpu":
        return schedule_pack_ref(ray_pos, ray_dir, dither, large_step, alive,
                                 is_back, mini_table, scalars, **params)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    n, k = ray_pos.shape[0], params["k"]
    ins = [
        ray_pos.to(torch.float32).contiguous(), ray_dir.to(torch.float32).contiguous(),
        dither.to(torch.float32).contiguous(), large_step.to(torch.float32).contiguous(),
        alive.to(torch.uint8).contiguous(), is_back.to(torch.uint8).contiguous(),
        mini_table.to(torch.int32).contiguous(), scalars.to(torch.float32).contiguous(),
    ]
    require_cuda("schedule_pack", *ins)
    if ins[0].shape != (n, 3) or ins[1].shape != (n, 3) or any(
        t.shape != (n,) for t in ins[2:6]
    ) or ins[7].numel() != 18:
        raise RuntimeError("schedule_pack: bad input shapes")
    threads, smem = pack_budget(mini_table.numel(), k, 3)
    dev = ray_pos.device
    pk_cum = torch.empty((k, n), dtype=torch.float32, device=dev)
    pk_scode = torch.empty_like(pk_cum)
    pk_hist = torch.empty_like(pk_cum)
    n_cand = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.sspt_schedule_pack(
        *[t.data_ptr() for t in ins],
        pk_cum.data_ptr(), pk_scode.data_ptr(), pk_hist.data_ptr(), n_cand.data_ptr(),
        n, params["gh"], params["gw"], params["minis_x"], mini_table.numel(),
        *_march_params(params), threads, smem, stream_of(pk_cum),
    )
    check(rc, "schedule_pack")
    LAUNCHES["schedule_pack"] += 1
    return pk_cum, pk_scode, pk_hist, n_cand


def schedule_pack_home(ray_pos, ray_dir, dither, large_step, alive, is_back, mini_table,
                       home_strips, scalars, *, home_shape, **params):
    """K6 wrapper. CPU tensors: ``schedule_pack_home_ref``. CUDA tensors:
    the kernel, or an exception; there is no fallback. One stream at a
    time, as ``schedule_pack``."""
    if ray_pos.device.type == "cpu":
        return schedule_pack_home_ref(ray_pos, ray_dir, dither, large_step, alive, is_back,
                                      mini_table, home_strips, scalars, home_shape=home_shape,
                                      **params)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    _check_home_shape(ray_pos, home_strips, home_shape)
    lib = load_library()
    n, k = ray_pos.shape[0], params["k"]
    ins = [
        ray_pos.to(torch.float32).contiguous(), ray_dir.to(torch.float32).contiguous(),
        dither.to(torch.float32).contiguous(), large_step.to(torch.float32).contiguous(),
        alive.to(torch.uint8).contiguous(), is_back.to(torch.uint8).contiguous(),
        mini_table.to(torch.int32).contiguous(), home_strips.to(torch.int32).contiguous(),
        scalars.to(torch.float32).contiguous(),
    ]
    require_cuda("schedule_pack_home", *ins)
    if ins[0].shape != (n, 3) or ins[1].shape != (n, 3) or any(
        t.shape != (n,) for t in ins[2:6]
    ) or ins[8].numel() != 18:
        raise RuntimeError("schedule_pack_home: bad input shapes")
    # The table and the strip; K6 stores its slots to device memory and
    # stages none.
    _, smem = pack_budget(mini_table.numel() + HOME_BANDS * HOME_PAIRS * 128, k, 0,
                          threads=128)
    dev = ray_pos.device
    pk = [torch.empty((k, n), dtype=torch.float32, device=dev) for _ in range(3)]
    n_cand = torch.empty(n, dtype=torch.int32, device=dev)
    home_out = torch.empty((11, n), dtype=torch.float32, device=dev)
    rc = lib.sspt_schedule_pack_home(
        *[t.data_ptr() for t in ins], *[t.data_ptr() for t in pk], n_cand.data_ptr(),
        home_out.data_ptr(), *home_shape, params["gh"], params["gw"], params["minis_x"],
        mini_table.numel(), *_march_params(params), smem, stream_of(n_cand),
    )
    check(rc, "schedule_pack_home")
    LAUNCHES["schedule_pack_home"] += 1
    return (*pk, n_cand, home_out)


def schedule_pack_dual(ray_pos, ray_dir, dither, large_step, alive, combo, search,
                       mini_table, bmax_table, scalars, *, chunks_per_combo, **params):
    """K4 wrapper. CPU tensors: ``schedule_pack_dual_ref``. CUDA tensors:
    the kernel, or an exception; there is no fallback. One stream at a
    time, as ``schedule_pack``."""
    if ray_pos.device.type == "cpu":
        return schedule_pack_dual_ref(
            ray_pos, ray_dir, dither, large_step, alive, combo, search, mini_table,
            bmax_table, scalars, chunks_per_combo=chunks_per_combo, **params)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    n, k = ray_pos.shape[0], params["k"]
    ins = [
        ray_pos.to(torch.float32).contiguous(), ray_dir.to(torch.float32).contiguous(),
        dither.to(torch.float32).contiguous(), large_step.to(torch.float32).contiguous(),
        alive.to(torch.uint8).contiguous(), combo.to(torch.int32).contiguous(),
        search.to(torch.uint8).contiguous(), mini_table.to(torch.int32).contiguous(),
        bmax_table.to(torch.int32).contiguous(), scalars.to(torch.float32).contiguous(),
    ]
    require_cuda("schedule_pack_dual", *ins)
    if ins[0].shape != (n, 3) or ins[1].shape != (n, 3) or any(
        t.shape != (n,) for t in ins[2:7]
    ) or ins[8].shape != ins[7].shape or ins[9].numel() != 18:
        raise RuntimeError("schedule_pack_dual: bad input shapes")
    combo_words = chunks_per_combo * 128
    if mini_table.numel() % combo_words:
        raise RuntimeError("schedule_pack_dual: table not a whole number of combos")
    threads, smem = pack_budget(0, k, 4)
    dev = ray_pos.device
    pk = [torch.empty((k, n), dtype=torch.float32, device=dev) for _ in range(4)]
    n_cand = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.sspt_schedule_pack_dual(
        *[t.data_ptr() for t in ins], *[t.data_ptr() for t in pk], n_cand.data_ptr(),
        n, params["gh"], params["gw"], params["minis_x"], mini_table.numel(), combo_words,
        *_march_params(params), threads, smem, stream_of(n_cand),
    )
    check(rc, "schedule_pack_dual")
    LAUNCHES["schedule_pack_dual"] += 1
    return (*pk, n_cand)
