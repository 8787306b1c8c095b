"""The hiz front half: march schedule + minitile filter + candidate pack.

``schedule_pack`` is the wrapper of kernel K1 (``csrc/schedule_pack.cu``),
the counterpart of ``unitysspathtracingurp_tpu.ops.fused_schedule.
fused_schedule_pack`` in its plain-layout mode; ``schedule_pack_dual``
wraps kernel K4, the same source's dual mode (``DualDepthTiles``: the
refraction / backface variants). ``schedule_pack_ref`` and
``schedule_pack_dual_ref`` are their plain PyTorch versions: the torch
port of the JAX package's unfused phases 1-3
(``ops/pathtrace_hiz.py:293-464``), streamed step by step instead of
stacked over (S, N).

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


def _q40(x, mx):
    return torch.clamp(torch.round(x * 40.0), 0.0, mx)


def _project(m, x, y, z):
    """world -> (u, v, raw) from the 16 row-major view_proj entries."""
    clipx = x * m[0] + y * m[1] + z * m[2] + m[3]
    clipy = x * m[4] + y * m[5] + z * m[6] + m[7]
    clipz = x * m[8] + y * m[9] + z * m[10] + m[11]
    w = x * m[12] + y * m[13] + z * m[14] + m[15]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return clipx / w * 0.5 + 0.5, clipy / w * 0.5 + 0.5, clipz / w


def pixel_index(t, size: int):
    return torch.clamp(torch.floor(t * size).to(torch.int64), 0, size - 1)


def _pack_plain(ray_pos, ray_dir, dither, large_step, alive, is_back, mini_table,
                scalars, dual, *, gh, gw, minis_x, s_max, k, max_small_step,
                max_medium_step, small_step_size, medium_step_size,
                marching_thickness, step_growth, thickness_growth):
    """The plain versions of K1 (``dual`` None) and K4 (``dual`` =
    (combo, search, bmax_table, chunks_per_combo)), lanes on the leading
    axis, N lanes."""
    n = ray_pos.shape[0]
    dev = ray_pos.device
    m = [scalars[i] for i in range(16)]
    zz, zw = scalars[16], scalars[17]
    texel_x, texel_y = f32(1.0 / gw), f32(1.0 / gh)
    th_cap = thickness_cap(marching_thickness, thickness_growth, s_max)
    th_inc = f32(marching_thickness * thickness_growth)
    mini_words = mini_table.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    if dual is not None:
        combo, search, bmax_table, chunks_per_combo = dual
        combo_off = combo.to(torch.int64) * (chunks_per_combo * 128)
        bmax_words = bmax_table.reshape(-1).to(torch.int64) & 0xFFFFFFFF

    px, py, pz = ray_pos[:, 0], ray_pos[:, 1], ray_pos[:, 2]
    dx, dy, dz = ray_dir[:, 0], ray_dir[:, 1], ray_dir[:, 2]
    last_u, last_v, _ = _project(m, px, py, pz)
    step = torch.full((n,), f32(small_step_size), dtype=torch.float32, device=dev)
    th = torch.full((n,), f32(marching_thickness), dtype=torch.float32, device=dev)
    cum = torch.zeros(n, dtype=torch.float32, device=dev)
    lcum = torch.zeros_like(cum)
    lhd = torch.zeros_like(cum)
    pidx = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    run = torch.zeros(n, dtype=torch.int64, device=dev)
    marching = alive.clone()
    lane = torch.arange(n, device=dev)
    # Slot j of lane n lives at flat j*n + n; one spare word takes the
    # writes of non-packing lanes.
    n_fields = 3 if dual is None else 4
    outs = [torch.zeros(k * n + 1, dtype=torch.float32, device=dev) for _ in range(n_fields)]

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
        u, v, raw = _project(m, px, py, pz)
        if i <= max_medium_step:
            skip = (torch.abs(u - last_u) < texel_x) & (torch.abs(v - last_v) < texel_y)
        else:
            skip = torch.zeros_like(marching)
        in_screen = (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
        exit_now = marching & ~skip & ~in_screen
        proc = marching & ~skip & in_screen

        ix = pixel_index(u, gw)
        iy = pixel_index(v, gh)
        hitd = 1.0 / (raw * zz + zw)
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
            margin = torch.maximum(th, step)
            cand = proc & (hitd >= mmin) & (
                (hitd - margin <= umax) | search | (hitd <= bmax))

        scode = float(i - 1) + 65.0 * (pidx + 1.0) + _q40(th, th_cap) * 8192.0
        hist = _q40(lcum, 4095.0) * 4096.0 + _q40(lhd, 4095.0)
        vals = (cum, scode, hist) if dual is None else (cum, scode, hist, _q40(step, 4095.0))
        pack = cand & (run < k)
        dst = torch.where(pack, run * n + lane, torch.full_like(lane, k * n))
        for out, val in zip(outs, vals):
            out.scatter_(0, dst, val)
        run = run + cand.to(torch.int64)

        step = torch.where(proc, step + step * f32(step_growth), step)
        th = torch.where(proc, th + th_inc, th)
        last_u = torch.where(proc, u, last_u)
        last_v = torch.where(proc, v, last_v)
        lcum = torch.where(proc, cum, lcum)
        lhd = torch.where(proc, hitd, lhd)
        pidx = torch.where(proc, torch.full_like(pidx, float(i - 1)), pidx)
        marching = marching & ~exit_now

    pk = [o[: k * n].reshape(k, n) for o in outs]
    return (*pk, torch.clamp(run, max=k).to(torch.int32))


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
    kernel, or an exception; there is no fallback."""
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
    if mini_table.numel() * 4 > 227 * 1024:
        raise RuntimeError("schedule_pack: minitile table exceeds shared memory")
    dev = ray_pos.device
    pk_cum = torch.empty((k, n), dtype=torch.float32, device=dev)
    pk_scode = torch.empty_like(pk_cum)
    pk_hist = torch.empty_like(pk_cum)
    n_cand = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.sspt_schedule_pack(
        *[t.data_ptr() for t in ins],
        pk_cum.data_ptr(), pk_scode.data_ptr(), pk_hist.data_ptr(), n_cand.data_ptr(),
        n, params["gh"], params["gw"], params["minis_x"], mini_table.numel(),
        *_march_params(params), stream_of(pk_cum),
    )
    check(rc, "schedule_pack")
    LAUNCHES["schedule_pack"] += 1
    return pk_cum, pk_scode, pk_hist, n_cand


def schedule_pack_dual(ray_pos, ray_dir, dither, large_step, alive, combo, search,
                       mini_table, bmax_table, scalars, *, chunks_per_combo, **params):
    """K4 wrapper. CPU tensors: ``schedule_pack_dual_ref``. CUDA tensors:
    the kernel, or an exception; there is no fallback."""
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
    dev = ray_pos.device
    pk = [torch.empty((k, n), dtype=torch.float32, device=dev) for _ in range(4)]
    n_cand = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.sspt_schedule_pack_dual(
        *[t.data_ptr() for t in ins], *[t.data_ptr() for t in pk], n_cand.data_ptr(),
        n, params["gh"], params["gw"], params["minis_x"], mini_table.numel(), combo_words,
        *_march_params(params), stream_of(n_cand),
    )
    check(rc, "schedule_pack_dual")
    LAUNCHES["schedule_pack_dual"] += 1
    return (*pk, n_cand)
