#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels (csrc/*.cu, nvcc, sm_90a);
  3. K1 and R1 against their plain PyTorch versions on the card, at 256^2
     and 1920x1080, on BoxScene bounce-0 reflection rays; then K4 and
     R1's dual mode against theirs on the glass box with the refraction +
     backface tiles, with insideObject 0, 1 and 2 (every combo row); then
     K6 (the home prefix) and R1 started from K6's state, bit for bit, on
     the BoxScene rays; then K2 and K3 at the unfused front half's shapes
     (S = 24 steps x N lanes), plain and dual, bit for bit, and their
     packs against K1's and K4's; then the unfused resolve rounds
     (PTConfig.pallas_extract: K5 + row gather + K7) against R1, bit for
     bit, from the zero state, from K6's state and on the dual layout
     with insideObject 0, 1 and 2, with K5 and K7 against their plain
     versions on the inputs the unfused rounds gave them; then P1 (the
     parity march) against its plain version, bit for bit on all five
     outputs, at 256^2 and 1080p on the BoxScene rays (zero and random
     per-lane dither), on the glass box with refraction + DepthNormals
     and insideObject 0, 1 and 2, and at 256^2 in the refraction-only
     and backface-only layouts; K1, K4 and K6 with a random per-lane
     dither at 1080p, bit for bit;
  4. one whole frame of each of the headline, dual, home, parity
     headline, parity dual, spp-2 dithered headline and oct-normals +
     forward-only headline, with the kernels against the plain path; the
     home march against the non-home march at 1080p bounce 0 with 16
     rounds; the headline and dual frames with pallas_extract against
     the default frames, bit for bit;
  5. the main paths, each with the launch counts set to 0 just before
     and read just after it: Renderer.render_frame, OFFLINE, 1920x1080,
     (a) the headline BoxScene with PTConfig.boxscene_headline(), (b)
     the glass BoxScene with refraction + DepthNormals thickness, (c)
     the headline with the home prefix and hiz_home_round_cap=0.4, (d)
     the headline with pallas_extract (the unfused rounds), (e) the
     parity headline (kernel "xla": P1, 4 launches a frame), (f) the
     parity dual frame (3), and the headline at 2 samples a pixel with
     step dithering (hiz: 8 K1 and 8 R1 launches a frame); 1 warm-up +
     timed frames; each followed by a torch.profiler report of two more
     frames (a report, never a gate);
  6. a report, whose gates are the diagnostic march's launch counts,
     K3's and P1's bit identity and the golden regression: the
     diagnostic march (K2 + K3, counts set to 0 before and read after)
     through a 1080p headline frame with a torch.profiler report of two
     more, K3 on its own inputs in every bounce of that march, its
     bounce-0 locality and round counters with and without the home
     prefix, R1 on every bounce of the headline and home frames and
     R1-dual on every bounce of the dual frame (their own inputs, with
     bound, links a lane and warp efficiency), the home prefix x round
     budget A/B; P1 on its own inputs in every bounce of the parity
     headline and parity dual frames (ms, bound, steps a lane, warp
     efficiency, the warp-steps one thread a lane would issue, those P1
     issues (its blocks drop their dead lanes where that frees a warp)
     and the lane-steps over 32, and the issue-limited time of each at
     the step loop's SASS) beside K1 + R1 on the hiz frame's bounce 0;
     the 256^2 golden through P1 (512 frames, 1 bounce, pooled relative RMSE < 0.035 against
     fixtures/box256_golden_cpu.npz); the hiz-vs-parity deviation of the
     1080p headline and dual frames (128 frames each, common seeds);
then one JSON line of per-kernel numbers, the card line again, and the
last line {"ok": true, "device": {...}}.

Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time

H_FULL, W_FULL = 1080, 1920
PROBE = [0.05, 0.06, 0.08]
TIMED_FRAMES = 6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
STEP_OPS = 60  # f32 operations of one march step or one resolve link
SPIN_MIN_S = 0.02  # the least device spin ahead of a timed run
# Clock cycles a second of torch.cuda._sleep's spin: the H100 SXM's
# highest SM clock (1.98 GHz), so the spin lasts at least as long as asked.
SPIN_CYCLES_PER_S = 1.98e9
# Warp-instructions the card can issue a second: 132 SMs x 4 schedulers
# at that clock.
ISSUE_PER_S = 132 * 4 * SPIN_CYCLES_PER_S
KERNELS = {
    "schedule_pack": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/schedule_pack.cu",
        replaces="unitysspathtracingurp_tpu/ops/fused_schedule.py:639",
    ),
    "resolve_rounds": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/resolve_rounds.cu",
        replaces="unitysspathtracingurp_tpu/ops/pathtrace_hiz.py:601",
    ),
    "schedule_pack_dual": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/schedule_pack.cu",
        replaces="unitysspathtracingurp_tpu/ops/fused_schedule.py:639",
    ),
    "resolve_rounds_dual": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/resolve_rounds.cu",
        replaces="unitysspathtracingurp_tpu/ops/pathtrace_hiz.py:682",
    ),
    "schedule_pack_home": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/schedule_pack.cu",
        replaces="unitysspathtracingurp_tpu/ops/fused_schedule.py:579",
    ),
    "broadcast_table_select": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/pallas_gather.cu",
        replaces="unitysspathtracingurp_tpu/ops/pallas_gather.py:90",
    ),
    "pack_by_slot": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/pallas_gather.cu",
        replaces="unitysspathtracingurp_tpu/ops/pallas_gather.py:188",
    ),
    "extract_chain": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/pallas_gather.cu",
        replaces="unitysspathtracingurp_tpu/ops/pallas_gather.py:241",
    ),
    "rowwise_select": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/pallas_gather.cu",
        replaces="unitysspathtracingurp_tpu/ops/pallas_gather.py:127",
    ),
    "ray_march": dict(
        source="unitysspathtracingurp_tpu_torch/csrc/ray_march.cu",
        replaces="unitysspathtracingurp_tpu/ops/pathtrace.py:79",
    ),
}
# The kernels each path launches (the others must stay at 0 there).
PATHS = {
    "headline": ("schedule_pack", "resolve_rounds"),
    "dual": ("schedule_pack_dual", "resolve_rounds_dual"),
    "home": ("schedule_pack_home", "schedule_pack", "resolve_rounds"),
    "diagnostic": ("broadcast_table_select", "pack_by_slot", "resolve_rounds"),
    "extract": ("schedule_pack", "extract_chain", "rowwise_select"),
    "parity": ("ray_march",),
    "parity_dual": ("ray_march",),
    "dither2": ("schedule_pack", "resolve_rounds"),
}
# The G-buffer P1's bound counts: 4 B a texel of each depth image in use.
P1_LANE_IN = 12 + 12 + 12 + 4 + 4 + 4  # pos, dir, view dir, inside, dither, large step
P1_LANE_OUT = 6 * 4 + 2  # position, distance, uv; hit and back-hit bytes


class GateError(RuntimeError):
    pass


def gate(ok: bool, what: str):
    if not ok:
        raise GateError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events).

    A device spin queued ahead of the start event, at least 20 ms and at
    least 1.5 x ``reps`` x the host time of the warm-up call, keeps the
    card busy while the host queues the runs, so the events time the
    device alone and not the host's launch gaps."""
    import torch

    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = max(SPIN_MIN_S, 1.5 * reps * host_s)
    torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_kernels():
    """Route the hiz march through the kernels' plain PyTorch versions."""
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule, pallas_gather, pathtrace_hiz

    plain = {
        "schedule_pack": fused_schedule.schedule_pack_ref,
        "resolve_rounds": pathtrace_hiz.resolve_rounds_ref,
        "schedule_pack_dual": fused_schedule.schedule_pack_dual_ref,
        "resolve_rounds_dual": pathtrace_hiz.resolve_rounds_dual_ref,
        "schedule_pack_home": fused_schedule.schedule_pack_home_ref,
        "broadcast_table_select": pallas_gather.broadcast_table_select_ref,
        "pack_by_slot": pallas_gather.pack_by_slot_ref,
        "extract_chain": pallas_gather.extract_chain_ref,
        "rowwise_select": pallas_gather.rowwise_select_ref,
    }
    names = tuple(plain)
    saved = [getattr(pathtrace_hiz, n) for n in names]
    for name, fn in plain.items():
        setattr(pathtrace_hiz, name, fn)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(pathtrace_hiz, n, fn)


@functools.lru_cache(maxsize=None)
def boxscene(h, w, dev, glass=False):
    """BoxScene G-buffer + camera; ``glass``: the IOR-1.45 sphere and no
    mirror, with the backface pass (the refraction configuration). Built
    once per size and scene: the host rasterizes 1080p in seconds, and
    nothing changes a G-buffer in place."""
    from unitysspathtracingurp_tpu_torch.models import fixtures, scene

    cam = fixtures.box_scene_camera(h, w, device=dev)
    sc = (scene.build_box_scene(with_glass=True, with_mirror=False) if glass
          else scene.build_box_scene())
    gb = fixtures.rasterize_gbuffers(sc, cam, h, w, device=dev, with_backface=glass)
    return gb, cam


def march_inputs(gb, cam):
    """Bounce-0 reflection rays tilted as tests/test_fused_schedule.py:36-61."""
    import torch

    from unitysspathtracingurp_tpu_torch.camera import (
        linear_eye_depth, pixel_uv, world_from_uv_depth,
    )

    h, w = gb.height, gb.width
    uv = pixel_uv(h, w, device=gb.device)
    pos_ws = world_from_uv_depth(cam.inv_view_proj, uv, gb.depth)
    view_dir = pos_ws - cam.position
    view_dir = view_dir / torch.linalg.norm(view_dir, dim=-1, keepdim=True)
    n = gb.normal
    refl = view_dir - 2.0 * (view_dir * n).sum(-1, keepdim=True) * n
    tilt = torch.stack([torch.cos(uv[..., 0] * 7.0), torch.sin(uv[..., 1] * 5.0),
                        torch.cos(uv[..., 0] * 3.0)], -1)
    d = refl + 0.3 * tilt
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return dict(
        origin=pos_ws + n * 1e-4, d=d, alive=gb.depth != 0.0, view_dir=view_dir,
        scene_dist=linear_eye_depth(gb.depth, cam.near, cam.far),
    )


def check_kernels(h, w, dev, timing: bool):
    """Phase 3, plain layout, at one size: K1 and R1 against their plain versions."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_depth_tiles

    gb, cam = boxscene(h, w, dev)
    x = march_inputs(gb, cam)
    cfg, settings = PTConfig(), PTSettings(maximum_steps=24, dithering=False)
    tiles = build_depth_tiles(gb.depth, cam.near, cam.far)
    n = h * w
    large_step = settings.step_size + (20.0 - settings.step_size) * x["scene_dist"] * 0.001
    is_back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
    scalars = fs.schedule_scalars(cam)
    k1_args = (x["origin"].reshape(n, 3), x["d"].reshape(n, 3),
               torch.zeros(n, device=dev), large_step.reshape(n),
               x["alive"].reshape(n), is_back, tiles.mini_table, scalars)
    k1_kw = fs.march_kwargs(cfg, tiles, 24)
    got = fs.schedule_pack(*k1_args, **k1_kw)
    ref = fs.schedule_pack_ref(*k1_args, **k1_kw)
    torch.cuda.synchronize()
    k1_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    same_n = (got[3] == ref[3]).float().mean().item()
    same_scode = got[1] == ref[1]
    scode_eq = same_scode.float().mean().item()
    d_lcum = (torch.div(got[2], 4096, rounding_mode="floor")
              - torch.div(ref[2], 4096, rounding_mode="floor")).abs()[same_scode]
    d_lhd = (torch.remainder(got[2], 4096) - torch.remainder(ref[2], 4096)).abs()[same_scode]
    k1_err = (got[0] - ref[0]).abs()[same_scode].max().item()
    hist_codes = max(d_lcum.max().item(), d_lhd.max().item())
    threads, smem = fs.pack_budget(tiles.mini_table.numel(), k1_kw["k"], 3)
    print(f"phase 3 K1 schedule_pack {w}x{h}: all 4 outputs equal {k1_equal}, n_cand equal "
          f"{same_n:.6f}, scode equal {scode_eq:.6f}, hist max code diff {hist_codes:.0f}, "
          f"cum max abs err {k1_err:.3e}, lanes with candidates "
          f"{(ref[3] > 0).float().mean().item():.4f}, lanes at K "
          f"{(ref[3] == k1_kw['k']).float().mean().item():.4f}; {threads} threads a block, "
          f"{smem} B dynamic shared")
    gate(same_n >= 0.9999 and scode_eq >= 0.9999, "K1 n_cand/scode agreement")
    gate(hist_codes <= 1.0 and k1_err < 1e-5, "K1 hist/cum agreement")
    gate(k1_equal, "K1 bit-exact against its plain version")

    r1_args = (*ref[:4], k1_args[0], k1_args[1], is_back, tiles.pair_table, scalars)
    r1_kw = dict(gh=h, gw=w, pairs_x=tiles.pairs_x,
                 n_rounds=ph.default_rounds(h, w), chain=cfg.hiz_chain, s_max=24)
    res_k = ph.resolve_rounds(*r1_args, **r1_kw)
    res_r, links, r1_b = r1_reference(r1_args, r1_kw)
    torch.cuda.synchronize()
    march = [
        ph.finalize(r.reshape(11, h, w), x["origin"], x["d"], is_back.reshape(h, w),
                    cam, h, w)
        for r in (res_k, res_r)
    ]
    hit_k, hit_r = march[0].hit, march[1].hit
    hit_agree = (hit_k == hit_r).float().mean().item()
    both = hit_k & hit_r
    uv_agree = ((march[0].uv - march[1].uv).abs().amax(-1) < 1e-6)[both].float().mean().item()
    r1_err = (march[0].distance - march[1].distance).abs()[both].max().item()
    print(f"phase 3 R1 resolve_rounds {w}x{h}: hit agreement {hit_agree:.6f}, "
          f"uv agreement {uv_agree:.6f}, distance max abs err {r1_err:.3e}, "
          f"hit fraction {hit_r.float().mean().item():.4f}")
    gate(hit_agree >= 0.9995 and uv_agree >= 0.999, "R1 hit/uv agreement")

    out = {"schedule_pack": {"max_abs_err": k1_err}, "resolve_rounds": {"max_abs_err": r1_err}}
    if timing:
        out["schedule_pack"].update(bound(
            n * (12 + 12 + 4 + 4 + 1 + 1) + n * (16 * 12 + 4) + tiles.mini_table.numel() * 4,
            n * 24 * STEP_OPS))
        out["resolve_rounds"].update(r1_b)
        print(f"phase 3 R1 {w}x{h}: {float(links.sum()) / n:.3f} links a lane, warp "
              f"efficiency {warp_efficiency(links):.4f}")
        out["schedule_pack"]["ms"] = cuda_ms(lambda: fs.schedule_pack(*k1_args, **k1_kw), 20)
        out["schedule_pack"]["plain_ms"] = cuda_ms(
            lambda: fs.schedule_pack_ref(*k1_args, **k1_kw), 3)
        out["resolve_rounds"]["ms"] = cuda_ms(lambda: ph.resolve_rounds(*r1_args, **r1_kw), 20)
        out["resolve_rounds"]["plain_ms"] = cuda_ms(
            lambda: ph.resolve_rounds_ref(*r1_args, **r1_kw), 3)
    out.update(check_unfused(f"{w}x{h} plain, zero start", ph.resolve_rounds_unfused,
                             ph.resolve_rounds, r1_args, r1_kw, timing=timing))
    return out


def check_unfused(label, unfused, fused, args, kw, state=None, timing=False):
    """Phase 3: the unfused resolve rounds (K5 + row gather + K7) against
    R1 on R1's inputs, every row bit for bit; K5 and K7 against their
    plain versions on the inputs the unfused rounds' first round gave
    them. With ``timing``, K5's and K7's numbers on those inputs."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops import pallas_gather as pg
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph

    seen = {}
    real = {name: getattr(ph, name) for name in ("extract_chain", "row_gather",
                                                 "rowwise_select")}

    def spy(name):
        def call(*a):
            seen.setdefault(name, a)
            return real[name](*a)
        return call

    for name in real:
        setattr(ph, name, spy(name))
    try:
        got = unfused(*args, state=state, **kw)
    finally:
        for name, fn in real.items():
            setattr(ph, name, fn)
    ref = fused(*args, state=state, **kw)
    # The kernels' own inputs as the wrappers pass them (int32 indices).
    fields, ptr, chain, slot_hi = seen["extract_chain"]
    k5_in = (fields, ptr.to(torch.int32), chain, slot_hi)
    blocks, idx = seen["rowwise_select"][0], seen["rowwise_select"][1].to(torch.int32)
    k5, k5_ref = pg.extract_chain(*k5_in), pg.extract_chain_ref(*k5_in)
    k7, k7_ref = pg.rowwise_select(blocks, idx), pg.rowwise_select_ref(blocks, idx)
    torch.cuda.synchronize()
    rows_equal = torch.equal(got.view(torch.int32), ref.view(torch.int32))
    k5_equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(k5, k5_ref))
    k7_equal = torch.equal(k7, k7_ref)
    k5_err = max((a - b).abs().max().item() for a, b in zip(k5, k5_ref))
    k7_err = (k7.to(torch.int64) - k7_ref.to(torch.int64)).abs().max().item()
    hit = got[0 if state is None else 1]
    print(f"phase 3 unfused resolve (K5 extract_chain + K7 rowwise_select) {label}: "
          f"{ref.shape[0]} rows equal to R1's {rows_equal}, hit fraction "
          f"{hit.mean().item():.4f}; K5 ({len(fields)} fields, window {slot_hi}) equal "
          f"{k5_equal}, K7 (K = {idx.shape[1]}) equal {k7_equal}")
    gate(rows_equal, f"unfused resolve rows equal R1's ({label})")
    gate(k5_equal and k7_equal, f"K5 / K7 bit-exact against their plain versions ({label})")
    if not timing:
        return {}
    n, nf = ptr.numel(), len(fields)
    win = ptr.to(torch.int64)[None] + torch.arange(chain, device=ptr.device)[:, None]
    in_window = float(((win >= 0) & (win < slot_hi)).sum())
    # K5 reads ptr and only the slots inside the window, writes chain x nf.
    out = {"extract_chain": dict(max_abs_err=k5_err, **bound(
        n * 4 + in_window * nf * 4 + chain * n * nf * 4, chain * n * nf))}
    out["extract_chain"]["ms"] = cuda_ms(lambda: pg.extract_chain(*k5_in), 20)
    out["extract_chain"]["plain_ms"] = cuda_ms(lambda: pg.extract_chain_ref(*k5_in), 5)
    # Library: one torch.gather over the stacked fields; the window's
    # where (zeros past slot_hi) is a second op, not timed.
    stacked = torch.stack(fields)
    index = win.clamp(0, fields[0].shape[0] - 1)[None].expand(nf, chain, n).contiguous()
    out["extract_chain"]["library_ms"] = cuda_ms(lambda: torch.gather(stacked, 1, index), 20)
    # K7: idx read and values written (4 B each), and each distinct 32-B
    # sector of a row that this run's indices select (16 per 512-B row).
    sector = ((idx & 127) >> 3).to(torch.int64)
    sectors = float(torch.zeros(idx.shape[0], 16, dtype=torch.bool, device=idx.device)
                    .scatter_(1, sector, True).sum())
    out["rowwise_select"] = dict(max_abs_err=float(k7_err),
                                 **bound(idx.numel() * (4 + 4) + sectors * 32, idx.numel()))
    out["rowwise_select"]["ms"] = cuda_ms(lambda: pg.rowwise_select(blocks, idx), 20)
    out["rowwise_select"]["plain_ms"] = cuda_ms(lambda: pg.rowwise_select_ref(blocks, idx), 5)
    idx64 = idx.to(torch.int64) & 127
    out["rowwise_select"]["library_ms"] = cuda_ms(lambda: torch.gather(blocks, 1, idx64), 20)
    print(f"phase 3 K5 / K7 {label}: K5 {out['extract_chain']['ms']:.4f} ms (torch.gather "
          f"{out['extract_chain']['library_ms']:.4f}), K7 {out['rowwise_select']['ms']:.4f} ms "
          f"(torch.gather {out['rowwise_select']['library_ms']:.4f}; {int(sectors)} distinct "
          f"sectors for {idx.numel()} words), the round's row gather "
          f"(index_select, {blocks.numel() * 4 / 1e9:.3f} GB) "
          f"{cuda_ms(lambda: pg.row_gather(*seen['row_gather']), 20):.4f} ms [{card_line()}]")
    return out


def dual_settings(**kw):
    """The refraction1080 configuration of scripts/bench_suite.py:157-167."""
    from unitysspathtracingurp_tpu_torch.config import DenoiserType, PTSettings, ThicknessMode

    return PTSettings(maximum_depth=3, samples_per_pixel=1, maximum_steps=24,
                      support_refraction=True, accurate_thickness=ThicknessMode.DEPTH_NORMALS,
                      dithering=False, denoiser=DenoiserType.OFFLINE, **kw)


def check_dual_kernels(h, w, dev, timing: bool):
    """Phase 3, dual layout, at one size: K4 and R1's dual mode against
    their plain versions, bit for bit, with insideObject 0, 1 and 2."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph

    gb, cam = boxscene(h, w, dev, glass=True)
    x = march_inputs(gb, cam)
    settings = dual_settings()
    tiles = ph.build_tiles_for(gb, cam, settings.variants())
    gate(tiles.n_combos == 3, "refraction + backface tiles have 3 combos")
    n = h * w
    large_step = settings.step_size + (20.0 - settings.step_size) * x["scene_dist"] * 0.001
    is_back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
    scalars = fs.schedule_scalars(cam)
    out = {"schedule_pack_dual": {"max_abs_err": 0.0}, "resolve_rounds_dual": {"max_abs_err": 0.0}}
    for inside in (0, 1, 2):
        combo = torch.full((n,), inside, dtype=torch.int32, device=dev)
        search = is_back | (inside == 2)
        k4_args = (x["origin"].reshape(n, 3), x["d"].reshape(n, 3),
                   torch.zeros(n, device=dev), large_step.reshape(n), x["alive"].reshape(n),
                   combo, search, tiles.mini_table, tiles.bmax_table, scalars)
        k4_kw = dict(fs.march_kwargs(PTConfig(), tiles, 24),
                     chunks_per_combo=tiles.chunks_per_combo)
        got = fs.schedule_pack_dual(*k4_args, **k4_kw)
        ref = fs.schedule_pack_dual_ref(*k4_args, **k4_kw)
        torch.cuda.synchronize()
        k4_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        k4_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        r1_args = (*ref[:5], k4_args[0], k4_args[1], is_back, combo, search,
                   tiles.tile_table, scalars)
        r1_kw = dict(gh=h, gw=w, tiles_x=tiles.tiles_x, tiles_per_combo=tiles.tiles_per_combo,
                     n_rounds=ph.default_rounds(h, w), chain=4, s_max=24, has_back=True)
        res_k = ph.resolve_rounds_dual(*r1_args, **r1_kw)
        res_r, links, r1_b = r1_reference(r1_args, r1_kw, dual=True)
        torch.cuda.synchronize()
        r1_equal = torch.equal(res_k, res_r)
        r1_err = (res_k - res_r).abs().max().item()
        threads, smem = fs.pack_budget(0, k4_kw["k"], 4)
        print(f"phase 3 K4 schedule_pack_dual {w}x{h} inside {inside}: all 5 outputs equal "
              f"{k4_equal}, max abs err {k4_err:.3e}, lanes with candidates "
              f"{(ref[4] > 0).float().mean().item():.4f}, lanes at K "
              f"{(ref[4] == k4_kw['k']).float().mean().item():.4f} ({threads} threads a "
              f"block, {smem} B dynamic shared); R1 dual resolve_rounds_dual: "
              f"15 rows equal {r1_equal}, max abs err {r1_err:.3e}, hit fraction "
              f"{res_r[0].mean().item():.4f}, back hits {res_r[13].mean().item():.4f}, "
              f"search hits {(res_r[14] * res_r[0]).mean().item():.4f}")
        gate(k4_equal, f"K4 bit-exact against its plain version (inside {inside})")
        gate(r1_equal, f"R1 dual bit-exact against its plain version (inside {inside})")
        gate(bool((ref[4] > 0).any()) and bool((res_r[0] > 0).any()),
             f"dual kernels exercised (inside {inside})")
        check_unfused(f"{w}x{h} dual inside {inside}", ph.resolve_rounds_dual_unfused,
                      ph.resolve_rounds_dual, r1_args, r1_kw)
        out["schedule_pack_dual"]["max_abs_err"] = max(out["schedule_pack_dual"]["max_abs_err"],
                                                       k4_err)
        out["resolve_rounds_dual"]["max_abs_err"] = max(
            out["resolve_rounds_dual"]["max_abs_err"], r1_err)
        if timing and inside == 0:
            tab = (tiles.mini_table.numel() + tiles.bmax_table.numel()) * 4
            out["schedule_pack_dual"].update(bound(
                n * (12 + 12 + 4 + 4 + 1 + 4 + 1) + n * (16 * 16 + 4) + tab,
                n * 24 * STEP_OPS))
            out["resolve_rounds_dual"].update(r1_b)
            print(f"phase 3 R1 dual {w}x{h} inside 0: {float(links.sum()) / n:.3f} links a "
                  f"lane, warp efficiency {warp_efficiency(links):.4f}")
            out["schedule_pack_dual"]["ms"] = cuda_ms(
                lambda: fs.schedule_pack_dual(*k4_args, **k4_kw), 20)
            out["schedule_pack_dual"]["plain_ms"] = cuda_ms(
                lambda: fs.schedule_pack_dual_ref(*k4_args, **k4_kw), 3)
            out["resolve_rounds_dual"]["ms"] = cuda_ms(
                lambda: ph.resolve_rounds_dual(*r1_args, **r1_kw), 20)
            out["resolve_rounds_dual"]["plain_ms"] = cuda_ms(
                lambda: ph.resolve_rounds_dual_ref(*r1_args, **r1_kw), 3)
    return out


def check_home_kernels(h, w, dev, timing: bool):
    """Phase 3, home prefix, at one size: K6 against its plain version on
    all 5 outputs, and R1 started from K6's state against its plain
    version, bit for bit."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_depth_tiles, build_home_strips

    gb, cam = boxscene(h, w, dev)
    x = march_inputs(gb, cam)
    settings = PTSettings(maximum_steps=24, dithering=False)
    tiles = build_depth_tiles(gb.depth, cam.near, cam.far)
    n = h * w
    large_step = settings.step_size + (20.0 - settings.step_size) * x["scene_dist"] * 0.001
    is_back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
    strips = build_home_strips(tiles, h, w)
    k6_args = (x["origin"].reshape(n, 3), x["d"].reshape(n, 3), torch.zeros(n, device=dev),
               large_step.reshape(n), x["alive"].reshape(n), is_back, tiles.mini_table, strips,
               fs.schedule_scalars(cam))
    k6_kw = dict(fs.march_kwargs(PTConfig(), tiles, 24), home_shape=(h, w))
    got = fs.schedule_pack_home(*k6_args, **k6_kw)
    ref = fs.schedule_pack_home_ref(*k6_args, **k6_kw)
    torch.cuda.synchronize()
    k6_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    k6_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
    state = torch.cat([torch.zeros_like(ref[4][:1]), ref[4]])
    r1_args = (*ref[:4], k6_args[0], k6_args[1], is_back, tiles.pair_table, k6_args[8])
    r1_kw = dict(gh=h, gw=w, pairs_x=tiles.pairs_x, n_rounds=ph.default_rounds(h, w),
                 chain=4, s_max=24)
    res_k = ph.resolve_rounds(*r1_args, state=state, **r1_kw)
    res_r = ph.resolve_rounds_ref(*r1_args, state=state, **r1_kw)
    torch.cuda.synchronize()
    r1_equal = torch.equal(res_k, res_r)
    prefix_hit = ref[4][0].mean().item()
    print(f"phase 3 K6 schedule_pack_home {w}x{h}: all 5 outputs equal {k6_equal}, max abs "
          f"err {k6_err:.3e}, prefix hits {prefix_hit:.4f}, lanes with packed candidates "
          f"{(ref[3] > 0).float().mean().item():.4f}; R1 from K6's state: 12 rows equal "
          f"{r1_equal}, hit fraction {res_r[1].mean().item():.4f}")
    gate(k6_equal, "K6 bit-exact against its plain version")
    gate(r1_equal, "R1 state-in bit-exact against its plain version")
    gate(prefix_hit > 0.0 and bool((res_r[1] > ref[4][0]).any()), "home kernels exercised")
    check_unfused(f"{w}x{h} from K6's state", ph.resolve_rounds_unfused, ph.resolve_rounds,
                  r1_args, r1_kw, state=state)
    out = {"schedule_pack_home": {"max_abs_err": k6_err}}
    if timing:
        out["schedule_pack_home"].update(bound(
            n * (12 + 12 + 4 + 4 + 1 + 1) + n * (16 * 12 + 4 + 11 * 4)
            + (tiles.mini_table.numel() + strips.numel()) * 4, n * 24 * STEP_OPS))
        out["schedule_pack_home"]["ms"] = cuda_ms(lambda: fs.schedule_pack_home(*k6_args, **k6_kw),
                                                  20)
        out["schedule_pack_home"]["plain_ms"] = cuda_ms(
            lambda: fs.schedule_pack_home_ref(*k6_args, **k6_kw), 3)
        # Beside it in the same call: K1 on the same rays.
        k1_args = k6_args[:7] + k6_args[8:]
        k1_kw = fs.march_kwargs(PTConfig(), tiles, 24)
        k1_ms = cuda_ms(lambda: fs.schedule_pack(*k1_args, **k1_kw), 20)
        r1_ms = cuda_ms(lambda: ph.resolve_rounds(*r1_args, state=state, **r1_kw), 20)
        print(f"phase 3 K6 {w}x{h}: {out['schedule_pack_home']['ms']:.4f} ms beside K1 "
              f"{k1_ms:.4f} ms on the same rays; R1 from K6's state {r1_ms:.4f} ms")
    return out


def check_gather_kernels(h, w, dev, timing: bool):
    """Phase 3, the unfused front half at one size: K2 and K3 at the
    shapes of bounce 0 (S = 24 steps x N lanes) against their plain
    versions, bit for bit, plain layout and dual (insideObject 1), and
    the K2 + K3 packs against K1's / K4's."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
    from unitysspathtracingurp_tpu_torch.ops import pallas_gather as pg
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_depth_tiles, mini_of

    out = {"broadcast_table_select": {"max_abs_err": 0.0}, "pack_by_slot": {"max_abs_err": 0.0}}
    for dual in (False, True):
        gb, cam = boxscene(h, w, dev, glass=dual)
        x = march_inputs(gb, cam)
        settings = dual_settings() if dual else PTSettings(maximum_steps=24, dithering=False)
        tiles = (ph.build_tiles_for(gb, cam, settings.variants()) if dual
                 else build_depth_tiles(gb.depth, cam.near, cam.far))
        n = h * w
        large_step = settings.step_size + (20.0 - settings.step_size) * x["scene_dist"] * 0.001
        is_back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
        lane_args = (x["origin"].reshape(n, 3), x["d"].reshape(n, 3), torch.zeros(n, device=dev),
                     large_step.reshape(n), x["alive"].reshape(n))
        scalars = fs.schedule_scalars(cam)
        kw = fs.march_kwargs(PTConfig(), tiles, 24)
        dual_lanes = None
        if dual:
            combo = torch.ones(n, dtype=torch.int32, device=dev)
            dual_lanes = (combo, is_back)
            fused = fs.schedule_pack_dual(*lane_args, combo, is_back, tiles.mini_table,
                                          tiles.bmax_table, scalars,
                                          chunks_per_combo=tiles.chunks_per_combo, **kw)
        else:
            fused = fs.schedule_pack(*lane_args, is_back, tiles.mini_table, scalars, **kw)
        unfused = ph.unfused_front_half(lane_args, is_back, scalars, tiles, kw,
                                        dual_lanes=dual_lanes)
        # The kernels against their plain versions on this run's inputs.
        steps = list(fs.march_steps(*lane_args, scalars, **kw))
        idx = mini_of(torch.stack([st["ix"] for st in steps]),
                      torch.stack([st["iy"] for st in steps]), tiles.minis_x)
        if dual:
            idx = idx + tiles.chunks_per_combo * 128
        idx = idx.to(torch.int32)
        k2 = pg.broadcast_table_select(tiles.mini_table, idx)
        k2_ref = pg.broadcast_table_select_ref(tiles.mini_table, idx)
        cand = torch.stack([st["proc"] for st in steps]) & (torch.rand(idx.shape, device=dev) < 0.5)
        fields = [torch.stack([st[key] for st in steps]) for key in ("cum", "th", "hitd")]
        if dual:
            fields.append(torch.stack([st["step"] for st in steps]))
        k3, k3_n = pg.pack_by_slot(cand, fields, kw["k"])
        k3_ref, k3_n_ref = pg.pack_by_slot_ref(cand, fields, kw["k"])
        torch.cuda.synchronize()
        k2_equal = torch.equal(k2, k2_ref)
        k3_equal = torch.equal(k3_n, k3_n_ref) and all(
            torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(k3, k3_ref))
        packs_equal = all(torch.equal(a, b) for a, b in zip(unfused, fused))
        layout = "dual (inside 1)" if dual else "plain"
        print(f"phase 3 K2 broadcast_table_select + K3 pack_by_slot {w}x{h} {layout}, S = "
              f"{len(steps)}: K2 equal {k2_equal}, K3 ({len(fields)} fields) equal {k3_equal}; "
              f"K2 + K3 packs equal to {'K4' if dual else 'K1'}'s {packs_equal}, lanes with "
              f"candidates {(fused[-1] > 0).float().mean().item():.4f}")
        gate(k2_equal and k3_equal, f"K2 / K3 bit-exact against their plain versions ({layout})")
        gate(packs_equal, f"K2 + K3 packs equal the fused front half's ({layout})")
        if timing and not dual:
            s_n = idx.numel()
            flat, idx64 = tiles.mini_table.reshape(-1), idx.to(torch.int64)
            out["broadcast_table_select"].update(bound(s_n * 8 + flat.numel() * 4, s_n))
            out["broadcast_table_select"]["ms"] = cuda_ms(
                lambda: pg.broadcast_table_select(tiles.mini_table, idx), 20)
            out["broadcast_table_select"]["plain_ms"] = cuda_ms(
                lambda: pg.broadcast_table_select_ref(tiles.mini_table, idx), 5)
            out["broadcast_table_select"]["library_ms"] = cuda_ms(
                lambda: torch.take(flat, idx64), 20)
            k = kw["k"]
            out["pack_by_slot"].update(k3_bound(len(steps), n, k, len(fields)))
            out["pack_by_slot"]["ms"] = cuda_ms(lambda: pg.pack_by_slot(cand, fields, k), 20)
            out["pack_by_slot"]["plain_ms"] = cuda_ms(
                lambda: pg.pack_by_slot_ref(cand, fields, k), 5)
    return out


def k3_bound(s: int, n: int, k: int, nf: int) -> dict:
    """K3's bound: the (S, N) flags (1 B) and ``nf`` fields (4 B) read
    once, the ``nf`` (K, N) tables and the (N,) count written once."""
    return bound(s * n * (1 + 4 * nf) + k * n * 4 * nf + n * 4, s * n * (2 + nf))


def k3_frame_report(dev, card):
    """K3 on its own inputs in every bounce of the 1080p diagnostic march
    (``frame_calls`` "diagnostic"): each call bit for bit against the
    plain version (a gate), then its ms, bound and share."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops import pallas_gather as pg

    calls, _ = frame_calls(dev, "diagnostic", "pack_by_slot")
    gate(len(calls) > 0, "the diagnostic march called pack_by_slot")
    for b, (a, kw) in enumerate(calls):
        got, ref = pg.pack_by_slot(*a, **kw), pg.pack_by_slot_ref(*a, **kw)
        torch.cuda.synchronize()
        equal = torch.equal(got[1], ref[1]) and all(
            torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got[0], ref[0]))
        (s, n), nf, k = a[0].shape, len(a[1]), ref[0][0].shape[0]
        b_ = k3_bound(s, n, k, nf)
        ms = cuda_ms(lambda: pg.pack_by_slot(*a, **kw), 20)
        print(f"phase 6 K3 on the diagnostic march's bounce {b} (S = {s}, N = {n}, {nf} fields, "
              f"K = {k}): equal to the plain version {equal}, {ms:.4f} ms, bound "
              f"{b_['bound_ms']:.4f} ms (share {b_['bound_ms'] / ms:.3f}), flags set "
              f"{a[0].float().mean().item():.4f} [{card}]")
        gate(equal, f"K3 bit-exact on the diagnostic march's bounce {b}")


def check_home_march(dev):
    """Phase 4: the home march against the non-home march at 1080p bounce
    0, 16 rounds, no cap, on the gate of tests/test_home_prefix.py:96-109
    over the lanes with at most K candidates. The two are order-exact
    only there: on a lane with more, the non-home pack keeps the first K
    while the home prefix tests up to 4 before its K slots."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph

    gb, cam = boxscene(H_FULL, W_FULL, dev)
    x = march_inputs(gb, cam)
    s = PTSettings(maximum_steps=24, dithering=False)
    tiles = ph.build_tiles_for(gb, cam, s.variants())
    zero = torch.zeros((H_FULL, W_FULL), device=dev)
    dbg = {}
    home, plain, _ = (
        ph.ray_march_hiz(PTConfig(hiz_home_prefix=home), s, s.variants(), gb, cam, x["origin"],
                         x["d"], zero, zero, -x["view_dir"], x["scene_dist"], x["alive"],
                         tiles=tiles, n_rounds=16, home_ok=True, _debug_out=debug)
        for home, debug in ((True, None), (False, None), (False, dbg))
    )
    torch.cuda.synchronize()
    fits = dbg["c0_n_cand_true"] <= 16

    def agreement(mask):
        agree = (home.hit == plain.hit)[mask].float().mean().item()
        both = home.hit & plain.hit & mask
        dd = torch.quantile((home.distance - plain.distance).abs()[both].double(), 0.999).item()
        uv = ((home.uv - plain.uv).abs().amax(-1) < 1e-6)[both].float().mean().item()
        return agree, dd, uv

    agree, dd, uv = agreement(fits)
    agree_all, dd_all, uv_all = agreement(torch.ones_like(fits))
    print(f"phase 4 home march vs non-home march {W_FULL}x{H_FULL} bounce 0, 16 rounds: lanes "
          f"with <= K candidates ({fits.float().mean().item():.6f} of all): hit agreement "
          f"{agree:.6f}, 99.9% |d distance| {dd:.3e}, uv agreement {uv:.6f}; all lanes: hit "
          f"agreement {agree_all:.6f}, 99.9% |d distance| {dd_all:.3e}, uv agreement "
          f"{uv_all:.6f}; hits {plain.hit.float().mean().item():.4f} non-home / "
          f"{home.hit.float().mean().item():.4f} home")
    gate(agree >= 0.999 and dd < 1e-4 and uv >= 0.999, "home march equals the non-home march")


def frame_calls(dev, path: str, name: str):
    """(args, kwargs) of every call of ``pathtrace_hiz.<name>`` in one
    1080p frame of ``path`` (one a bounce, in order), on the kernels, and
    the frame's tiles. ``path`` "diagnostic" is the diagnostic march
    that ``diagnostic_report`` runs: the headline frame with
    ``hiz_round_cap`` 0.4 and a ``_debug_out`` dict."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe

    debug = None
    if path == "diagnostic":
        s, cfg, bde, glass = path_config("headline")
        cfg, debug = dataclasses.replace(cfg, hiz_round_cap=0.4), {}
    else:
        s, cfg, bde, glass = path_config(path)
    gb, cam = boxscene(H_FULL, W_FULL, dev, glass=glass)
    probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
    tiles = ph.build_tiles_for(gb, cam, s.variants())
    calls = []
    real = getattr(ph, name)

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    setattr(ph, name, spy)
    try:
        ph.trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), 99, tiles=tiles,
                           back_depth_enabled=bde, _debug_out=debug)
        torch.cuda.synchronize()
    finally:
        setattr(ph, name, real)
    return calls, tiles


def r1_bound(lanes: int, active: float, links: float, hits: float, table_bytes: float,
             dual: bool = False, state_in: bool = False) -> dict:
    """R1's bound (R1-dual's with ``dual``) on this run's data. Every lane
    reads its slot count and writes its rows (and ptr in the state-in
    form, which reads every lane's ptr, hit flag and prev rows, and the
    other rows of every lane that does not hit); a lane with links to
    test reads its ray and back flag (dual: combo and search flag); a
    tested link reads cum and scode (dual: step too), a hit pk_hist; the
    L2-resident table comes from memory at most once (``table_bytes``:
    the slices in use)."""
    rows = 15 if dual else 11
    kept = 3 if dual else 2  # prev_diff, prev_sidx (, prev_sd)
    per_lane = 4 + (rows + state_in) * 4 + (2 + kept) * 4 * state_in
    passed = (lanes - hits) * (rows - kept - 1) * 4 * state_in
    ray = active * (12 + 12 + 1 + (5 if dual else 0))
    slots = links * (12 if dual else 8) + hits * 4
    return bound(lanes * per_lane + passed + ray + slots + min(links * 4, table_bytes),
                 links * STEP_OPS)


def r1_reference(args, kw, dual: bool = False):
    """R1's (R1-dual's) plain version on ``args``: its output, each
    lane's count of links tested and the kernel's bound on this run's
    data."""
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph

    links = []
    ref = (ph.resolve_rounds_dual_ref if dual else ph.resolve_rounds_ref)(
        *args, **kw, links_out=links)
    links = links[0]
    state = kw.get("state")
    hits = float((ref[0 if state is None else 1] > 0.5).sum())
    if state is not None:
        hits -= float((state[1] > 0.5).sum())
    table = (kw["tiles_per_combo"] * 128 * 4 * args[8].unique().numel() if dual
             else args[7].numel() * 4)
    return ref, links, r1_bound(args[0].shape[1], float((links > 0).sum()), float(links.sum()),
                                hits, table, dual, state is not None)


def warp_steps(steps) -> float:
    """The loop passes that warps of 32 consecutive lanes issue, one
    thread a lane (as R1 maps them): each warp runs as many as its
    longest lane."""
    import torch

    pad = (-steps.numel()) % 32
    return float(torch.cat([steps, steps.new_zeros(pad)]).view(-1, 32).amax(1).sum())


def warp_efficiency(links) -> float:
    """Share of issued link slots that do work, one thread a lane: sum of
    lane links over 32 x ``warp_steps``."""
    return float(links.sum()) / max(32.0 * warp_steps(links), 1.0)


def r1_frame_report(dev, card, path: str):
    """R1 (R1-dual on the dual path) on its own inputs in every bounce of
    a 1080p frame of ``path``: ms, bound, links a lane and warp
    efficiency."""
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph

    dual = path == "dual"
    name = "resolve_rounds_dual" if dual else "resolve_rounds"
    calls, _ = frame_calls(dev, path, name)
    for b, (a, kw) in enumerate(calls):
        _, links, b_ = r1_reference(a, kw, dual)
        n = a[0].shape[1]
        ms = cuda_ms(lambda: getattr(ph, name)(*a, **kw), 20)
        print(f"phase 6 {'R1-dual' if dual else 'R1'} on the {path} frame's bounce {b} "
              f"({n} lanes, {kw['n_rounds']} rounds"
              f"{', from the state in' if kw.get('state') is not None else ''}): {ms:.4f} ms, "
              f"bound {b_['bound_ms']:.4f} ms (share {b_['bound_ms'] / ms:.3f}), "
              f"{float(links.sum()) / max(n, 1):.3f} links a lane, warp efficiency "
              f"{warp_efficiency(links):.4f} [{card}]")


def diagnostic_report(dev, card):
    """Phase 6, a report except for the launch counts: the diagnostic
    march through a 1080p headline frame (counts set to 0 before and read
    after), its bounce-0 locality and round counters, the same rays with
    the home prefix, and the home prefix x round budget A/B."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig
    from unitysspathtracingurp_tpu_torch.kernels.build import LAUNCHES
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_home_strips
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe
    from unitysspathtracingurp_tpu_torch.ops.pathtrace import compact_capacity
    from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

    s = headline_settings()
    gb, cam = boxscene(H_FULL, W_FULL, dev)
    probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
    cfg = PTConfig.boxscene_headline()
    tiles = ph.build_tiles_for(gb, cam, s.variants())
    # The bounce-0 march inputs of the headline frame, caught on the way.
    seen = []
    real = ph.ray_march_hiz

    def spy(*args, **kw):
        if not seen:
            seen.append(args)
        return real(*args, **kw)

    dbg = {}
    ph.ray_march_hiz = spy
    LAUNCHES.clear()
    try:
        ph.trace_frame_hiz(gb, cam, probes, s, dataclasses.replace(cfg, hiz_round_cap=0.4),
                           s.variants(), 99, tiles=tiles, _debug_out=dbg)
        torch.cuda.synchronize()
    finally:
        ph.ray_march_hiz = real
    counts = dict(LAUNCHES)
    profile_frames(lambda: ph.trace_frame_hiz(
        gb, cam, probes, s, dataclasses.replace(cfg, hiz_round_cap=0.4), s.variants(), 99,
        tiles=tiles, _debug_out={}), card, "diagnostic march")
    gate(all(counts.get(name, 0) > 0 for name in PATHS["diagnostic"])
         and all(counts.get(name, 0) == 0 for name in KERNELS
                 if name not in PATHS["diagnostic"]),
         f"diagnostic march launch counts {counts}")
    n = H_FULL * W_FULL
    val = {k: float(v.float().sum()) if torch.is_tensor(v) else v for k, v in dbg.items()
           if k.startswith("c0_") and k != "c0_pk"}
    lanes_cand = float((dbg["c0_n_cand"] > 0).sum())
    print(f"phase 6 diagnostic march (K2 + K3) through a {W_FULL}x{H_FULL} headline frame, "
          f"hiz_round_cap 0.4: launches {counts} [{card}]")
    k3_frame_report(dev, card)
    print(f"phase 6 bounce 0 locality: candidates in the start pair window "
          f"{val['c0_cand_in_home'] / val['c0_cand_total']:.4f} of {val['c0_cand_total']:.0f}, "
          f"first candidate there {val['c0_first_in_home'] / lanes_cand:.4f} of "
          f"{lanes_cand:.0f} lanes with a candidate, within +-1 pair "
          f"{val['c0_cand_within_1'] / val['c0_cand_total']:.4f}, lanes above K "
          f"{float((dbg['c0_n_cand_true'] > 16).sum()):.0f}")
    print("phase 6 bounce 0 active lanes per round without home: "
          + ", ".join(f"r{r} {val[f'c0_active_r{r}']:.0f}" for r in range(4))
          + f"; round_compact_drop at cap 0.4 {val['c0_round_compact_drop']:.0f}")

    # The same bounce-0 rays with the home prefix: K6, then R1 one round at a time.
    cfg_, settings_, variants_, gb_, cam_, pos, ray_dir, inside, dither, view, sdist, alive = seen[0]
    lane_args = (pos.reshape(n, 3), ray_dir.reshape(n, 3), dither.expand(H_FULL, W_FULL).reshape(n),
                 (s.step_size + (20.0 - s.step_size) * sdist * 0.001).reshape(n), alive.reshape(n))
    is_back = ((ray_dir * view).sum(-1) > 0.0).reshape(n)
    scalars = fs.schedule_scalars(cam)
    *packs, home = fs.schedule_pack_home(
        *lane_args, is_back, tiles.mini_table, build_home_strips(tiles, H_FULL, W_FULL), scalars,
        home_shape=(H_FULL, W_FULL), **fs.march_kwargs(cfg, tiles, s.maximum_steps))
    state = torch.cat([torch.zeros_like(home[:1]), home])
    active = []
    for _ in range(4):
        active.append(float(((state[1] < 0.5) & (state[0] < packs[3].float())).sum()))
        state = ph.resolve_rounds(*packs, lane_args[0], lane_args[1], is_back, tiles.pair_table,
                                  scalars, state=state, gh=H_FULL, gw=W_FULL,
                                  pairs_x=tiles.pairs_x, n_rounds=1, chain=4,
                                  s_max=s.maximum_steps)
    cap_n = compact_capacity(0.4, n)
    print(f"phase 6 bounce 0 with home: prefix hits {float((home[0] > 0.5).sum()):.0f}, active "
          "lanes per round " + ", ".join(f"r{r} {a:.0f}" for r, a in enumerate(active))
          + f"; lanes past the 0.4 cap ({cap_n}) {max(active[0] - cap_n, 0.0):.0f}")

    # The front half on these real rays: K6 beside K1.
    k1_args = (*lane_args, is_back, tiles.mini_table, scalars)
    k1_kw = fs.march_kwargs(cfg, tiles, s.maximum_steps)
    strips = build_home_strips(tiles, H_FULL, W_FULL)
    k1_ms = cuda_ms(lambda: fs.schedule_pack(*k1_args, **k1_kw), 20)
    k6_ms = cuda_ms(lambda: fs.schedule_pack_home(
        *lane_args, is_back, tiles.mini_table, strips, scalars, home_shape=(H_FULL, W_FULL),
        **k1_kw), 20)
    print(f"phase 6 bounce-0 rays of the frame: K1 {k1_ms:.4f} ms, K6 {k6_ms:.4f} ms [{card}]")

    # R1 on every bounce of the headline and home frames, R1-dual on
    # every bounce of the dual frame, K4 on the dual frame's bounce 0,
    # each on its own inputs against its bound there.
    for path in ("headline", "home", "dual"):
        r1_frame_report(dev, card, path)
    k4_a, k4_kw = frame_calls(dev, "dual", "schedule_pack_dual")[0][0]
    n4 = k4_a[0].shape[0]
    k4_b = bound(n4 * (12 + 12 + 4 + 4 + 1 + 4 + 1) + n4 * (16 * 16 + 4)
                 + (k4_a[7].numel() + k4_a[8].numel()) * 4, n4 * 24 * STEP_OPS)
    k4_ms = cuda_ms(lambda: fs.schedule_pack_dual(*k4_a, **k4_kw), 20)
    print(f"phase 6 bounce-0 rays of the dual frame: K4 ({n4} lanes) {k4_ms:.4f} ms, bound "
          f"{k4_b['bound_ms']:.4f} ms [{card}]")

    # The A/B: home x n_rounds, with the 0.4 cap and without, against the
    # non-home headline (4 rounds) and against the non-home frame at an
    # ample 16 rounds. At 1 spp a pixel
    # whose path diverges gives an unrelated sample, so these count
    # diverging pixels rather than converged quality.
    ref = ph.trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), 99, tiles=tiles)
    ample = ph.trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), 99, tiles=tiles,
                               n_rounds=16)
    non_sky = (gb.layer1_depth() != 0.0).cpu().numpy()

    def march_ms(c, rounds):
        """The least of 5 means of 4 marches: the march is host-bound."""
        return min(cuda_ms(lambda: ph.ray_march_hiz(
            c, settings_, variants_, gb_, cam_, pos, ray_dir, inside, dither, view, sdist,
            alive, tiles=tiles, n_rounds=rounds, home_ok=True), 4) for _ in range(5))

    def against(img, base):
        rel, within = frame_agreement(img.cpu().numpy(), base.cpu().numpy(), non_sky)
        return f"{rel:.4e} (non-sky within 1e-3 {within:.6f})"

    print(f"phase 6 A/B non-home headline, 4 rounds: bounce-0 march {march_ms(cfg, 4):.4f} ms, "
          f"frame against 16 rounds {against(ref, ample)} [{card}]")
    no_cap = home_config(hiz_home_round_cap=None)
    for label, c, rounds in (("home, cap 0.4, 4 rounds", home_config(), 4),
                             ("home, cap 0.4, 2 rounds", home_config(), 2),
                             ("home, cap 0.4, 1 round", home_config(), 1),
                             ("home, no cap, 4 rounds", no_cap, 4),
                             ("home, no cap, 2 rounds", no_cap, 2),
                             ("home, no cap, 1 round", no_cap, 1)):
        img = ph.trace_frame_hiz(gb, cam, probes, s, c, s.variants(), 99, tiles=tiles,
                                 n_rounds=rounds)
        print(f"phase 6 A/B {label}: bounce-0 march {march_ms(c, rounds):.4f} ms, frame pooled "
              f"relative RMSE against the non-home headline {against(img, ref)}, against 16 "
              f"rounds {against(img, ample)} [{card}]")
    return counts


def random_dither(shape, dev, seed=5):
    """A random per-lane step dither in [-0.1, 0.1], as step dithering
    gives at intensity 1."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) * 0.2 - 0.1).to(dev)


def p1_call(gb, cam, x, settings, inside=0.0, dither=None):
    """The arguments of a parity-march call on ``march_inputs`` rays."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig

    ins = torch.full_like(x["scene_dist"], float(inside))
    dit = torch.zeros_like(x["scene_dist"]) if dither is None else dither
    return (PTConfig(), settings, settings.variants(), gb, cam, x["origin"], x["d"], ins, dit,
            -x["view_dir"], x["scene_dist"], x["alive"])


def p1_reference(args):
    """P1's plain version on ``args``: its output, each lane's steps and
    P1's bound on this run's data. Every lane reads its alive byte and
    writes its outputs; an alive lane reads its ray; each depth image
    that some alive lane's layout reads comes from memory at most once
    (they stay in L2); each step a lane runs costs STEP_OPS."""
    from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt

    _, _, variants, gb, _, pos, _, inside, _, _, _, alive = args
    steps = []
    ref = pt.ray_march_ref(*args, steps_out=steps)
    steps = steps[0]
    layer1, opaque, back = pt.march_depth_images(gb, variants)
    ins = inside.expand(alive.shape)[alive]
    # Layer 1 is read by lanes with insideObject 0 (by every lane without
    # refraction), the opaque layer by the others, the back layer by all.
    used = (opaque is None or bool((ins == 0.0).any()),
            opaque is not None and bool((ins != 0.0).any()), back is not None)
    image_bytes = sum(used) * layer1.numel() * 4
    lanes, n_alive = alive.numel(), float(alive.sum())
    b = bound(lanes * (1 + P1_LANE_OUT) + n_alive * P1_LANE_IN + image_bytes,
              float(steps.sum()) * STEP_OPS)
    return ref, steps, b


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def check_p1(label, args):
    """P1 against its plain version on ``args``, every output bit for bit."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt

    got = pt.ray_march(*args)
    ref, steps, b = p1_reference(args)
    torch.cuda.synchronize()
    equal = all(bits_equal(a, r) for a, r in zip(got, ref))
    err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
    print(f"phase 3 P1 ray_march {label}: all 5 outputs equal {equal}, max abs err {err:.3e}, "
          f"hits {ref.hit.float().mean().item():.4f}, back hits "
          f"{ref.is_back_hit.float().mean().item():.4f}, "
          f"{float(steps.sum()) / max(steps.numel(), 1):.3f} steps a lane, warp efficiency "
          f"{warp_efficiency(steps):.4f}")
    gate(equal, f"P1 bit-exact against its plain version ({label})")
    gate(bool(ref.hit.any()), f"P1 hits something ({label})")
    return ref, steps, b, err


def march_agreement(parity, hiz, alive, gh, gw) -> str:
    """How far the hiz march's result agrees with the parity march's on
    the same rays of a gh x gw G-buffer: hit / miss over the alive lanes,
    and the hit texel where both hit."""
    from unitysspathtracingurp_tpu_torch.gbuffer import uv_to_pixel

    alive = alive.expand(parity.hit.shape)
    both = parity.hit & hiz.hit
    same = [a == b for a, b in zip(uv_to_pixel(parity.uv, gh, gw), uv_to_pixel(hiz.uv, gh, gw))]
    return (f"hit agreement {(parity.hit == hiz.hit)[alive].float().mean().item():.4f} of alive "
            f"lanes (hits: P1 {parity.hit[alive].float().mean().item():.4f}, hiz "
            f"{hiz.hit[alive].float().mean().item():.4f}), same hit texel "
            f"{(same[0] & same[1])[both].float().mean().item():.4f} where both hit")


def check_march_kernels(h, w, dev, timing: bool):
    """Phase 3, the parity march at one size: P1 against its plain version
    on BoxScene bounce-0 rays (zero and random per-lane dither), on the
    glass box in the refraction + backface layout with insideObject 0, 1
    and 2, and (256^2) in the refraction-only and backface-only layouts."""
    from unitysspathtracingurp_tpu_torch.config import PTSettings, ThicknessMode
    from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph

    gb, cam = boxscene(h, w, dev)
    x = march_inputs(gb, cam)
    s = PTSettings(maximum_steps=24)
    args = p1_call(gb, cam, x, s)
    ref, steps, b, err = check_p1(f"{w}x{h} plain", args)
    hiz = ph.ray_march_hiz(*args, tiles=ph.build_tiles_for(gb, cam, s.variants()))
    print(f"phase 3 hiz march ({ph.default_rounds(h, w)} rounds) vs P1 {w}x{h} on the same rays: "
          f"{march_agreement(ref, hiz, x['alive'], h, w)}")
    out = {"ray_march": {"max_abs_err": err}}
    if timing:
        out["ray_march"].update(b)
        out["ray_march"]["ms"] = cuda_ms(lambda: pt.ray_march(*args), 20)
        out["ray_march"]["plain_ms"] = cuda_ms(lambda: pt.ray_march_ref(*args), 3)
        print(f"phase 3 P1 {w}x{h}: {out['ray_march']['ms']:.4f} ms, plain PyTorch "
              f"{out['ray_march']['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}; share {b['bound_ms'] / out['ray_march']['ms']:.3f})")
    check_p1(f"{w}x{h} plain, random dither",
             p1_call(gb, cam, x, s, dither=random_dither((h, w), dev)))
    ggb, gcam = boxscene(h, w, dev, glass=True)
    gx = march_inputs(ggb, gcam)
    glass = dual_settings()
    for inside in (0, 1, 2):
        _, _, _, e = check_p1(f"{w}x{h} glass, refraction + backface, inside {inside}",
                              p1_call(ggb, gcam, gx, glass, inside))
        out["ray_march"]["max_abs_err"] = max(out["ray_march"]["max_abs_err"], e)
    if h == 256:
        check_p1(f"{w}x{h} glass, refraction only, inside 1",
                 p1_call(ggb, gcam, gx, PTSettings(maximum_steps=24, support_refraction=True), 1))
        check_p1(f"{w}x{h} glass, backface only",
                 p1_call(ggb, gcam, gx, PTSettings(
                     maximum_steps=24, accurate_thickness=ThicknessMode.DEPTH_ONLY)))
    return out


def check_dither_kernels(dev):
    """Phase 3: K1, K4 (insideObject 0) and K6 with a random per-lane
    dither at 1080p, bit for bit against their plain versions."""
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_home_strips

    n = H_FULL * W_FULL
    dither = random_dither(n, dev)
    for glass in (False, True):
        gb, cam = boxscene(H_FULL, W_FULL, dev, glass=glass)
        x = march_inputs(gb, cam)
        s = dual_settings() if glass else headline_settings()
        tiles = ph.build_tiles_for(gb, cam, s.variants())
        large = (s.step_size + (20.0 - s.step_size) * x["scene_dist"] * 0.001).reshape(n)
        is_back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
        lane = (x["origin"].reshape(n, 3), x["d"].reshape(n, 3), dither, large,
                x["alive"].reshape(n))
        scalars = fs.schedule_scalars(cam)
        kw = fs.march_kwargs(PTConfig(), tiles, 24)
        if glass:
            combo = torch.zeros(n, dtype=torch.int32, device=dev)
            a = (*lane, combo, is_back, tiles.mini_table, tiles.bmax_table, scalars)
            kw = dict(kw, chunks_per_combo=tiles.chunks_per_combo)
            runs = {"K4": (fs.schedule_pack_dual, fs.schedule_pack_dual_ref, a, kw)}
        else:
            strips = build_home_strips(tiles, H_FULL, W_FULL)
            runs = {
                "K1": (fs.schedule_pack, fs.schedule_pack_ref,
                       (*lane, is_back, tiles.mini_table, scalars), kw),
                "K6": (fs.schedule_pack_home, fs.schedule_pack_home_ref,
                       (*lane, is_back, tiles.mini_table, strips, scalars),
                       dict(kw, home_shape=(H_FULL, W_FULL))),
            }
        for name, (fn, ref_fn, a, k) in runs.items():
            got, ref = fn(*a, **k), ref_fn(*a, **k)
            torch.cuda.synchronize()
            equal = all(torch.equal(g, r) for g, r in zip(got, ref))
            print(f"phase 3 {name} {W_FULL}x{H_FULL} with a random per-lane dither: all "
                  f"{len(ref)} outputs equal {equal}, lanes with candidates "
                  f"{(ref[3 if name != 'K4' else 4] > 0).float().mean().item():.4f}")
            gate(equal, f"{name} bit-exact with a non-zero dither")


def parity_calls(dev, path: str):
    """The arguments of every P1 call in one 1080p frame of the parity
    path ``path`` ("parity" or "parity_dual"; one a bounce, in order), on
    the kernel, and the frame's settings."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe

    s, cfg, bde, _ = path_config(path)
    gb, cam = path_scene(path, H_FULL, W_FULL, dev)
    probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
    calls = []

    def spy(*a, **kw):
        calls.append(a)
        return pt.ray_march(*a, **kw)

    pt.trace_frame(gb, cam, probes, s, cfg, s.variants(), 99, march_fn=spy,
                   back_depth_enabled=bde)
    torch.cuda.synchronize()
    return calls, s


def issue_ms(warp_passes: float, sass: int) -> float:
    """The least time ``warp_passes`` passes of ``sass`` SASS instructions
    each take when the card issues one warp-instruction a clock on each
    of its 528 schedulers."""
    return warp_passes * sass / ISSUE_PER_S * 1e3


def round_steps(steps, alive, span: int, most_compacted: int | None = None) -> float:
    """The step-loop passes P1's warps issue: each block of ``span``
    threads with at most ``most_compacted`` alive lanes (default: span -
    32, where that frees a warp) lists them in order, and each 32 of the
    list are one warp; any other block keeps each lane on its own thread.
    A warp runs as many steps as its longest lane. ``alive``: (N,) like
    ``steps``."""
    import torch

    most_compacted = span - 32 if most_compacted is None else most_compacted
    place = torch.arange(steps.numel(), device=steps.device)
    block = place // span
    alive = alive.to(torch.int64)
    total = torch.zeros(int(block.max()) + 1 if block.numel() else 0, dtype=torch.int64,
                        device=steps.device).index_add_(0, block, alive)
    ends = torch.cumsum(alive, 0)
    rank = ends - alive - torch.cat([total.new_zeros(1), total.cumsum(0)[:-1]])[block]
    where = torch.where(total[block] <= most_compacted, rank, place - block * span)
    warps = block * (span // 32) + where // 32
    most = torch.zeros(int(warps.max()) + 1 if warps.numel() else 0, dtype=steps.dtype,
                       device=steps.device)
    return float(most.scatter_reduce(0, warps, steps * alive, "amax").sum())


def p1_step_sass() -> dict:
    """{kernel: SASS instructions of its step loop (its longest loop with
    no warp vote, shuffle, atomic or global store)} of P1's instances in
    the built library (empty without cuobjdump)."""
    from unitysspathtracingurp_tpu_torch.kernels.build import library_sass_loops

    return {k: max(v["inner_loops"]) for k, v in library_sass_loops().items()
            if k.startswith("ray_march_kernel") and v["inner_loops"]}


def parity_report(dev, card):
    """Phase 6: P1 on its own inputs in every bounce of the 1080p parity
    headline and parity dual frames (each bit for bit against its plain
    version: a gate), with the warp-steps one thread a lane would issue,
    those P1 issues (``round_steps``), the lane-steps over 32 (what
    perfect refill would issue) and the issue-limited time of each at the
    step loop's SASS; beside K1 + R1 on the hiz headline frame's bounce-0
    inputs."""
    import torch

    from unitysspathtracingurp_tpu_torch.kernels.build import load_library
    from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
    from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt
    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph

    loop_sass, span = p1_step_sass(), load_library().sspt_ray_march_span()
    print(f"phase 6 P1 SASS instructions of the step loop by instance: {loop_sass}; "
          f"{span} lanes a block")
    p1_ms = {}
    for path in ("parity", "parity_dual"):
        calls, s = parity_calls(dev, path)
        _, opaque, back = pt.march_depth_images(calls[0][3], s.variants())
        sass = loop_sass.get(
            f"ray_march_kernel<{int(opaque is not None)},{int(back is not None)}>")
        name = PATH_NAMES[path].split(" (")[0]
        for b, a in enumerate(calls):
            got = pt.ray_march(*a)
            ref, steps, b_ = p1_reference(a)
            torch.cuda.synchronize()
            equal = all(bits_equal(g, r) for g, r in zip(got, ref))
            ms = cuda_ms(lambda: pt.ray_march(*a), 20)
            p1_ms.setdefault(path, []).append(ms)
            n, alive, lane_steps = steps.numel(), float(a[-1].sum()), float(steps.sum())
            ws = warp_steps(steps)
            rs = round_steps(steps, a[-1].expand(a[5].shape[:-1]).reshape(-1), span)
            issue = (f"issue-limited at {sass} SASS a step {issue_ms(ws, sass):.4f} ms one "
                     f"thread a lane, {issue_ms(rs, sass):.4f} ms as P1 issues them, "
                     f"{issue_ms(lane_steps / 32, sass):.4f} ms with perfect refill" if sass
                     else "issue-limited time not measured (no cuobjdump)")
            print(f"phase 6 P1 on the {name} frame's bounce {b} ({n} lanes, {alive:.0f} "
                  f"alive): equal to the plain version {equal}, {ms:.4f} ms, bound "
                  f"{b_['bound_ms']:.4f} ms (share {b_['bound_ms'] / ms:.3f}), "
                  f"{lane_steps / n:.3f} steps a lane, {lane_steps / max(alive, 1):.3f} an alive "
                  f"lane, warp efficiency {warp_efficiency(steps):.4f}; lane-steps "
                  f"{lane_steps:.0f}, warp-steps one thread a lane {ws:.0f}, as P1 issues them "
                  f"{rs:.0f}, lane-steps / 32 {lane_steps / 32:.0f}; {issue}; hits "
                  f"{ref.hit.float().mean().item():.4f} [{card}]")
            gate(equal, f"P1 bit-exact on the {name} frame's bounce {b}")
            if path == "parity":
                hiz = ph.ray_march_hiz(*a, tiles=ph.build_tiles_for(a[3], a[4], s.variants()))
                print(f"phase 6 hiz march (4 rounds) vs P1 on the parity headline frame's bounce "
                      f"{b}: {march_agreement(ref, hiz, a[-1], H_FULL, W_FULL)}")
    k1_a, k1_kw = frame_calls(dev, "headline", "schedule_pack")[0][0]
    r1_a, r1_kw = frame_calls(dev, "headline", "resolve_rounds")[0][0]
    k1_ms = cuda_ms(lambda: fs.schedule_pack(*k1_a, **k1_kw), 20)
    r1_ms = cuda_ms(lambda: ph.resolve_rounds(*r1_a, **r1_kw), 20)
    head, dual = p1_ms["parity"], p1_ms["parity_dual"]
    print(f"phase 6 bounce 0: P1 {head[0]:.4f} ms on the parity headline frame; K1 "
          f"{k1_ms:.4f} + R1 {r1_ms:.4f} = {k1_ms + r1_ms:.4f} ms on the hiz headline frame; "
          f"P1 over the frame's {len(head)} bounces {sum(head):.4f} ms, over the parity dual "
          f"frame's {len(dual)} {sum(dual):.4f} ms [{card}]")


def golden_gate(dev, card, frames=512):
    """Phase 6 gate: tests/test_e2e.py:63-104 through P1 on the card, 512
    frames at 256^2, 1 bounce, against the committed CPU golden (4096
    frames of the JAX package), pooled 4x4 relative RMSE < 0.035."""
    from pathlib import Path

    import numpy as np
    import torch

    from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings
    from unitysspathtracingurp_tpu_torch.models import fixtures, scene
    from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe
    from unitysspathtracingurp_tpu_torch.utils.metrics import relative_rmse

    golden = np.load(Path(__file__).resolve().parent / "fixtures" / "box256_golden_cpu.npz")
    r = 256
    cam = fixtures.box_scene_camera(r, r, device=dev)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(with_mirror=False), cam, r, r,
                                     device=dev)
    probes = ProbeSet(probe0=constant_probe([0.0, 0.0, 0.0], device=dev))
    s = PTSettings(maximum_depth=1, samples_per_pixel=1, maximum_steps=24, dithering=False)
    t0 = time.perf_counter()
    acc = torch.zeros((r, r, 3), dtype=torch.float64, device=dev)
    for i in range(frames):
        acc += pt.trace_frame(gb, cam, probes, s, PTConfig(), s.variants(), 33 * i % 64000,
                              march_fn=pt.ray_march)
    acc = (acc / frames).cpu().numpy()
    secs = time.perf_counter() - t0

    def pool(x):
        return x.reshape(r // 4, 4, r // 4, 4, 3).mean((1, 3))

    pmask = gb.depth.cpu().numpy().reshape(r // 4, 4, r // 4, 4).min((1, 3)) > 0
    rel = relative_rmse(pool(acc), pool(golden["image"]), pmask)
    print(f"phase 6 golden: {frames} frames at {r}x{r}, 1 bounce, through P1 against "
          f"fixtures/box256_golden_cpu.npz: pooled relative RMSE {rel:.5f} (gate < 0.035), "
          f"{secs:.1f} s [{card}]")
    gate(bool(rel < 0.035), f"golden regression through P1: pooled relative RMSE {rel:.5f}")


def deviation(img, ref, depth) -> str:
    """The metrics of scripts/quality_headline.py:90-125: pooled (4x4) and
    per-pixel relative RMSE over pixels with opaque depth, the mean
    bias, and the share of pooled cells (of all) over 1% and 5%."""
    from unitysspathtracingurp_tpu_torch.utils.metrics import relative_rmse

    h, w = depth.shape
    mask = depth > 0

    def pool(x):
        return x.reshape(h // 4, 4, w // 4, 4, 3).mean((1, 3))

    pmask = depth.reshape(h // 4, 4, w // 4, 4).min((1, 3)) > 0
    pooled = relative_rmse(pool(img), pool(ref), pmask)
    per_px = relative_rmse(img, ref, mask)
    bias = (img[mask].mean() - ref[mask].mean()) / ref[mask].mean()
    d = ((pool(img) - pool(ref)) ** 2).sum(-1) ** 0.5
    rel = (d / ((pool(ref) ** 2).sum(-1) ** 0.5 + 1e-6)) * pmask
    return (f"pooled relative RMSE {pooled:.5f}, per-pixel {per_px:.5f}, mean bias {bias:+.5f}, "
            f"pooled cells over 1% {float((rel > 0.01).mean()):.5f}, over 5% "
            f"{float((rel > 0.05).mean()):.5f}")


def deviation_report(dev, card, frames=128):
    """Phase 6: the converged hiz-vs-parity deviation of
    scripts/quality_headline.py:90-125 on the port, for the 1080p
    headline and the dual frame: both marches accumulate ``frames``
    frames of the same seed stream (frame indices 33 i mod 64000), so the
    Monte Carlo noise cancels in the difference; pooled (4x4) and
    per-pixel relative RMSE over pixels with opaque depth, the mean bias
    and the share of pooled cells over 1% / 5%."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe

    for hiz, parity in (("headline", "parity"), ("dual", "parity_dual")):
        s, _, _, _ = path_config(hiz)
        gb, cam = path_scene(hiz, H_FULL, W_FULL, dev)
        probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
        tiles = ph.build_tiles_for(gb, cam, s.variants())
        t0 = time.perf_counter()
        acc = {k: torch.zeros((H_FULL, W_FULL, 3), dtype=torch.float64, device=dev)
               for k in (hiz, parity)}
        for i in range(frames):
            fi = 33 * i % 64000
            acc[hiz] += trace_path(hiz, gb, cam, probes, fi, tiles=tiles)
            acc[parity] += trace_path(parity, gb, cam, probes, fi)
        img_h, img_x = ((acc[k] / frames).cpu().numpy() for k in (hiz, parity))
        secs = time.perf_counter() - t0
        depth = gb.depth.cpu().numpy()
        print(f"phase 6 hiz-vs-parity deviation, {PATH_NAMES.get(hiz, hiz)} {W_FULL}x{H_FULL}, "
              f"{frames} frames each, common seed stream: {deviation(img_h, img_x, depth)} "
              f"({secs:.1f} s) [{card}]")
        if hiz == "headline":
            # The floor: the parity march against itself on an independent
            # seed stream (frame indices 33 i + 17), i.e. Monte Carlo noise.
            other = torch.zeros_like(acc[parity])
            for i in range(frames):
                other += trace_path(parity, gb, cam, probes, (33 * i + 17) % 64000)
            print(f"phase 6 parity-vs-parity on independent seed streams, "
                  f"{PATH_NAMES.get(hiz, hiz)}, {frames} frames each (the noise floor): "
                  f"{deviation((other / frames).cpu().numpy(), img_x, depth)} [{card}]")


def headline_settings():
    from unitysspathtracingurp_tpu_torch.config import DenoiserType, PTSettings

    return PTSettings(maximum_depth=4, samples_per_pixel=1, maximum_steps=24,
                      dithering=False, denoiser=DenoiserType.OFFLINE,
                      maximum_samples=512)


def home_config(**kw):
    """The headline config with the home prefix and its round cap."""
    from unitysspathtracingurp_tpu_torch.config import PTConfig

    return dataclasses.replace(PTConfig.boxscene_headline(),
                               **{"hiz_home_prefix": True, "hiz_home_round_cap": 0.4, **kw})


def path_config(path: str):
    """(settings, cfg, back_depth_enabled, glass) of a main path (or of a
    phase-4 frame: "octfwd", the headline with oct-encoded normals and
    forward-only objects)."""
    from unitysspathtracingurp_tpu_torch.config import PTConfig

    if path in ("dual", "parity_dual"):
        s = dual_settings(maximum_samples=512)
        return s, PTConfig(), int(s.accurate_thickness.value), True
    if path == "home":
        return headline_settings(), home_config(), 0, False
    if path == "extract":
        return (headline_settings(),
                dataclasses.replace(PTConfig.boxscene_headline(), pallas_extract=True), 0, False)
    if path == "dither2":
        return (dataclasses.replace(headline_settings(), samples_per_pixel=2, dithering=True),
                PTConfig.boxscene_headline(), 0, False)
    if path == "octfwd":
        return (dataclasses.replace(headline_settings(), gbuffer_normals_oct=True,
                                    ignore_forward_objects=True),
                PTConfig.boxscene_headline(), 0, False)
    return headline_settings(), PTConfig.boxscene_headline(), 0, False


def path_kernel(path: str) -> str:
    """The Renderer's ``kernel`` of a path: the parity march (P1) on the
    parity paths, the hiz march on the others."""
    return "xla" if path.startswith("parity") else "hiz"


def path_scene(path: str, h, w, dev):
    """The G-buffer and camera of a path. "octfwd" stores oct-encoded
    normals in GBuffer2 and makes a block of the left wall and floor
    forward-only (smoothness 0: BoxScene has no such surface)."""
    from unitysspathtracingurp_tpu_torch.gbuffer import pack_normal_oct_quad

    gb, cam = boxscene(h, w, dev, glass=path_config(path)[3])
    if path == "octfwd":
        smooth = gb.smoothness.clone()
        smooth[h // 16:h * 7 // 16, w // 32:w * 3 // 8] = 0.0
        gb = dataclasses.replace(gb, normal=pack_normal_oct_quad(gb.normal), smoothness=smooth)
    return gb, cam


def trace_path(path: str, gb, cam, probes, frame_index, plain=False, tiles=None):
    """One pass-0 frame of ``path`` on the kernels, or with ``plain`` on
    their plain PyTorch versions."""
    from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt
    from unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz import trace_frame_hiz

    s, cfg, bde, _ = path_config(path)
    if path_kernel(path) == "xla":
        return pt.trace_frame(gb, cam, probes, s, cfg, s.variants(), frame_index,
                              march_fn=pt.ray_march_ref if plain else pt.ray_march,
                              back_depth_enabled=bde)
    with plain_kernels() if plain else contextlib.nullcontext():
        return trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), frame_index,
                               back_depth_enabled=bde, tiles=tiles)


def check_frame(h, w, dev, path: str):
    """Phase 4: one frame, kernels vs the plain path."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe
    from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

    gb, cam = path_scene(path, h, w, dev)
    probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
    fast = trace_path(path, gb, cam, probes, 99)
    plain = trace_path(path, gb, cam, probes, 99, plain=True)
    torch.cuda.synchronize()
    gate(bool(torch.isfinite(fast).all()), "frame has non-finite values")
    non_sky = (gb.layer1_depth() != 0.0).cpu().numpy()
    rel, within = frame_agreement(fast.cpu().numpy(), plain.cpu().numpy(), non_sky)
    print(f"phase 4 {path} frame {w}x{h}: pooled relative RMSE "
          f"{rel:.3e}, non-sky pixels within 1e-3 {within:.6f}")
    gate(rel < 0.01 and within >= 0.99, "frame agreement")


def check_extract_frame(h, w, dev, path: str):
    """Phase 4: the frame with pallas_extract (the unfused rounds, K5 +
    K7) against the default frame (R1), both on the kernels, bit for bit."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe
    from unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz import trace_frame_hiz
    from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

    s, cfg, bde, glass = path_config(path)
    gb, cam = boxscene(h, w, dev, glass=glass)
    probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
    base, ext = (
        trace_frame_hiz(gb, cam, probes, s, c, s.variants(), 99,
                        back_depth_enabled=bde).contiguous()
        for c in (cfg, dataclasses.replace(cfg, pallas_extract=True))
    )
    torch.cuda.synchronize()
    equal = torch.equal(ext.view(torch.int32), base.view(torch.int32))
    max_abs = (ext - base).abs().max().item()
    rel, _ = frame_agreement(ext.cpu().numpy(), base.cpu().numpy(),
                             (gb.layer1_depth() != 0.0).cpu().numpy())
    print(f"phase 4 {path} frame {w}x{h} with pallas_extract (K5 + K7) against the default "
          f"frame (R1): bit-equal {equal}, pooled relative RMSE {rel:.3e}, max abs {max_abs:.3e}")
    gate(bool(torch.isfinite(ext).all()), "extract frame has non-finite values")
    gate(equal, f"extract frame bit-equal to the default frame ({path})")


PATH_NAMES = {
    "dual": "dual (glass, refraction + DepthNormals)",
    "home": "home (headline + home prefix, hiz_home_round_cap 0.4)",
    "extract": "extract (headline + pallas_extract: unfused rounds, K5 + K7)",
    "parity": "parity headline (kernel xla: P1)",
    "parity_dual": "parity dual (kernel xla: P1, glass, refraction + DepthNormals)",
    "dither2": "headline, spp 2, step dithering (hiz)",
}


def main_path(dev, card, path: str):
    """Phase 5: the Renderer at 1080p, offline; the launch counts are
    set to 0 just before the path and read just after it."""
    import torch

    from unitysspathtracingurp_tpu_torch.kernels.build import LAUNCHES
    from unitysspathtracingurp_tpu_torch.models.renderer import Renderer
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe
    from unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz import default_rounds
    from unitysspathtracingurp_tpu_torch.utils.metrics import mrays_per_sec

    s, cfg, _, _ = path_config(path)
    gb, cam = path_scene(path, H_FULL, W_FULL, dev)
    r = Renderer(s, H_FULL, W_FULL, cfg=cfg,
                 probes=ProbeSet(probe0=constant_probe(PROBE, device=dev)),
                 kernel=path_kernel(path), device=dev)
    # Launches per frame: each march kernel once per bounce and sample;
    # the home prefix runs on bounce 0 only, the plain front half on the
    # others; the unfused rounds launch K5 and K7 once per round.
    bounces = s.maximum_depth
    expect = dict.fromkeys(PATHS[path], bounces * s.samples_per_pixel)
    if path == "home":
        expect.update(schedule_pack_home=1, schedule_pack=bounces - 1)
    if path == "extract":
        rounds = bounces * default_rounds(H_FULL, W_FULL)
        expect.update(extract_chain=rounds, rowwise_select=rounds)
    LAUNCHES.clear()
    per_frame = []
    image = r.render_frame(gb, cam)  # warm-up: builds the depth tiles
    torch.cuda.synchronize()
    per_frame.append(dict(LAUNCHES))
    times = []
    for _ in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        image = r.render_frame(gb, cam)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_frame.append(dict(LAUNCHES))
    launches = dict(LAUNCHES)
    dt = sum(times) / TIMED_FRAMES
    for i, counts in enumerate(per_frame, start=1):
        gate(all(counts.get(name, 0) == expect.get(name, 0) * i for name in KERNELS),
             f"launch counts after frame {i}: {counts}")
    gate(r.sample == 1 + TIMED_FRAMES, f"sample counter {r.sample}")
    gate(tuple(image.shape) == (H_FULL, W_FULL, 3), "image shape")
    gate(bool(torch.isfinite(image).all()), "accumulated image not finite")
    gate(float(r.offline_state.accum.mean()) > 0.0, "accumulated image is black")
    sky = float((gb.layer1_depth() == 0.0).float().mean())
    rate = mrays_per_sec(H_FULL, W_FULL, s.samples_per_pixel, s.maximum_depth, dt, sky)
    name = PATH_NAMES.get(path, path)
    print(f"phase 5 {name} main path Renderer.render_frame OFFLINE {W_FULL}x{H_FULL} "
          f"{s.maximum_depth} bounces: {dt * 1e3:.3f} ms/frame (min {min(times) * 1e3:.3f}, "
          f"max {max(times) * 1e3:.3f}), {rate:.3f} Mrays/s, "
          f"samples {r.sample}, launches {launches} [{card}]")
    profile_frames(lambda: r.render_frame(gb, cam), card, f"{name} main-path")
    return launches


def profile_frames(frame, card, name, frames=2):
    """Device time by kernel over ``frames`` more calls of ``frame`` (one
    frame each; torch.profiler, CUPTI). Reports; never fails the smoke."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                frame()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        for e in prof.events():  # device-side activity only: kernels, copies
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t, c = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        rows = [(t, c, key) for key, (t, c) in by_name.items()]
    except Exception as e:  # the profiler is a report, not a gate
        print(f"profile: torch.profiler failed: {e!r}")
        return
    busy = sum(t for t, _, _ in rows)
    if busy == 0:
        print("profile: torch.profiler saw no device time")
        return
    launches = sum(c for _, c, _ in rows)
    print(f"profile of {frames} {name} frames: wall {wall_us / frames / 1e3:.3f} "
          f"ms/frame, device busy {busy / frames / 1e3:.3f} ms/frame "
          f"(idle share {1.0 - busy / wall_us:.3f}), {launches / frames:.0f} "
          f"device ops/frame [{card}]")
    for t, c, key in sorted(rows, reverse=True)[:10]:
        print(f"profile:   {t / frames / 1e3:8.3f} ms/frame {100.0 * t / busy:5.1f}% "
              f"x{c // frames:<5d} {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from unitysspathtracingurp_tpu_torch.kernels.build import load_library, resource_usage
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    load_library()
    print(f"phase 2 kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    for r in resource_usage():
        print(f"phase 2 ptxas {r['kernel']}: {r['regs']} registers, {r['smem']} B static "
              f"shared, spill stores {r['spill_stores']} B, spill loads {r['spill_loads']} B, "
              f"stack {r['stack']} B")

    def mark(phase):
        print(f"chip_smoke: {phase} done at {time.perf_counter() - t0:.1f} s")

    stats = {}
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_dual_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_home_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_gather_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_march_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    check_dither_kernels(dev)
    mark("phase 3")
    for path in ("headline", "dual", "home", "parity", "parity_dual", "dither2", "octfwd"):
        for h, w in ((256, 256), (H_FULL, W_FULL)):
            check_frame(h, w, dev, path)
    check_home_march(dev)
    for path in ("headline", "dual"):
        for h, w in ((256, 256), (H_FULL, W_FULL)):
            check_extract_frame(h, w, dev, path)
    mark("phase 4")
    launches = {}
    for path in ("headline", "dual", "home", "extract", "parity", "parity_dual", "dither2"):
        counts = main_path(dev, card, path)
        for name in PATHS[path]:
            launches.setdefault(name, counts.get(name, 0))
    mark("phase 5")
    counts = diagnostic_report(dev, card)
    for name in ("broadcast_table_select", "pack_by_slot"):
        launches[name] = counts[name]
    mark("phase 6 diagnostic march")
    parity_report(dev, card)
    golden_gate(dev, card)
    deviation_report(dev, card)
    mark("phase 6")

    rows = [
        dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
             launches=launches[name], **{"library_ms": None, **stats[name]})
        for name, meta in KERNELS.items()
    ]
    for row in rows:
        print(f"kernel {row['name']} at the 1080p bounce-0 shape: {row['ms']:.4f} ms, "
              f"plain PyTorch {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['launches']} launches on its main path [{card}]")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except GateError as e:
        print(f"chip_smoke: gate failed: {e}", file=sys.stderr)
        sys.exit(1)
