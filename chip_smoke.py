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
     versions on the inputs the unfused rounds gave them;
  4. one whole headline frame, one whole dual frame and one whole home
     frame, with the kernels against the plain path; the home march
     against the non-home march at 1080p bounce 0 with 16 rounds; the
     headline and dual frames with pallas_extract against the default
     frames, bit for bit;
  5. the four main paths, each with the launch counts set to 0 just
     before and read just after it: Renderer.render_frame, OFFLINE,
     1920x1080, (a) the headline BoxScene with
     PTConfig.boxscene_headline(), (b) the glass BoxScene with
     refraction + DepthNormals thickness, (c) the headline with the
     home prefix and hiz_home_round_cap=0.4 and (d) the headline with
     pallas_extract (the unfused rounds); 1 warm-up + timed frames;
     each followed by a torch.profiler report of two more frames (a
     report, never a gate);
  6. a report, never a gate: the diagnostic march (K2 + K3, counts set
     to 0 before and read after) through a 1080p headline frame, its
     bounce-0 locality and round counters with and without the home
     prefix, and the home prefix x round budget A/B;
then one JSON line of per-kernel numbers, the card line again, and the
last line {"ok": true, "device": {...}}.

Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
}
# The kernels each path launches (the others must stay at 0 there).
PATHS = {
    "headline": ("schedule_pack", "resolve_rounds"),
    "dual": ("schedule_pack_dual", "resolve_rounds_dual"),
    "home": ("schedule_pack_home", "schedule_pack", "resolve_rounds"),
    "diagnostic": ("broadcast_table_select", "pack_by_slot", "resolve_rounds"),
    "extract": ("schedule_pack", "extract_chain", "rowwise_select"),
}


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
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
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


def boxscene(h, w, dev, glass=False):
    """BoxScene G-buffer + camera; ``glass``: the IOR-1.45 sphere and no
    mirror, with the backface pass (the refraction configuration)."""
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
    links = []
    res_k = ph.resolve_rounds(*r1_args, **r1_kw)
    res_r = ph.resolve_rounds_ref(*r1_args, **r1_kw, links_out=links)
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
        out["resolve_rounds"].update(r1_bound(n, float(links[0].sum()),
                                              tiles.pair_table.numel()))
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
        links = []
        res_k = ph.resolve_rounds_dual(*r1_args, **r1_kw)
        res_r = ph.resolve_rounds_dual_ref(*r1_args, **r1_kw, links_out=links)
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
            n_links = float(links[0].sum())
            tab = (tiles.mini_table.numel() + tiles.bmax_table.numel()) * 4
            out["schedule_pack_dual"].update(bound(
                n * (12 + 12 + 4 + 4 + 1 + 4 + 1) + n * (16 * 16 + 4) + tab,
                n * 24 * STEP_OPS))
            # Per link: the four slot fields; the tile table is L2-resident,
            # so at most the slices of the combos in use come from memory, once.
            table = min(n_links * 4, tiles.tiles_per_combo * 128 * 4
                        * combo.unique().numel())
            out["resolve_rounds_dual"].update(bound(
                n * (12 + 12 + 1 + 4 + 4 + 1) + n_links * 16 + table + n * 15 * 4,
                n_links * STEP_OPS))
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
            out["pack_by_slot"].update(bound(
                s_n * (1 + 4 * len(fields)) + k * n * 4 * len(fields) + n * 4,
                s_n * (2 + len(fields))))
            out["pack_by_slot"]["ms"] = cuda_ms(lambda: pg.pack_by_slot(cand, fields, k), 20)
            out["pack_by_slot"]["plain_ms"] = cuda_ms(
                lambda: pg.pack_by_slot_ref(cand, fields, k), 5)
    return out


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


def first_calls(dev, path: str, name: str):
    """(args, kwargs) of the first call of ``pathtrace_hiz.<name>`` (its
    bounce 0) in one 1080p frame of ``path``, on the kernels."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe

    s, cfg, bde, glass = path_config(path)
    gb, cam = boxscene(H_FULL, W_FULL, dev, glass=glass)
    probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
    seen = []
    real = getattr(ph, name)

    def spy(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return real(*a, **kw)

    setattr(ph, name, spy)
    try:
        ph.trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), 99, back_depth_enabled=bde)
        torch.cuda.synchronize()
    finally:
        setattr(ph, name, real)
    return seen[0]


def r1_bound(n: int, n_links: float, table_words: int) -> dict:
    """R1's bound: per lane its ray state, slot counts and the 11 f32
    rows out; per link the three slot fields; the L2-resident pair table
    read from memory at most once."""
    table = min(n_links * 4, table_words * 4)
    return bound(n * (12 + 12 + 1 + 4) + n_links * 12 + table + n * 11 * 4,
                 n_links * STEP_OPS)


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

    # R1 on the headline frame's own bounce-0 inputs, K4 on the dual
    # frame's, each against its bound at those inputs.
    r1_a, r1_kw = first_calls(dev, "headline", "resolve_rounds")
    links = []
    ph.resolve_rounds_ref(*r1_a, **r1_kw, links_out=links)
    r1_b = r1_bound(r1_a[0].shape[1], float(links[0].sum()), r1_a[7].numel())
    r1_ms = cuda_ms(lambda: ph.resolve_rounds(*r1_a, **r1_kw), 20)
    k4_a, k4_kw = first_calls(dev, "dual", "schedule_pack_dual")
    n4 = k4_a[0].shape[0]
    k4_b = bound(n4 * (12 + 12 + 4 + 4 + 1 + 4 + 1) + n4 * (16 * 16 + 4)
                 + (k4_a[7].numel() + k4_a[8].numel()) * 4, n4 * 24 * STEP_OPS)
    k4_ms = cuda_ms(lambda: fs.schedule_pack_dual(*k4_a, **k4_kw), 20)
    print(f"phase 6 bounce-0 rays of the frames: R1 (headline, {r1_a[0].shape[1]} lanes, "
          f"{r1_kw['n_rounds']} rounds) {r1_ms:.4f} ms, bound {r1_b['bound_ms']:.4f} ms; K4 "
          f"(dual, {n4} lanes) {k4_ms:.4f} ms, bound {k4_b['bound_ms']:.4f} ms [{card}]")

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
    """(settings, cfg, back_depth_enabled, glass) of a main path."""
    from unitysspathtracingurp_tpu_torch.config import PTConfig

    if path == "dual":
        s = dual_settings(maximum_samples=512)
        return s, PTConfig(), int(s.accurate_thickness.value), True
    if path == "home":
        return headline_settings(), home_config(), 0, False
    if path == "extract":
        return (headline_settings(),
                dataclasses.replace(PTConfig.boxscene_headline(), pallas_extract=True), 0, False)
    return headline_settings(), PTConfig.boxscene_headline(), 0, False


def check_frame(h, w, dev, path: str):
    """Phase 4: one frame, kernels vs the plain path."""
    import torch

    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe
    from unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz import trace_frame_hiz
    from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

    s, cfg, bde, glass = path_config(path)
    gb, cam = boxscene(h, w, dev, glass=glass)
    probes = ProbeSet(probe0=constant_probe(PROBE, device=dev))
    fast = trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), 99, back_depth_enabled=bde)
    with plain_kernels():
        plain = trace_frame_hiz(gb, cam, probes, s, cfg, s.variants(), 99,
                                back_depth_enabled=bde)
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


def main_path(dev, card, path: str):
    """Phase 5: the Renderer at 1080p, offline; the launch counts are
    set to 0 just before the path and read just after it."""
    import torch

    from unitysspathtracingurp_tpu_torch.kernels.build import LAUNCHES
    from unitysspathtracingurp_tpu_torch.models.renderer import Renderer
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe
    from unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz import default_rounds
    from unitysspathtracingurp_tpu_torch.utils.metrics import mrays_per_sec

    s, cfg, _, glass = path_config(path)
    gb, cam = boxscene(H_FULL, W_FULL, dev, glass=glass)
    r = Renderer(s, H_FULL, W_FULL, cfg=cfg,
                 probes=ProbeSet(probe0=constant_probe(PROBE, device=dev)), device=dev)
    # Launches per frame: the home prefix runs on bounce 0 only, the
    # plain front half on the others; R1 once per bounce; the unfused
    # rounds launch K5 and K7 once per round.
    bounces = s.maximum_depth
    expect = dict.fromkeys(PATHS[path], bounces)
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
    rate = mrays_per_sec(H_FULL, W_FULL, 1, s.maximum_depth, dt, sky)
    name = {"dual": "dual (glass, refraction + DepthNormals)",
            "home": "home (headline + home prefix, hiz_home_round_cap 0.4)",
            "extract": "extract (headline + pallas_extract: unfused rounds, K5 + K7)",
            }.get(path, path)
    print(f"phase 5 {name} main path Renderer.render_frame OFFLINE {W_FULL}x{H_FULL} "
          f"{s.maximum_depth} bounces: {dt * 1e3:.3f} ms/frame (min {min(times) * 1e3:.3f}, "
          f"max {max(times) * 1e3:.3f}), {rate:.3f} Mrays/s, "
          f"samples {r.sample}, launches {launches} [{card}]")
    profile_frames(r, gb, cam, card, name)
    return launches


def profile_frames(r, gb, cam, card, name, frames=2):
    """Device time by kernel over ``frames`` more main-path frames
    (torch.profiler, CUPTI). Reports; never fails the smoke."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                r.render_frame(gb, cam)
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
    print(f"profile of {frames} {name} main-path frames: wall {wall_us / frames / 1e3:.3f} "
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

    stats = {}
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_dual_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_home_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for h, w in ((256, 256), (H_FULL, W_FULL)):
        stats.update(check_gather_kernels(h, w, dev, timing=(h, w) == (H_FULL, W_FULL)))
    for path in ("headline", "dual", "home"):
        for h, w in ((256, 256), (H_FULL, W_FULL)):
            check_frame(h, w, dev, path)
    check_home_march(dev)
    for path in ("headline", "dual"):
        for h, w in ((256, 256), (H_FULL, W_FULL)):
            check_extract_frame(h, w, dev, path)
    launches = {}
    for path in ("headline", "dual", "home", "extract"):
        counts = main_path(dev, card, path)
        for name in PATHS[path]:
            launches.setdefault(name, counts.get(name, 0))
    counts = diagnostic_report(dev, card)
    for name in ("broadcast_table_select", "pack_by_slot"):
        launches[name] = counts[name]

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
