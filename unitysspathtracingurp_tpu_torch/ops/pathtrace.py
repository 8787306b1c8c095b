"""Pass 0: per-pixel multi-bounce path tracing over the G-buffer.

The counterpart of ``unitysspathtracingurp_tpu.ops.pathtrace`` (its
``trace_frame``, ``evaluate_brdf``, between-bounce lane compaction and
the parity march ``ray_march``), with the ray march injected as
``march_fn``: the hiz march of ``ops/pathtrace_hiz.py`` or the parity
march here. ``brdf_lanes`` wraps kernel B1 (``csrc/brdf.cu``), each
bounce's BRDF after its draws; ``brdf_lanes_ref`` is its plain version.
``ray_march`` wraps kernel P1 (``csrc/ray_march.cu``);
``ray_march_ref`` is its plain PyTorch version, the masked fixed-trip
loop of the JAX ``ray_march``. The parity march is the HLSL
reference's own per-pixel shape and the oracle the hiz march is held
against.

Reference quirks the JAX package reproduces are reproduced here too:
the lobe roulette can terminate a path (``roulette < p`` per lobe), the
primary depth goes through LinearEyeDepth once per bounce
(``sceneDistance``), refraction's exit "absorption" is
exp(+albedo * max(dist, 2.5)) (PathTracing.hlsl:307), and every lane
advances the draw counter at every potential draw site.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..camera import (
    RAW_FAR_CLIP, linear_eye_depth, pixel_uv, world_from_uv_depth, world_to_ndc,
)
from ..gbuffer import flip_to_back, gather2d, hit_surface_from_gbuffer, uv_to_pixel
from ..gbuffer_packed import hit_surface_from_packed, pack_gbuffers
from ..utils.image import clamp_brightness_hsv
from . import brdf
from .brdf import dot3, norm3, normalize, saturate
from .envprobe import sample_reflection_probes
from .fused_schedule import f32
from .rng import draw, draw2, make_rng, sample_rng

REAL_EPS = 1.1920929e-07


class MarchResult(NamedTuple):
    hit: torch.Tensor  # (H, W) bool
    position: torch.Tensor  # (H, W, 3)
    distance: torch.Tensor  # (H, W)
    uv: torch.Tensor  # (H, W, 2)
    is_back_hit: torch.Tensor  # (H, W) bool


def march_depth_images(gb, variants):
    """The depth images the parity march reads, by layout (hlsl:79-98):
    (layer-1, opaque or None, back or None). The opaque layer is read
    under refraction, the back layer with backface textures and a back
    depth image; without either the march reads layer 1 alone."""
    back = gb.back_depth if variants.backface_textures and gb.back_depth is not None else None
    opaque = gb.depth if variants.support_refraction else None
    return gb.layer1_depth(), opaque, back


def march_large_step(settings, scene_distance):
    """The far-tier step (ref :55): an unclamped lerp toward 20 m with the
    scene distance, frozen per march call."""
    return settings.step_size + (20.0 - settings.step_size) * scene_distance * 0.001


def ray_march_ref(cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside, dither,
                  view_dir, scene_distance, alive, home_ok: bool = False,
                  steps_out: list | None = None) -> MarchResult:
    """Plain PyTorch version of P1: the masked fixed-trip RayMarching
    (PathTracing.hlsl:7-254) of the JAX ``ray_march`` (``pathtrace.py:
    79-333``), one masked update of every lane per step 1..maximum_steps.

    Lanes are the leading axes of ``ray_pos`` (the (H, W) pixel grid or
    the compacted (cap_n/128, 128) domain); ``inside``, ``dither`` and
    ``scene_distance`` broadcast to them. ``home_ok`` is accepted for the
    ``march_fn`` signature. ``steps_out``: a list that receives each
    lane's count of steps taken while active, (N,) int64 (what P1's
    loop runs per lane)."""
    lanes = ray_pos.shape[:-1]
    n = ray_pos[..., 0].numel()
    dev = ray_pos.device
    pos0 = ray_pos.reshape(n, 3)
    dirn = ray_dir.reshape(n, 3)
    inside = inside.expand(lanes).reshape(n)
    dither = dither.expand(lanes).reshape(n)
    large_step = march_large_step(settings, scene_distance).expand(lanes).reshape(n)
    active = alive.expand(lanes).reshape(n).clone()
    is_front = dot3(dirn, view_dir.reshape(n, 3)) <= 0.0
    vp = cam.view_proj
    layer1, opaque, back = march_depth_images(gb, variants)
    gh, gw = gb.height, gb.width
    texel_x, texel_y = f32(1.0 / gw), f32(1.0 / gh)
    th_inc = f32(cfg.marching_thickness * cfg.thickness_growth)

    def lin(raw):
        return linear_eye_depth(raw, cam.near, cam.far)

    def sign(x):
        # _fast_sign: -0.0 >= 0.0, so -0.0 has sign +1.
        return torch.where(x >= 0.0, 1.0, -1.0)

    step = torch.full((n,), f32(cfg.small_step_size), dtype=torch.float32, device=dev)
    th = torch.full((n,), f32(cfg.marching_thickness), dtype=torch.float32, device=dev)
    start_bin = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_p = pos0
    last_p = pos0
    last_ndc = world_to_ndc(vp, pos0)
    last_diff = torch.zeros(n, dtype=torch.float32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_pos = torch.zeros_like(pos0)
    hit_dist = torch.full((n,), REAL_EPS, dtype=torch.float32, device=dev)
    hit_uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    is_back_hit = torch.zeros(n, dtype=torch.bool, device=dev)
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    for i in range(1, settings.maximum_steps + 1):
        steps = steps + active.to(torch.int64)
        # Adaptive tier transitions (ref :44-58): a lane in its binary
        # search keeps its step.
        if i == cfg.max_small_step + 1:
            step = torch.where(start_bin, step, f32(cfg.medium_step_size))
            th = torch.full_like(th, f32(cfg.marching_thickness))
        if i == cfg.max_medium_step + 1:
            step = torch.where(start_bin, step, large_step)
            th = torch.full_like(th, f32(cfg.marching_thickness))

        # Advance (ref :61).
        advance = (step + step * dither)[:, None] * dirn
        ray_p = torch.where(active[:, None], ray_p + advance, ray_p)
        ndc = world_to_ndc(vp, ray_p)
        u, v, raw_z = ndc[:, 0], ndc[:, 1], ndc[:, 2]

        # Sub-pixel-movement skip (ref :67-68): step consumed, no test.
        if i <= cfg.max_medium_step:
            skip = (active & (torch.abs(u - last_ndc[:, 0]) < texel_x)
                    & (torch.abs(v - last_ndc[:, 1]) < texel_y))
        else:
            skip = no
        in_screen = (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
        exit_screen = active & ~skip & ~in_screen  # ref :75-77 break
        proc = active & ~skip & in_screen

        # Depth selection (ref :79-98).
        iy, ix = uv_to_pixel(ndc[:, :2], gh, gw)
        d_layer1 = gather2d(layer1, iy, ix)
        device_back = None
        if back is not None:
            d_back = gather2d(back, iy, ix)
            if opaque is not None:
                d_opaque = gather2d(opaque, iy, ix)
                device_depth = torch.where(inside == 1.0, d_back,
                                           torch.where(inside == 2.0, d_opaque, d_layer1))
                device_back = torch.where(inside == 1.0, d_opaque, d_back)
            else:
                device_depth = d_layer1
                device_back = d_back
        elif opaque is not None:
            device_depth = torch.where(inside != 0.0, gather2d(opaque, iy, ix), d_layer1)
        else:
            device_depth = d_layer1

        scene_depth = lin(device_depth)
        hit_depth = lin(raw_z)
        depth_diff = scene_depth - hit_depth  # ref :108

        # Backface thickness rules (ref :111-136).
        if device_back is not None:
            scene_back = lin(device_back)
            back_valid = (device_back != RAW_FAR_CLIP) & (scene_back >= scene_depth)
            back_diff = torch.where(back_valid, hit_depth - scene_back, depth_diff - th)
        else:
            scene_back, back_valid, back_diff = zero, no, zero

        # Binary search control (ref :138-163).
        is_back_search = ~is_front & (hit_depth > scene_back) & back_valid
        signed_diff = torch.where(is_back_search, back_diff, depth_diff)
        sgn = sign(signed_diff)
        cannot_bin = ((inside != 2.0) & ~start_bin
                      & torch.where(is_front, hit_depth > scene_back, hit_depth < scene_depth))
        start_bin = torch.where(proc, ~cannot_bin & (start_bin | (sgn == -1.0)), start_bin)
        halved = step * 0.5
        aligned = torch.where(sign(halved) == sgn, halved, -halved)
        step = torch.where(proc & start_bin, aligned, step)

        is_sky = device_depth == RAW_FAR_CLIP  # ref :166

        # Hit rules (ref :168-190); the step is post-halving (ref :182).
        hit_plain = (depth_diff <= 0.0) & (depth_diff >= -th) & ~is_sky
        if device_back is not None:
            hit_backed = ((depth_diff <= 0.0)
                          & (hit_depth <= torch.maximum(scene_back, scene_depth + step))
                          & ~is_sky)
            hit_ok = torch.where(back_valid, hit_backed, hit_plain)
            back_hit_now = back_valid & (hit_depth > scene_back) & (sgn > 0.0)
        else:
            hit_ok = hit_plain
            back_hit_now = no
        new_hit = proc & hit_ok

        # Hit interpolation (ref :199-214) where the sign flipped.
        denom = last_diff - signed_diff
        denom = torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        t = last_diff / denom
        lerped = last_p + (ray_p - last_p) * t[:, None]
        use_lerp = sgn != sign(last_diff)
        hp = torch.where(use_lerp[:, None], lerped, ray_p)
        hit_pos = torch.where(new_hit[:, None], hp, hit_pos)
        # The distance is from the un-interpolated position (ref :196).
        hit_dist = torch.where(new_hit, norm3(ray_p - pos0), hit_dist)
        hit_uv = torch.where(new_hit[:, None], ndc[:, :2], hit_uv)
        is_back_hit = torch.where(new_hit, back_hit_now, is_back_hit)

        # Exponential growth while unconverged (ref :239-246).
        grow = proc & ~hit_ok & ~start_bin
        step = torch.where(grow, step + step * f32(cfg.step_growth), step)
        th = torch.where(grow, th + th_inc, th)

        # Trailing updates (ref :248-251): skipped lanes keep their last_*.
        upd = proc & ~new_hit
        last_diff = torch.where(upd, signed_diff, last_diff)
        last_p = torch.where(upd[:, None], ray_p, last_p)
        last_ndc = torch.where(upd[:, None], ndc, last_ndc)

        hit = hit | new_hit
        active = active & ~exit_screen & ~new_hit

    if steps_out is not None:
        steps_out.append(steps)
    return MarchResult(
        hit=hit.reshape(lanes),
        position=hit_pos.reshape(lanes + (3,)),
        distance=hit_dist.reshape(lanes),
        uv=hit_uv.reshape(lanes + (2,)),
        is_back_hit=is_back_hit.reshape(lanes),
    )


def ray_march(cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside, dither, view_dir,
              scene_distance, alive, home_ok: bool = False) -> MarchResult:
    """The parity march with the JAX ``march_fn`` signature: P1's
    wrapper. CPU tensors: ``ray_march_ref``. CUDA tensors: kernel P1
    (``csrc/ray_march.cu``), or an exception; there is no fallback."""
    if ray_pos.device.type == "cpu":
        return ray_march_ref(cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside,
                             dither, view_dir, scene_distance, alive)
    from ..kernels.build import LAUNCHES, check, flag_bytes, load_library, require_cuda, stream_of
    from .fused_schedule import schedule_scalars

    lib = load_library()
    lanes = ray_pos.shape[:-1]
    n = ray_pos[..., 0].numel()
    layer1, opaque, back = march_depth_images(gb, variants)
    fl = torch.float32
    ins = [
        ray_pos.to(fl).reshape(n, 3).contiguous(), ray_dir.to(fl).reshape(n, 3).contiguous(),
        view_dir.to(fl).reshape(n, 3).contiguous(),
        inside.to(fl).expand(lanes).reshape(n).contiguous(),
        dither.to(fl).expand(lanes).reshape(n).contiguous(),
        march_large_step(settings, scene_distance).to(fl).expand(lanes).reshape(n).contiguous(),
        flag_bytes(alive.expand(lanes).reshape(n)),
        schedule_scalars(cam),
    ]
    images = [None if img is None else img.to(fl).contiguous() for img in (layer1, opaque, back)]
    require_cuda("ray_march", *ins, *[img for img in images if img is not None])
    if any(img is not None and img.shape != (gb.height, gb.width) for img in images):
        raise RuntimeError("ray_march: depth images must be (height, width) of the G-buffer")
    out = torch.empty((6, n), dtype=fl, device=ray_pos.device)
    flags = torch.empty((2, n), dtype=torch.uint8, device=ray_pos.device)
    rc = lib.sspt_ray_march(
        *[t.data_ptr() for t in ins],
        *[0 if img is None else img.data_ptr() for img in images],
        out.data_ptr(), flags.data_ptr(),
        n, gb.height, gb.width, settings.maximum_steps, cfg.max_small_step,
        cfg.max_medium_step, f32(cfg.small_step_size), f32(cfg.medium_step_size),
        f32(cfg.marching_thickness), f32(cfg.marching_thickness * cfg.thickness_growth),
        f32(cfg.step_growth), f32(1.0 / gb.width), f32(1.0 / gb.height),
        stream_of(out),
    )
    check(rc, "ray_march")
    LAUNCHES["ray_march"] += 1
    flags = flags.view(torch.bool)
    return MarchResult(
        hit=flags[0].reshape(lanes),
        position=out[0:3].t().reshape(lanes + (3,)),
        distance=out[3].reshape(lanes),
        uv=out[4:6].t().reshape(lanes + (2,)),
        is_back_hit=flags[1].reshape(lanes),
    )


class BRDFResult(NamedTuple):
    direction: torch.Tensor
    position: torch.Tensor
    energy: torch.Tensor
    radiance: torch.Tensor
    rng: object


def evaluate_brdf(cfg, variants, rng, ray_dir, ray_pos, energy, hit, surf, hit_pos,
                  hit_dist, primary_pos, probes) -> BRDFResult:
    """EvaluateBRDF (PathTracing.hlsl:256-383): on a hit, roulette-select
    one lobe (refraction where ``surf.ior != -1``, else specular or
    diffuse), update throughput and direction, return the hit's
    emission; on a miss, zero the throughput and return the probe.

    The refraction lobe (ref :282-310) exists only under the refraction
    variants: elsewhere no decode produces an ior, its probability is 0
    and the other lobes' arithmetic is the same. The RNG draws are the
    same (draw2, then draw) either way. After the draws and the probe
    lookup, ``brdf_lanes`` evaluates the lanes (kernel B1 on the card)."""
    random, rng = draw2(rng)
    roulette, rng = draw(rng)
    env = sample_reflection_probes(probes, ray_dir, primary_pos, mip_level=1.0)
    direction, position, new_energy, radiance = brdf_lanes(
        variants.support_refraction, cfg.use_disney_diffuse, ray_dir, ray_pos, energy, hit,
        surf, hit_pos, hit_dist, env, random, roulette)
    return BRDFResult(direction=direction, position=position, energy=new_energy,
                      radiance=radiance, rng=rng)


def brdf_lanes_ref(refr: bool, disney: bool, ray_dir, ray_pos, energy, hit, surf, hit_pos,
                   hit_dist, env, random, roulette):
    """B1's plain version: ``evaluate_brdf`` after its draws (``random``
    (..., 2), ``roulette``) and its probe lookup (``env`` (..., 3)), with
    the refraction lobe under ``refr`` and Burley diffuse under
    ``disney``. Returns (direction, position, energy, radiance), each
    (..., 3)."""
    view = -ray_dir
    ndotv = brdf.clamp_ndotv(dot3(surf.normal, view))
    spec_p = brdf.reflectivity_specular(torch.clamp(surf.specular, min=0.04))
    refract_p = None
    if refr:
        do_refraction = surf.ior != -1.0
        refract_p = torch.where(do_refraction, brdf.reflectivity_specular(surf.albedo),
                                torch.zeros_like(spec_p))
        spec_p = torch.where(do_refraction, 1.0 - refract_p, spec_p)
        diff_p = 1.0 - spec_p - refract_p
    else:
        diff_p = 1.0 - spec_p
    perceptual_roughness = 1.0 - surf.smoothness
    roughness = perceptual_roughness * perceptual_roughness
    frame = brdf.get_local_frame(surf.normal)

    spec_l, vdoth_s, _, weight_over_pdf = brdf.importance_sample_ggx_pdf(
        random, view, frame, roughness, ndotv
    )
    f_spec = brdf.f_schlick(surf.specular, vdoth_s)
    spec_energy_scale = (
        f_spec * weight_over_pdf[..., None]
        / torch.clamp(spec_p, min=1e-12)[..., None]
    )
    diff_l, ndotl_d, w_lambert = brdf.importance_sample_lambert(random, frame)
    if disney:
        ldotv = saturate(dot3(diff_l, view))
        diffuse_brdf = surf.albedo * brdf.disney_diffuse_no_pi(
            ndotv, ndotl_d, ldotv, perceptual_roughness
        )[..., None]
    else:
        diffuse_brdf = surf.albedo
    diff_energy_scale = (
        diffuse_brdf * w_lambert[..., None] / torch.clamp(diff_p, min=1e-12)[..., None]
    )

    # Lobe roulette, the reference's chain (ref :282, :311, :333): each
    # test is roulette < p_lobe, so a path can end though the
    # probabilities sum to one.
    sel_spec = (spec_p > 0.0) & (roulette < spec_p)
    if refract_p is not None:
        # Refraction lobe (ref :282-310): eta by the decoded inside state,
        # Fresnel picks refraction or mirror reflection, and the exit
        # "absorption" is exp(+albedo * max(dist, 2.5)) (ref :307).
        inside = surf.inside_object
        eta = torch.where(inside == 1.0, 1.0 / torch.clamp(surf.ior, min=1e-6), surf.ior)
        _, _, vdoth_r = brdf.sample_ggx_ndf(random, view, frame, roughness)
        fresnel = brdf.f_schlick_f90(0.04, torch.clamp(surf.smoothness, min=0.04), vdoth_r)
        refr_dir, refr_valid = brdf.refract(ray_dir, surf.normal, eta)
        use_refract_dir = refr_valid & (roulette > fresnel)
        refraction_dir = torch.where(use_refract_dir[..., None], refr_dir,
                                     brdf.reflect(ray_dir, surf.normal))
        inv_refract_p = (1.0 / torch.clamp(refract_p, min=0.001))[..., None]
        exit_gain = torch.exp(surf.albedo * torch.clamp(hit_dist, min=2.5)[..., None])
        refraction_energy_scale = torch.where(
            (inside == 2.0)[..., None],
            inv_refract_p * exit_gain,
            torch.where((inside == 1.0)[..., None], inv_refract_p * surf.albedo,
                        torch.ones_like(exit_gain)),
        )
        sel_refract = (refract_p > 0.0) & (roulette < refract_p)
        sel_spec = ~sel_refract & sel_spec
    sel_diff = ~sel_spec & (diff_p > 0.0) & (roulette < diff_p)
    new_dir = torch.where(sel_spec[..., None], spec_l, diff_l)
    scale = torch.where(
        sel_spec[..., None],
        spec_energy_scale,
        torch.where(sel_diff[..., None], diff_energy_scale,
                    torch.zeros_like(diff_energy_scale)),
    )
    if refract_p is not None:
        new_dir = torch.where(sel_refract[..., None], refraction_dir, new_dir)
        scale = torch.where(sel_refract[..., None], refraction_energy_scale, scale)
    new_energy = energy * scale

    hit3 = hit[..., None]
    return (torch.where(hit3, new_dir, ray_dir), torch.where(hit3, hit_pos, ray_pos),
            torch.where(hit3, new_energy, torch.zeros_like(new_energy)),
            torch.where(hit3, surf.emission, env))


def brdf_lanes(refr: bool, disney: bool, ray_dir, ray_pos, energy, hit, surf, hit_pos,
               hit_dist, env, random, roulette):
    """``brdf_lanes_ref``'s outputs. CPU tensors: the plain version. CUDA
    tensors: one launch of kernel B1 (``csrc/brdf.cu``), or an
    exception; there is no fallback. The lanes are ``ray_dir``'s leading
    axes; every input broadcasts to them and is read through its own
    strides (no copy for one or two lane axes), f32, the hit flag bool. ``surf.ior``,
    ``surf.inside_object`` and ``hit_dist`` are read only under
    ``refr``. The four outputs are views of one (4, lanes, 3) buffer."""
    if ray_dir.device.type == "cpu":
        return brdf_lanes_ref(refr, disney, ray_dir, ray_pos, energy, hit, surf, hit_pos,
                              hit_dist, env, random, roulette)
    from ..kernels.build import LAUNCHES, check, load_library, stream_of

    lib = load_library()
    lanes = ray_dir.shape[:-1]
    dev = ray_dir.device
    # B1's fields in its order (csrc/brdf.cu Field), each with its
    # component count (0: one value a lane).
    fields = (
        (ray_dir, 3), (ray_pos, 3), (energy, 3), (hit, 0), (surf.normal, 3),
        (surf.albedo, 3), (surf.specular, 3), (surf.smoothness, 0),
        (surf.ior if refr else None, 0), (surf.inside_object if refr else None, 0),
        (surf.emission, 3), (hit_pos, 3), (hit_dist if refr else None, 0), (env, 3),
        (random, 2), (roulette, 0),
    )
    cols = lanes[-1] if lanes else 1
    rows = lanes.numel() // cols if cols else 0
    desc, held = [], []  # held: a reshaped copy lives until the launch is queued
    for t, comps in fields:
        if t is None:
            desc += (0, 0, 0, 0)
            continue
        want = torch.bool if t is hit else torch.float32
        if t.device != dev or t.dtype != want:
            raise RuntimeError(f"brdf_lanes: needs {want} CUDA tensors on {dev}, got {t.dtype} "
                               f"on {t.device}")
        comp = (comps,) if comps else ()
        t = t.expand(lanes + comp)
        if len(lanes) != 2:
            t = t.reshape((rows, cols) + comp)
        held.append(t)
        st = t.stride()
        desc += (t.data_ptr(), st[0], st[1], st[2] if comps else 0)
    out = torch.empty((4,) + lanes + (3,), dtype=torch.float32, device=dev)
    if rows * cols:
        rc = lib.sspt_brdf((ctypes.c_longlong * len(desc))(*desc), out.data_ptr(), rows, cols,
                           int(refr), int(disney), stream_of(out))
        check(rc, "brdf")
        LAUNCHES["brdf"] += 1
    return out[0], out[1], out[2], out[3]


def compact_indices(alive_flat, cap_n: int):
    """Packing map for between-bounce lane compaction.

    Returns (src_idx, valid, n_drop, slots, keep): ``src_idx`` (cap_n,)
    maps each compact slot to its source lane (0 when unused), ``valid``
    flags slots that hold a lane, ``n_drop`` counts alive lanes past the
    capacity (dropped), ``slots`` maps source lanes to slots (where
    ``keep``), ``keep`` flags lanes carried over."""
    n = alive_flat.shape[0]
    dev = alive_flat.device
    slots = torch.cumsum(alive_flat.to(torch.int64), 0) - 1
    n_alive = slots[-1] + 1
    lane_ids = torch.arange(n, dtype=torch.int64, device=dev)
    keep = alive_flat & (slots < cap_n)
    tgt = torch.where(keep, slots, torch.full_like(slots, cap_n))
    src_idx = torch.zeros(cap_n + 1, dtype=torch.int64, device=dev)
    src_idx.scatter_(0, tgt, lane_ids)
    valid = torch.arange(cap_n, dtype=torch.int64, device=dev) < n_alive
    return src_idx[:cap_n], valid, torch.clamp(n_alive - cap_n, min=0), slots, keep


def compact_capacity(cap: float, n_full: int) -> int:
    return min(n_full, max(1024, -(-int(cap * n_full) // 1024) * 1024))


def apply_backface_normal_flip(surf, src, uv, is_back_hit, variants, back_depth_enabled):
    """Back-hit normal reversal (ref PathTracing.hlsl:219-232); ``src`` is
    the GBuffers or the PackedGBuffers the decode reads."""
    if not variants.backface_textures:
        return surf
    back_normal = None
    if back_depth_enabled == 2:
        iy, ix = uv_to_pixel(uv, src.height, src.width)
        back_normal = src.back_normal_at(lambda img: gather2d(img, iy, ix))
    return dataclasses.replace(surf, normal=torch.where(
        is_back_hit[..., None], flip_to_back(surf.normal, back_normal), surf.normal))


def trace_frame(gb, cam, probes, settings, cfg, variants, frame_index, march_fn,
                back_depth_enabled: int = 0, history_sample=None, rng_tables=None):
    """Pass 0 (PathTracing.hlsl:385-496; shader:114-147). Returns the
    traced radiance (H, W, 3); sky pixels return ``gb.emission`` and,
    with the forward-only variant, forward-only pixels their emission.
    ``back_depth_enabled`` is the ThicknessMode value (2 = DepthNormals).
    The RNG is Sobol-Owen under ``variants.sobol_owen``, else blue noise
    where ``rng_tables`` (``ops.blue_noise.BlueNoiseTables``) is given,
    as in the JAX package (the Renderer builds the tables under
    ``NoiseMethod.BLUE_NOISE``), else hashed.

    ``samples_per_pixel`` > 1 runs the samples one after another, each on
    the stream ``sample_rng`` gives it, and sums them in sample order:
    the JAX package's sample batch axis (``pathtrace.py:942-952``).

    Adaptive spp (ref :430-433; JAX ``pathtrace.py:687-695``): under
    temporal accumulation with a ``history_sample`` (H, W), a pixel whose
    primary surface is smooth (> 0.5) or whose history holds one sample
    takes max(ray_count_low_sample, spp) samples, the others spp. The
    frame runs that maximum of samples; sample s is active where s is
    below the pixel's ray count, and every contribution is scaled by the
    pixel's 1 / ray count, a per-lane column that lane compaction
    carries like the others."""
    dev = gb.device
    h, w = gb.height, gb.width
    uv = pixel_uv(h, w, device=dev)
    primary_raw = gb.layer1_depth() if variants.support_refraction else gb.depth
    is_background = primary_raw == RAW_FAR_CLIP
    position_ws = world_from_uv_depth(cam.inv_view_proj, uv, primary_raw)
    view_dir = normalize(cam.position - position_ws)
    rng = make_rng(h, w, frame_index, device=dev, tables=rng_tables,
                   sobol_owen=variants.sobol_owen)
    # Step-size dither (ref :390-401; the 0.2-range branch, as the JAX
    # package rebuilds it): one draw ahead of every sample's stream.
    if settings.dithering:
        dv, rng = draw(rng)
        dither = (dv * 0.2 - 0.1) * settings.dither_intensity
    else:
        dither = torch.zeros((h, w), dtype=torch.float32, device=dev)
    # The primary decode also runs the refraction state machine.
    primary_surf = hit_surface_from_gbuffer(
        gb, uv, torch.zeros((h, w), dtype=torch.float32, device=dev), variants,
        back_depth_enabled, direct=True)
    primary_dist = norm3(cam.position - position_ws)

    # Forward-only objects show their emission untraced (ref :435-441).
    forward_only = None
    traceable = ~is_background
    if variants.ignore_forward_objects:
        forward_only = (primary_surf.smoothness == 0.0) & ~is_background
        traceable = traceable & ~forward_only

    if cfg.use_packed_gbuffer:
        pgb = pack_gbuffers(gb)
        flip_src = pgb

        def decode_at(uv_, inside_):
            return hit_surface_from_packed(pgb, uv_, inside_, variants, back_depth_enabled)
    else:
        flip_src = gb

        def decode_at(uv_, inside_):
            return hit_surface_from_gbuffer(gb, uv_, inside_, variants, back_depth_enabled)

    spp = settings.samples_per_pixel
    adaptive = variants.temporal_accumulation and history_sample is not None
    if adaptive:
        boost = (primary_surf.smoothness > 0.5) | (history_sample == 1.0)
        max_spp = max(cfg.ray_count_low_sample, spp)
        ray_count = torch.where(boost, max_spp, spp).to(torch.float32)
        inv_ray_count = 1.0 / ray_count
    else:
        # 1 / ray count in f32, as the JAX package divides; 1 spp skips
        # the (exact) product by 1.
        max_spp = spp
        inv_ray_count = float(np.float32(1.0) / np.float32(spp)) if spp > 1 else None

    def sample_body(rng, s):
        """Path sample ``s`` for every pixel lane: its radiance, (H*W, 3)."""
        active = traceable & (s < ray_count) if adaptive else traceable
        # Bounce 0: shade the primary hit (ref :423-428).
        energy = torch.ones((h, w, 3), dtype=torch.float32, device=dev)
        res = evaluate_brdf(
            cfg, variants, rng,
            ray_dir=-view_dir,
            ray_pos=cam.position.expand(h, w, 3),
            energy=energy,
            hit=torch.ones((), dtype=torch.bool, device=dev).expand(h, w),
            surf=primary_surf,
            hit_pos=position_ws,
            hit_dist=primary_dist,
            primary_pos=position_ws,
            probes=probes,
        )
        rng = res.rng
        radiance = energy * res.radiance
        if adaptive:
            radiance = radiance * inv_ray_count[..., None]
        elif inv_ray_count is not None:
            radiance = radiance * inv_ray_count
        color = torch.where(active[..., None], radiance, torch.zeros_like(energy))
        energy = res.energy
        ray_dir = res.direction
        ray_pos = res.position
        inside = primary_surf.inside_object
        alive = active & torch.any(energy != 0.0, dim=-1)
        depth_quirk = primary_raw
        dither_b = dither
        irc_b = inv_ray_count

        n_full = h * w
        color_flat = color.reshape(n_full, 3)
        prim_pos_b, view_dir_b = position_ws, view_dir
        color_dom = None  # contributions accumulated in the compact domain
        unwind = []  # (parent color_dom, slots, keep) per compaction level

        for bounce in range(settings.maximum_depth):
            caps = cfg.compaction_caps
            if caps is not None:
                cap_n = compact_capacity(caps[min(bounce, len(caps) - 1)], n_full)
                cur_n = alive.numel()
                if cap_n < cur_n:
                    idx, valid, _, slots, keep = compact_indices(alive.reshape(cur_n), cap_n)
                    ch, cw = cap_n // 128, 128

                    def take(a, idx=idx, cur_n=cur_n, ch=ch, cw=cw):
                        flat = a.reshape((cur_n,) + a.shape[2:])
                        return flat[idx].reshape((ch, cw) + a.shape[2:])

                    def head(a, cur_n=cur_n, cap_n=cap_n, ch=ch, cw=cw):
                        """A lane-uniform column re-domained by a slice."""
                        return a.reshape(cur_n)[:cap_n].reshape(ch, cw)

                    ray_pos, ray_dir, energy = take(ray_pos), take(ray_dir), take(energy)
                    prim_pos_b, depth_quirk = take(prim_pos_b), take(depth_quirk)
                    rng = dataclasses.replace(rng, pix_x=take(rng.pix_x),
                                              pix_y=take(rng.pix_y))
                    # inside varies over lanes only under refraction, the
                    # dither only with step dithering.
                    inside = take(inside) if variants.support_refraction else head(inside)
                    dither_b = take(dither_b) if settings.dithering else head(dither_b)
                    if adaptive:
                        irc_b = take(irc_b)
                    view_dir_b = normalize(cam.position - prim_pos_b)
                    alive = valid.reshape(ch, cw)
                    unwind.append((color_dom, slots, keep))
                    color_dom = torch.zeros((cap_n, 3), dtype=torch.float32, device=dev)

            depth_quirk = linear_eye_depth(depth_quirk, cam.near, cam.far)
            march = march_fn(
                cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside, dither_b,
                view_dir_b, depth_quirk, alive,
                # Screen-ordered pixel-grid lanes (bounce 0, spp 1, not
                # compacted): the hiz march's home-prefix precondition.
                home_ok=(bounce == 0 and max_spp == 1 and tuple(ray_pos.shape[:2]) == (h, w)),
            )
            surf = decode_at(march.uv, inside)
            surf = apply_backface_normal_flip(
                surf, flip_src, march.uv, march.is_back_hit, variants, back_depth_enabled)
            hit_pos = march.position + surf.normal * cfg.ray_bias
            res = evaluate_brdf(
                cfg, variants, rng, ray_dir=ray_dir, ray_pos=ray_pos, energy=energy,
                hit=march.hit, surf=surf, hit_pos=hit_pos, hit_dist=march.distance,
                primary_pos=prim_pos_b, probes=probes,
            )
            rng = res.rng
            alive3 = alive[..., None]
            radiance = energy * res.radiance
            if adaptive:
                radiance = radiance * irc_b[..., None]
            elif inv_ray_count is not None:
                radiance = radiance * inv_ray_count
            contrib = torch.where(alive3, radiance, torch.zeros_like(energy))
            if color_dom is None:
                color_flat = color_flat + contrib.reshape(n_full, 3)
            else:
                color_dom = color_dom + contrib.reshape(color_dom.shape[0], 3)
            energy = torch.where(alive3, res.energy, energy)
            ray_dir = torch.where(alive3, res.direction, ray_dir)
            ray_pos = torch.where(alive3, res.position, ray_pos)
            if variants.support_refraction:
                inside = torch.where(alive & march.hit, surf.inside_object, inside)
            alive = alive & march.hit & torch.any(energy != 0.0, dim=-1)

            # Russian roulette (ref :481-493).
            stop_energy, rng = draw(rng)
            max_energy = torch.amax(energy, dim=-1)
            survive = max_energy >= stop_energy
            energy = torch.where(
                (alive & survive)[..., None],
                energy / torch.clamp(max_energy, min=1e-12)[..., None],
                energy,
            )
            alive = alive & survive

        # Unwind the compaction cascade through the inverse slot maps.
        for parent, slots, keep in reversed(unwind):
            gathered = color_dom[torch.clamp(slots, 0, color_dom.shape[0] - 1)]
            folded = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
            color_dom = folded if parent is None else parent + folded
        if color_dom is not None:
            color_flat = color_flat + color_dom
        return color_flat

    color_flat = sample_body(rng, 0)
    for s in range(1, max_spp):
        color_flat = color_flat + sample_body(sample_rng(rng, s, settings.maximum_depth), s)
    color = clamp_brightness_hsv(color_flat.reshape(h, w, 3), settings.maximum_intensity)
    if forward_only is not None:
        color = torch.where(forward_only[..., None], primary_surf.emission, color)
    return torch.where(is_background[..., None], gb.emission, color)
