"""Pass 0: per-pixel multi-bounce path tracing over the G-buffer.

A frozen copy of the port's plain path for the benchmark's reference:
the counterpart of ``unitysspathtracingurp_tpu.ops.pathtrace`` (its
``trace_frame``, ``evaluate_brdf`` and between-bounce lane compaction),
with the ray march injected as ``march_fn`` (the hiz march of
``ops/pathtrace_hiz.py``; the parity march is not copied). Only the
hashed RNG is copied: the samplers raise.

Reference quirks the JAX package reproduces are reproduced here too:
the lobe roulette can terminate a path (``roulette < p`` per lobe), the
primary depth goes through LinearEyeDepth once per bounce
(``sceneDistance``), refraction's exit "absorption" is
exp(+albedo * max(dist, 2.5)) (PathTracing.hlsl:307), and every lane
advances the draw counter at every potential draw site.
"""

from __future__ import annotations

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


def march_large_step(settings, scene_distance):
    """The far-tier step (ref :55): an unclamped lerp toward 20 m with the
    scene distance, frozen per march call."""
    return settings.step_size + (20.0 - settings.step_size) * scene_distance * 0.001


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
    same (draw2, then draw) either way."""
    view = -ray_dir
    ndotv = brdf.clamp_ndotv(dot3(surf.normal, view))
    spec_p = brdf.reflectivity_specular(torch.clamp(surf.specular, min=0.04))
    refract_p = None
    if variants.support_refraction:
        do_refraction = surf.ior != -1.0
        refract_p = torch.where(do_refraction, brdf.reflectivity_specular(surf.albedo),
                                torch.zeros_like(spec_p))
        spec_p = torch.where(do_refraction, 1.0 - refract_p, spec_p)
        diff_p = 1.0 - spec_p - refract_p
    else:
        diff_p = 1.0 - spec_p
    perceptual_roughness = 1.0 - surf.smoothness
    roughness = perceptual_roughness * perceptual_roughness

    random, rng = draw2(rng)
    frame = brdf.get_local_frame(surf.normal)
    roulette, rng = draw(rng)

    spec_l, vdoth_s, _, weight_over_pdf = brdf.importance_sample_ggx_pdf(
        random, view, frame, roughness, ndotv
    )
    f_spec = brdf.f_schlick(surf.specular, vdoth_s)
    spec_energy_scale = (
        f_spec * weight_over_pdf[..., None]
        / torch.clamp(spec_p, min=1e-12)[..., None]
    )
    diff_l, ndotl_d, w_lambert = brdf.importance_sample_lambert(random, frame)
    if cfg.use_disney_diffuse:
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

    env = sample_reflection_probes(probes, ray_dir, primary_pos, mip_level=1.0)
    hit3 = hit[..., None]
    return BRDFResult(
        direction=torch.where(hit3, new_dir, ray_dir),
        position=torch.where(hit3, hit_pos, ray_pos),
        energy=torch.where(hit3, new_energy, torch.zeros_like(new_energy)),
        radiance=torch.where(hit3, surf.emission, env),
        rng=rng,
    )


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
                back_depth_enabled: int = 0, history_sample=None):
    """Pass 0 (PathTracing.hlsl:385-496; shader:114-147). Returns the
    traced radiance (H, W, 3); sky pixels return ``gb.emission`` and,
    with the forward-only variant, forward-only pixels their emission.
    ``back_depth_enabled`` is the ThicknessMode value (2 = DepthNormals).
    The RNG is the hashed one.

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
    if variants.blue_noise or variants.sobol_owen:
        raise ValueError("the blue-noise and Sobol-Owen samplers are not in this copy")
    rng = make_rng(h, w, frame_index, device=dev)
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
            hit=torch.ones((h, w), dtype=torch.bool, device=dev),
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
