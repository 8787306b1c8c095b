"""Temporal reprojection denoiser (real-time accumulation, pass 1): kernel T1.

The counterpart of ``unitysspathtracingurp_tpu.ops.temporal`` (the
accumulationFrag of PathTracingDenoise.hlsl:111-294) in its direct-read
form (the JAX ``packed_temporal=False`` branch): each history texture is
read where it is needed, point-sampled (depth, emission) or bilinear
(color, sample count), at the motion-vector uv.

  * reprojection rejected on sky, off screen, beyond the world radius
    that the pixel footprint scales (Denoise.hlsl:8-19, 171-179) and on
    an emission change (:181-196);
  * rough branch (roughness > 0.5): linear accumulation n / (n + 1),
    capped at MAX_ACCUM_FRAME_NUM, then _TemporalIntensity (:200-238);
  * smooth branch: the neighborhood box with a velocity-scaled nudge,
    the virtual reprojection of the reflected hit (:94-98), the box clip
    of the history (:46-61) and the parallax-aware accumulation speed
    (:75-85).

The JAX quirks are kept: the hit distance of the virtual position is
length(positionWS), the distance from the world origin (:163), and the
weight^2 term of the unused Lottes feedback enters the roughness lerp.
With a bf16 history (the 11-bit HDR target), the history is widened to
f32 (exactly) before it is interpolated, and the luminance of the
history emission is taken in bf16 as the JAX package's weak-typed
constants make it: each product and sum rounded to bf16, with the
Rec.709 weights rounded to bf16.

``temporal_reproject`` runs ``temporal_reproject_ref``, T1's plain
version, on any device (this copy has no kernels). It fixes the order
of every f32 operation the port's kernel T1 follows (three-term sums
left to right, divisors as tensors, powers with tensor exponents).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..camera import RAW_FAR_CLIP, pixel_uv, world_from_uv_depth
from ..config import PTConfig
from ..gbuffer import GBuffers, SURFACE_TYPE_REFRACTION, gather2d
from ..utils.image import luminance
from .brdf import dot3, norm3, normalize, saturate
from .envprobe import sample_bilinear
from .fused_schedule import f32

LUMA = (0.2126729, 0.7151522, 0.0721750)


@dataclasses.dataclass
class TemporalState:
    """The history textures and the previous frame's camera
    (cs:739-764, 880-896)."""

    history_color: torch.Tensor  # (H, W, 3) f32 or bf16
    history_sample: torch.Tensor  # (H, W) f32
    history_depth: torch.Tensor  # (H, W) f32
    history_emission: torch.Tensor  # (H, W, 3) f32 or bf16
    prev_inv_view_proj: torch.Tensor  # (4, 4)
    prev_view_proj: torch.Tensor  # (4, 4)
    prev_camera_position: torch.Tensor  # (3,)

    @classmethod
    def create(cls, height: int, width: int, cam, dtype=torch.float32,
               device="cuda") -> "TemporalState":
        """Empty history; ``dtype`` is the color and emission history's
        (bf16 under the 11-bit HDR target), depth and count stay f32."""
        def zeros(*shape, dt=torch.float32):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(
            history_color=zeros(height, width, 3, dt=dtype),
            history_sample=zeros(height, width),
            history_depth=zeros(height, width),
            history_emission=zeros(height, width, 3, dt=dtype),
            prev_inv_view_proj=cam.inv_view_proj.to(device),
            prev_view_proj=cam.view_proj.to(device),
            prev_camera_position=cam.position.to(device),
        )


class TemporalResult(NamedTuple):
    color: torch.Tensor  # (H, W, 3) f32
    sample_count: torch.Tensor  # (H, W) f32


def _point(img, uv):
    """Nearest texel: floor(uv * size), then clamped to the image."""
    h, w = img.shape[0], img.shape[1]
    ix = torch.clamp(torch.floor(uv[..., 0] * w).to(torch.int64), 0, w - 1)
    iy = torch.clamp(torch.floor(uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return gather2d(img, iy, ix)


def _shift(img, dx: int, dy: int):
    """img at (x + dx, y + dy), clamped to the image."""
    h, w = img.shape[0], img.shape[1]
    iy = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[iy][:, ix]


def _luminance_bf16(rgb):
    """``luminance`` of a bf16 image as the JAX package computes it:
    bf16 weights, every product and sum rounded to bf16 (a product of
    two bf16 values is exact in f32, so one rounding gives the bf16
    product); returned widened to f32."""
    def r(t):
        return t.to(torch.bfloat16).float()

    c = [float(torch.tensor(v).to(torch.bfloat16)) for v in LUMA]
    x = rgb.float()
    return r(r(r(c[0] * x[..., 0]) + r(c[1] * x[..., 1])) + r(c[2] * x[..., 2]))


def _pow(x, exponent: float):
    """x ** exponent with the exponent as a tensor: torch special-cases
    some Python-number exponents, and a tensor exponent is one powf."""
    return torch.pow(x, torch.full_like(x, exponent))


def _spec_accum_speed(linear_roughness, nov, parallax, cfg: PTConfig):
    """GetSpecAccumSpeed (Denoise.hlsl:75-85)."""
    a = _pow(saturate(1.0 - nov), cfg.spec_accum_curve)
    b = 1.1 + linear_roughness * linear_roughness
    sensitivity = (b + a) / (b - a)
    power_scale = 1.0 + parallax * sensitivity
    f = 1.0 - torch.exp2(-200.0 * linear_roughness * linear_roughness)
    f = f * torch.pow(saturate(linear_roughness), cfg.spec_accum_base_power * power_scale)
    return float(cfg.max_accum_frame_num) * f


def _spec_dominant_factor(nov, linear_roughness):
    """GetSpecularDominantFactor (Denoise.hlsl:87-92)."""
    a = 0.298475 * torch.log(39.4115 - 39.0029 * linear_roughness)
    return saturate(_pow(saturate(1.0 - nov), 10.8649) * (1.0 - a) + a)


def _clip_to_aabb(history, minimum, maximum):
    """DirectClipToAABB (Denoise.hlsl:46-61): clip toward the box center."""
    center = 0.5 * (maximum + minimum)
    extents = torch.clamp(0.5 * (maximum - minimum), min=1e-12)
    offset = history - center
    unit = torch.abs(offset / extents)
    max_unit = torch.maximum(torch.maximum(unit[..., 0], unit[..., 1]), unit[..., 2])[..., None]
    clipped = center + offset / max_unit
    return torch.where(max_unit > 1.0, clipped, history)


def _guides(gb: GBuffers, support_refraction: bool):
    """Normal and smoothness: the transparent G-buffer's where the pixel
    is refractive (Denoise.hlsl:122-132)."""
    if not (support_refraction and gb.t_surface_type is not None):
        return gb.normal, gb.smoothness
    is_refr = gb.t_surface_type == SURFACE_TYPE_REFRACTION
    return (torch.where(is_refr[..., None], gb.t_normal, gb.normal),
            torch.where(is_refr, gb.t_smoothness, gb.smoothness))


def temporal_reproject_ref(current, gb: GBuffers, cam, state: TemporalState, emission,
                           cfg: PTConfig, temporal_intensity, pixel_spread_angle_tangent,
                           support_refraction: bool = False,
                           _decisions: dict | None = None) -> TemporalResult:
    """T1's plain version. ``_decisions``, when a dict, receives the
    per-pixel decisions: ``off_screen``, ``is_sky``, ``emission_rejected``
    and the branch decisions ``can_reproject``, ``rough_ok``,
    ``use_rough``."""
    h, w = current.shape[0], current.shape[1]
    dev = current.device
    uv = pixel_uv(h, w, device=dev)
    max_n = float(cfg.max_accum_frame_num)
    ti = f32(temporal_intensity)
    velocity = gb.motion if gb.motion is not None else torch.zeros(
        (h, w, 2), dtype=torch.float32, device=dev)
    prev_uv = uv - velocity

    prev_depth = _point(state.history_depth, prev_uv)
    prev_emis = _point(state.history_emission, prev_uv)
    history_sample = sample_bilinear(state.history_sample[..., None], prev_uv)[..., 0]
    prev_color_mv = sample_bilinear(state.history_color, prev_uv)

    device_depth = gb.layer1_depth()
    normal, smoothness = _guides(gb, support_refraction)
    roughness = 1.0 - smoothness

    is_sky = device_depth == RAW_FAR_CLIP
    off_screen = ((prev_uv[..., 0] > 1.0) | (prev_uv[..., 0] < 0.0)
                  | (prev_uv[..., 1] > 1.0) | (prev_uv[..., 1] < 0.0))
    can_reproject = ~(is_sky | off_screen)

    position = world_from_uv_depth(cam.inv_view_proj, uv, device_depth)
    prev_position = world_from_uv_depth(state.prev_inv_view_proj, prev_uv, prev_depth)
    view = normalize(cam.position - position)
    ndotv = torch.abs(dot3(normal, view))

    prev_view = normalize(state.prev_camera_position - prev_position)
    cosa = saturate(dot3(view, prev_view))
    parallax = (torch.sqrt(torch.clamp(1.0 - cosa * cosa, min=0.0))
                / torch.clamp(cosa, min=1e-6))

    parallel_footprint = f32(pixel_spread_angle_tangent) * norm3(position)
    real_footprint = parallel_footprint / torch.clamp(ndotv, min=cfg.projection_epsilon)
    max_radius = torch.clamp(real_footprint * cfg.max_pixel_tolerance,
                             min=cfg.max_reprojection_distance)
    radius = norm3(prev_position - position) / max_radius
    can_reproject = can_reproject & (radius <= 1.0)

    el = luminance(emission)
    pl = (_luminance_bf16(prev_emis) if prev_emis.dtype == torch.bfloat16
          else luminance(prev_emis))
    ediff = 1.0 - torch.abs(el - pl) / torch.clamp(torch.maximum(el, pl), min=0.2)
    ediff = ediff * ediff
    one = torch.ones_like(ediff)
    emission_diff = torch.where(can_reproject, ediff, one)
    emission_rejected = can_reproject & ~(emission_diff >= 0.5)
    can_reproject = can_reproject & ~emission_rejected

    # Rough branch (Denoise.hlsl:200-238).
    acc_rough = torch.where(history_sample >= max_n, torch.full_like(ediff, ti),
                            history_sample / (history_sample + 1.0))
    acc_rough = acc_rough * torch.clamp(emission_diff, min=0.1) * (1.0 - radius)
    rough_ok = can_reproject & (history_sample != 0.0)
    acc3 = acc_rough[..., None]
    rough_result = torch.where(rough_ok[..., None],
                               current * (1.0 - acc3) + prev_color_mv * acc3, current)
    count = torch.clamp(history_sample + 1.0, 0.0, max_n)
    rough_count = torch.where(rough_ok, count, one)

    # Smooth branch (Denoise.hlsl:239-288).
    top_left = _shift(current, -1, -1)
    bottom_right = _shift(current, 1, 1)
    corners = 4.0 * (top_left + bottom_right) - 2.0 * current
    color = torch.clamp(current, 0.0, cfg.clamp_max)
    average = (corners + color) / torch.full_like(color, 7.0)
    color_luma = luminance(color)
    average_luma = luminance(average)
    vel_len = torch.sqrt(velocity[..., 0] * velocity[..., 0] + velocity[..., 1] * velocity[..., 1])
    nudge_scale = 4.0 + (0.25 - 4.0) * saturate(vel_len * 100.0)
    nudge = (nudge_scale * torch.abs(average_luma - color_luma))[..., None]
    minimum = torch.minimum(bottom_right, top_left) - nudge
    maximum = torch.maximum(top_left, bottom_right) + nudge

    dominant = _spec_dominant_factor(ndotv, roughness)
    virtual_pos = position - view * (norm3(position) * dominant)[..., None]
    pm = state.prev_view_proj
    vx, vy, vz = virtual_pos[..., 0], virtual_pos[..., 1], virtual_pos[..., 2]
    clipx = vx * pm[0, 0] + vy * pm[0, 1] + vz * pm[0, 2] + pm[0, 3]
    clipy = vx * pm[1, 0] + vy * pm[1, 1] + vz * pm[1, 2] + pm[1, 3]
    clipw = vx * pm[3, 0] + vy * pm[3, 1] + vz * pm[3, 2] + pm[3, 3]
    wdiv = torch.where(torch.abs(clipw) < 1e-12, torch.full_like(clipw, 1e-12), clipw)
    virtual_uv = torch.stack([clipx / wdiv, clipy / wdiv], -1) * 0.5 + 0.5
    prev_color_virtual = sample_bilinear(state.history_color, virtual_uv)
    prev_clipped = _clip_to_aabb(prev_color_virtual, minimum, maximum)

    hist_luma = luminance(prev_clipped)
    diff = torch.abs(color_luma - hist_luma) / torch.clamp(
        torch.maximum(color_luma, hist_luma), min=0.2)
    weight = 1.0 - diff
    w2 = weight * weight
    eff_rough = torch.clamp(roughness, min=0.06) * (1.0 - w2)
    acc_spec = _spec_accum_speed(eff_rough, ndotv, parallax, cfg)
    n1 = history_sample + 1.0
    acc_spec = torch.where(n1 >= max_n, torch.full_like(acc_spec, ti),
                           saturate(torch.minimum(acc_spec, n1 / torch.full_like(n1, max_n))))
    blended = color + (prev_clipped - color) * acc_spec[..., None]
    smooth_result = torch.where(can_reproject[..., None],
                                torch.clamp(blended, 0.0, cfg.clamp_max), current)
    smooth_count = torch.where(can_reproject, count, one)

    use_rough = (roughness > cfg.roughness_accumulation_threshold) & (emission_diff > 0.5)
    if _decisions is not None:
        _decisions.update(off_screen=off_screen, is_sky=is_sky,
                          emission_rejected=emission_rejected, can_reproject=can_reproject,
                          rough_ok=rough_ok, use_rough=use_rough)
    return TemporalResult(
        color=torch.where(use_rough[..., None], rough_result, smooth_result),
        sample_count=torch.where(use_rough, rough_count, smooth_count),
    )


def temporal_reproject(current, gb: GBuffers, cam, state: TemporalState, emission,
                       cfg: PTConfig, temporal_intensity, pixel_spread_angle_tangent,
                       support_refraction: bool = False) -> TemporalResult:
    """One temporal accumulation step (the JAX ``temporal_reproject``):
    the denoised color and the new per-pixel sample count, by
    ``temporal_reproject_ref`` on any device."""
    return temporal_reproject_ref(current, gb, cam, state, emission, cfg,
                                  temporal_intensity, pixel_spread_angle_tangent,
                                  support_refraction)


