"""Edge-avoiding À-Trous spatial denoiser (shader pass 5): kernel A1.

The counterpart of ``unitysspathtracingurp_tpu.ops.atrous`` (the inline
pass of ScreenSpacePathTracing.shader:421-639). One iteration is a
9-tap 3x3 Gaussian at a per-pixel dilation radius floor(3 + 6 hash),
with joint-bilateral weights from the color, emission, normal and
sqrt-albedo differences (exponents 1.1 / 2000 / 20 / 400), gated by
the history sample count (the blur amount, remapped 1 - (1 - b)^4).
Sky pixels and pixels whose blur amount is 0 pass through. With
refraction, a refractive pixel takes its guides from the transparent
G-buffer where that layer is non-zero, and drops the emission weight.

Each tap reads its texel at the pixel's own radius, clamped to the
image: the JAX package's select over seven static shifts
(``atrous.py:101-125``) is a TPU-only workaround for per-tap gathers
and gives the same texels.

``atrous_filter`` runs ``atrous_filter_ref``, A1's plain version, on any
device (this copy has no kernels). It fixes the order of every f32
operation the port's kernel A1 follows: channel sums as
(x*x + y*y) + z*z, exponents as products, the weight product left to
right, the taps summed in order.
"""

from __future__ import annotations

import torch

from ..camera import RAW_FAR_CLIP
from ..config import PTConfig
from ..gbuffer import GBuffers, SURFACE_TYPE_REFRACTION
from .brdf import dot3
from .fused_schedule import f32
from .rng import hashed_random_float

OFFSETS = ((-1, -1), (0, -1), (1, -1), (-1, 0), (0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))
KERNEL = (0.0625, 0.125, 0.0625, 0.125, 0.25, 0.125, 0.0625, 0.125, 0.0625)


def dilation_radius(height: int, width: int, row_offset: int, device):
    """The per-pixel radius floor(3 + 6 hash(x, y + row_offset, 1)),
    (H, W) int64 in 3..9; ``row_offset`` is the image row of row 0."""
    xs = torch.arange(width, dtype=torch.int64, device=device)
    ys = torch.arange(height, dtype=torch.int64, device=device) + int(row_offset)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    rnd = hashed_random_float(px, py, 1)
    return torch.floor(3.0 + 6.0 * rnd).to(torch.int64)


def blur_amount(sample_count, cfg: PTConfig):
    """The blur gate 1 - saturate(min(n / N, N) - 1 / N) (shader:493-495)."""
    max_n = float(cfg.max_accum_frame_num)
    ratio = sample_count / torch.full_like(sample_count, max_n)
    return 1.0 - torch.clamp(torch.clamp(ratio, max=max_n) - f32(1.0 / max_n), 0.0, 1.0)


def _guides(gb: GBuffers, refr: bool):
    """(normal, albedo, emission-weight flag) images: under refraction a
    refractive texel takes the transparent normal / albedo where that
    layer is non-zero, and its own emission weight is dropped."""
    if not refr:
        return gb.normal, gb.albedo, None
    is_refr = gb.t_surface_type == SURFACE_TYPE_REFRACTION
    t_norm = is_refr & torch.any(gb.t_normal != 0.0, dim=-1)
    t_alb = is_refr & torch.any(gb.t_albedo != 0.0, dim=-1)
    normal = torch.where(t_norm[..., None], gb.t_normal, gb.normal)
    albedo = torch.where(t_alb[..., None], gb.t_albedo, gb.albedo)
    return normal, albedo, ~is_refr


def atrous_filter_ref(color, gb: GBuffers, emission, sample_count, cfg: PTConfig,
                      support_refraction: bool = False, row_offset: int = 0):
    """A1's plain version: one iteration, (H, W, 3) f32."""
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    blur = blur_amount(sample_count, cfg)
    inv = 1.0 - blur
    inv = inv * inv
    inv = inv * inv
    remapped = 1.0 - inv
    radius = dilation_radius(h, w, row_offset, dev)
    refr = support_refraction and gb.t_surface_type is not None
    normal, albedo, use_ew = _guides(gb, refr)
    ys = torch.arange(h, dtype=torch.int64, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    flat = [img.reshape(h * w, 3) for img in (color, emission, normal, albedo)]
    center_emission = emission if use_ew is None else torch.where(
        use_ew[..., None], emission, torch.zeros_like(emission))
    sqrt_albedo = torch.sqrt(torch.clamp(albedo, min=0.0))
    sum_color = torch.zeros_like(color)
    sum_weight = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for (dx, dy), k in zip(OFFSETS, KERNEL):
        iy = torch.clamp(ys + dy * radius, 0, h - 1)
        ix = torch.clamp(xs + dx * radius, 0, w - 1)
        q = iy * w + ix
        tap_color, tap_emission, tap_normal, tap_albedo = (img[q] for img in flat)
        d = color - tap_color
        color_w = torch.clamp(torch.exp(-dot3(d, d) * 1.1), max=1.0)
        d = center_emission - tap_emission
        emission_w = torch.clamp(torch.exp(-dot3(d, d) * 2000.0), max=1.0)
        if use_ew is not None:
            emission_w = torch.where(use_ew, emission_w, torch.ones_like(emission_w))
        d = normal - tap_normal
        normal_w = torch.clamp(torch.exp(-torch.clamp(dot3(d, d), min=0.0) * 20.0), max=1.0)
        d = sqrt_albedo - torch.sqrt(torch.clamp(tap_albedo, min=0.0))
        albedo_w = torch.clamp(torch.exp(-dot3(d, d) * 400.0), max=1.0)
        weight = color_w * emission_w * normal_w * albedo_w * k
        sum_color = sum_color + tap_color * weight[..., None]
        sum_weight = sum_weight + weight
    filtered = sum_color / torch.clamp(sum_weight, min=1e-12)[..., None]
    out = color + (filtered - color) * remapped[..., None]
    passthrough = (gb.layer1_depth() == RAW_FAR_CLIP) | (blur == 0.0)
    return torch.where(passthrough[..., None], color, out)


def atrous_filter(color, gb: GBuffers, emission, sample_count, cfg: PTConfig,
                  support_refraction: bool = False, row_offset: int = 0):
    """One edge-avoiding À-Trous iteration (the JAX ``atrous_filter``):
    ``emission`` is the frame's scene-color copy, ``sample_count`` the
    per-pixel history length (H, W) that gates the blur, ``row_offset``
    the image row of row 0 (the dilation hash sees image rows), by
    ``atrous_filter_ref`` on any device."""
    return atrous_filter_ref(color, gb, emission, sample_count, cfg,
                             support_refraction, row_offset)


