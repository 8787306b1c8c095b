"""G-buffer container and the surface decode
(HitSurfaceDataFromGBuffer, PathTracingUtilities.hlsl:115-211).

Images are (H, W, C) or (H, W) tensors with row 0 at the bottom; depth
holds raw reversed-Z device depth (0.0 = sky). The transparent and
backface layers feed the refraction / backface variants; the motion
layer belongs to the real-time modes (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import PTVariants

MATERIAL_FLAG_SPECULAR_SETUP = 8
SURFACE_TYPE_REFRACTION = 2  # kSurfaceTypeRefraction (transparent G-buffer flag)
DIELECTRIC_SPEC = 0.04


@dataclasses.dataclass
class GBuffers:
    albedo: torch.Tensor  # (H, W, 3)
    material_flags: torch.Tensor  # (H, W) int64
    gbuffer1: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor  # (H, W, 3)
    smoothness: torch.Tensor  # (H, W)
    emission: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W) raw reversed-Z
    depth_layer1: Optional[torch.Tensor] = None  # depth incl. first transparent layer
    back_depth: Optional[torch.Tensor] = None  # (H, W) backface raw depth
    back_normal: Optional[torch.Tensor] = None  # (H, W, 3) backface normals
    t_albedo: Optional[torch.Tensor] = None  # (H, W, 3) TransparentGBuffer0.rgb
    t_ior_raw: Optional[torch.Tensor] = None  # (H, W) ior = raw * 2 + 0.921875
    t_surface_type: Optional[torch.Tensor] = None  # (H, W) int64
    t_normal: Optional[torch.Tensor] = None  # (H, W, 3)
    t_smoothness: Optional[torch.Tensor] = None  # (H, W)

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    @property
    def device(self):
        return self.depth.device

    def layer1_depth(self) -> torch.Tensor:
        return self.depth if self.depth_layer1 is None else self.depth_layer1

    def back_normal_at(self, fetch):
        """(back normal, has-normal flag) through ``fetch``; None without
        the layer."""
        if self.back_normal is None:
            return None
        bn = fetch(self.back_normal)
        return bn, torch.any(bn != 0.0, dim=-1)


@dataclasses.dataclass
class SurfaceData:
    albedo: torch.Tensor  # (..., 3)
    specular: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3)
    emission: torch.Tensor  # (..., 3)
    smoothness: torch.Tensor  # (...)
    ior: torch.Tensor  # (...), -1.0 == opaque
    inside_object: torch.Tensor  # (...)


def uv_to_pixel(uv, height: int, width: int):
    """Nearest texel of a [0, 1]^2 uv, clamped (point-clamp sampler)."""
    ix = torch.clamp(torch.floor(uv[..., 0] * width).to(torch.int64), 0, width - 1)
    iy = torch.clamp(torch.floor(uv[..., 1] * height).to(torch.int64), 0, height - 1)
    return iy, ix


def gather2d(img, iy, ix):
    """img[iy, ix] for index tensors of any shape."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape((h * w,) + img.shape[2:])
    idx = (iy * w + ix).clamp(0, h * w - 1)
    return flat[idx]


def opaque_surface(albedo, flags, g1, normal, smoothness, emission, inside_object):
    """Opaque-path surface from already fetched layers (ref :168-210)."""
    specular_setup = (flags & MATERIAL_FLAG_SPECULAR_SETUP) == MATERIAL_FLAG_SPECULAR_SETUP
    metallic = g1[..., 0:1]
    spec_from_metallic = DIELECTRIC_SPEC * (1.0 - metallic) + albedo * metallic
    specular = torch.where(specular_setup[..., None], g1, spec_from_metallic)
    return SurfaceData(
        albedo=albedo,
        specular=specular,
        normal=normal,
        emission=emission,
        smoothness=smoothness,
        ior=torch.full_like(smoothness, -1.0),
        inside_object=inside_object,
    )


def flip_to_back(normal, back_normal):
    """The normal a ray inside an object or hitting a back face sees: the
    negated back normal where the texel has one, else the negated normal
    (ref PathTracing.hlsl:219-232, PathTracingUtilities.hlsl:146-161).
    ``back_normal`` is ``back_normal_at``'s pair, or None."""
    if back_normal is None:
        return -normal
    bn, has_bn = back_normal
    return torch.where(has_bn[..., None], -bn, -normal)


def transparent_surface(surf: SurfaceData, inside_object, is_refractive, t_albedo,
                        t_ior, t_normal, t_smooth, back_normal):
    """The transparent path (ref :125-167) over already fetched layers:
    while the ray is not about to exit (insideObject != 2) a refractive
    texel replaces the opaque surface. A ray inside the object
    (insideObject == 1) sees ``flip_to_back`` of the transparent normal
    (ref :146-161). The state machine steps 0 -> 1 -> 2 -> 0 (ref :166)."""
    use_t = (inside_object != 2.0) & is_refractive
    t_normal = torch.where((inside_object == 1.0)[..., None],
                           flip_to_back(t_normal, back_normal), t_normal)
    use3 = use_t[..., None]
    stepped = torch.where(inside_object == 2.0, torch.zeros_like(inside_object),
                          inside_object + 1.0)
    return SurfaceData(
        albedo=torch.where(use3, t_albedo, surf.albedo),
        specular=torch.where(use3, torch.full_like(surf.specular, DIELECTRIC_SPEC),
                             surf.specular),
        normal=torch.where(use3, t_normal, surf.normal),
        emission=torch.where(use3, torch.zeros_like(surf.emission), surf.emission),
        smoothness=torch.where(use_t, t_smooth, surf.smoothness),
        ior=torch.where(use_t, t_ior, surf.ior),
        inside_object=torch.where(use_t, stepped, inside_object),
    )


def hit_surface_from_gbuffer(gb: GBuffers, uv, inside_object, variants: PTVariants,
                             back_depth_enabled: int = 0, direct: bool = False):
    """Material data at ``uv``; ``direct=True`` reads the images as they
    are (valid only when ``uv`` is the full pixel grid: the primary hit).
    The transparent path runs under refraction when the G-buffer has a
    transparent layer; ``back_depth_enabled == 2`` (DepthNormals) lets
    rays inside an object take the backface normal."""
    variants.check_supported()
    if direct:
        fetch = lambda img: img  # noqa: E731
    else:
        iy, ix = uv_to_pixel(uv, gb.height, gb.width)
        fetch = lambda img: gather2d(img, iy, ix)  # noqa: E731
    surf = opaque_surface(
        fetch(gb.albedo), fetch(gb.material_flags), fetch(gb.gbuffer1),
        fetch(gb.normal), fetch(gb.smoothness), fetch(gb.emission),
        inside_object,
    )
    if not (variants.support_refraction and gb.t_surface_type is not None):
        return surf
    back_normal = gb.back_normal_at(fetch) if back_depth_enabled == 2 else None
    return transparent_surface(
        surf, inside_object, fetch(gb.t_surface_type) == SURFACE_TYPE_REFRACTION,
        fetch(gb.t_albedo), fetch(gb.t_ior_raw) * 2.0 + 0.921875,
        fetch(gb.t_normal), fetch(gb.t_smoothness), back_normal,
    )
