"""G-buffer container and the opaque surface decode
(HitSurfaceDataFromGBuffer, PathTracingUtilities.hlsl:115-211).

Images are (H, W, C) or (H, W) tensors with row 0 at the bottom; depth
holds raw reversed-Z device depth (0.0 = sky). The transparent, backface
and motion layers of the JAX ``GBuffers`` belong to the refraction /
backface variants and the real-time modes (ROADMAP Queue 1 items 9, 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import PTVariants

MATERIAL_FLAG_SPECULAR_SETUP = 8
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


def hit_surface_from_gbuffer(gb: GBuffers, uv, inside_object, variants: PTVariants,
                             direct: bool = False):
    """Material data at ``uv``; ``direct=True`` reads the images as they
    are (valid only when ``uv`` is the full pixel grid: the primary hit)."""
    variants.check_supported()
    if direct:
        fetch = lambda img: img  # noqa: E731
    else:
        iy, ix = uv_to_pixel(uv, gb.height, gb.width)
        fetch = lambda img: gather2d(img, iy, ix)  # noqa: E731
    return opaque_surface(
        fetch(gb.albedo), fetch(gb.material_flags), fetch(gb.gbuffer1),
        fetch(gb.normal), fetch(gb.smoothness), fetch(gb.emission),
        inside_object,
    )
