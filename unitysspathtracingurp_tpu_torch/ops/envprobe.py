"""Reflection-probe fallback on ray miss (PathTracingFallback.hlsl:264-318).

Up to two probes, each an octahedral-mapped 2D texture (the JAX
package's stand-in for a cubemap) with an optional box projection, an
HDR multiplier and a prefiltered mip chain; a blend weight between the
two, the ``_ProbeSet`` switch and the x0.3 damping of a probe camera.
Plain PyTorch, as in the JAX package (``ops/envprobe.py``).

A probe read at one mip level that is 1x1 (the constant sky) returns its
texel times the HDR multiplier without the lookup: the lookup direction
cannot change a 1x1 texture's bilinear read, so the value is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .brdf import norm3


def oct_encode(direction):
    """Unit direction -> octahedral uv in [0, 1]^2."""
    d = direction
    denom = (torch.abs(d[..., 0]) + torch.abs(d[..., 1])) + torch.abs(d[..., 2])
    p = d / torch.clamp(denom, min=1e-12)[..., None]
    xy = p[..., :2]
    sign = torch.where(xy >= 0.0, torch.ones_like(xy), -torch.ones_like(xy))
    folded = (1.0 - torch.abs(xy.flip(-1))) * sign
    xy = torch.where(p[..., 2:3] < 0.0, folded, xy)
    return xy * 0.5 + 0.5


def oct_decode(uv):
    """Octahedral uv in [0, 1]^2 -> unit direction."""
    f = uv * 2.0 - 1.0
    z = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-z, 0.0, 1.0)[..., None]
    xy = f + torch.where(f >= 0.0, -t, t)
    d = torch.cat([xy, z[..., None]], dim=-1)
    return d / torch.clamp(norm3(d), min=1e-12)[..., None]


@dataclasses.dataclass
class EnvProbe:
    texture: torch.Tensor  # (R, R, 3) oct-mapped HDR radiance
    hdr_mult: torch.Tensor  # ()
    box_min: torch.Tensor  # (3,)
    box_max: torch.Tensor  # (3,)
    position: torch.Tensor  # (3,)
    box_projection: torch.Tensor  # () 0.0 or 1.0
    mips: tuple = ()


@dataclasses.dataclass
class ProbeSet:
    probe0: EnvProbe
    probe1: Optional[EnvProbe] = None
    blend_weight: Optional[torch.Tensor] = None
    probe_set: Optional[torch.Tensor] = None
    is_probe_camera: Optional[torch.Tensor] = None

    def to(self, device) -> "ProbeSet":
        def mv(x):
            if x is None:
                return None
            if isinstance(x, EnvProbe):
                return EnvProbe(**{
                    f.name: (tuple(m.to(device) for m in x.mips) if f.name == "mips"
                             else getattr(x, f.name).to(device))
                    for f in dataclasses.fields(x)
                })
            return x.to(device)

        return ProbeSet(**{f.name: mv(getattr(self, f.name)) for f in dataclasses.fields(self)})


def constant_probe(color, resolution: int = 1, device="cuda") -> EnvProbe:
    color = torch.as_tensor(np.asarray(color, np.float32), device=device)
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return EnvProbe(
        texture=color.expand(resolution, resolution, 3).clone(),
        hdr_mult=torch.tensor(1.0, dtype=torch.float32, device=device),
        box_min=z3,
        box_max=z3.clone(),
        position=z3.clone(),
        box_projection=torch.tensor(0.0, dtype=torch.float32, device=device),
    )


def sample_bilinear(texture, uv):
    """Bilinear sample of an (H, W, C) texture at uv (clamp-to-edge):
    corner indices by ``floor`` of the clamped texel coordinate, corners
    widened to f32 and blended as the JAX package does (``envprobe.py:
    46-75``): each row across x, then the rows across y. A 1x1 texture
    broadcasts its texel."""
    h, w = texture.shape[0], texture.shape[1]
    if h == 1 and w == 1:
        return texture[0, 0].expand(uv.shape[:-1] + (texture.shape[-1],))
    x = torch.clamp(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    flat = texture.reshape(h * w, -1)

    def at(yy, xx):
        return flat[(yy * w + xx).clamp(0, h * w - 1)].float()

    top = at(y0, x0) * (1.0 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1.0 - fx) + at(y1, x1) * fx
    return top * (1.0 - fy) + bot * fy


def build_probe_mips(texture, n_mips: int = 4) -> tuple:
    """The prefiltered chain of an oct-mapped probe texture (JAX
    ``envprobe.py:124-145``): level 0 is ``texture``; each further level
    a 3x3 binomial blur with edge clamp (rows, then columns), then a 2x2
    box downsample, the four texels summed in XLA:CPU's order of the
    mean, ((top-left + top-right) + bottom-left) + bottom-right, and
    scaled by 0.25."""
    mips = [texture]
    t = texture
    for _ in range(n_mips - 1):
        if t.shape[0] < 2 or t.shape[1] < 2:
            break
        p = torch.cat([t[:1], t, t[-1:]], dim=0)
        t = (p[:-2] + 2.0 * p[1:-1] + p[2:]) * 0.25
        p = torch.cat([t[:, :1], t, t[:, -1:]], dim=1)
        t = (p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]) * 0.25
        h, w = t.shape[0] // 2 * 2, t.shape[1] // 2 * 2
        t = t[:h, :w]
        t = (((t[0::2, 0::2] + t[0::2, 1::2]) + t[1::2, 0::2]) + t[1::2, 1::2]) * 0.25
        mips.append(t)
    return tuple(mips)


def box_projected_direction(direction, position_ws, probe: EnvProbe):
    """Parallax-corrected lookup direction of a box-projected probe
    (PathTracingFallback.hlsl:271-276): the ray leaves the probe's box at
    the nearest face, re-aimed from the probe origin. A zero component
    (|d| < 1e-9) constrains nothing: its factor is +inf. The factors
    divide by a tensor, as on the card a division by a Python number
    would become a product with its reciprocal."""
    bounds = torch.where(direction > 0.0, probe.box_max, probe.box_min)
    zero = torch.abs(direction) < 1e-9
    d = torch.where(zero, torch.ones_like(direction), direction)
    factors = torch.where(zero, torch.full_like(direction, float("inf")),
                          (bounds - position_ws) / d)
    scalar = torch.amin(factors, dim=-1, keepdim=True)
    return direction * scalar + (position_ws - probe.position)


def _mip_texture(probe: EnvProbe, level: int):
    if not probe.mips:
        return probe.texture
    return probe.mips[min(level, len(probe.mips) - 1)]


def sample_probe(probe: EnvProbe, direction, position_ws, mip_level: float = 0.0):
    """One probe (JAX ``envprobe.py:166-181``): the box-projected or the
    plain direction, its oct uv, a bilinear read of mip ``int(mip_level)``
    and, for a fractional level of a probe with mips, a linear blend with
    the next level; times the HDR multiplier."""
    lo = int(mip_level)
    frac = float(mip_level) - lo
    levels = [_mip_texture(probe, lo)]
    if frac > 0.0 and probe.mips:
        levels.append(_mip_texture(probe, lo + 1))
    if len(levels) == 1 and tuple(levels[0].shape[:2]) == (1, 1):
        # One texel for every lane: a zero-stride view, no full-size copy.
        return (levels[0][0, 0] * probe.hdr_mult).expand(direction.shape[:-1] + (3,))
    projected = box_projected_direction(direction, position_ws, probe)
    lookup = torch.where(probe.box_projection > 0.0, projected, direction)
    uv = oct_encode(lookup)
    color = sample_bilinear(levels[0], uv)
    if len(levels) == 2:
        color = color * (1.0 - frac) + sample_bilinear(levels[1], uv) * frac
    return color * probe.hdr_mult


def sample_reflection_probes(probes: ProbeSet, direction, position_ws, mip_level=1.0):
    """SampleReflectionProbes analog (PathTracingFallback.hlsl:306-318):
    every ray miss samples mip 1 of the chain (the reference's constant
    lod); ``probe_set`` 0 turns the probe off, a positive ``blend_weight``
    blends in the second probe, and a probe camera's color is damped by
    0.3."""
    color = sample_probe(probes.probe0, direction, position_ws, mip_level)
    if probes.probe_set is not None:
        color = torch.where(probes.probe_set == 1.0, color, torch.zeros_like(color))
    if probes.probe1 is not None and probes.blend_weight is not None:
        color2 = sample_probe(probes.probe1, direction, position_ws, mip_level)
        w = probes.blend_weight
        color = torch.where(w > 0.0, color * (1.0 - w) + color2 * w, color)
    if probes.is_probe_camera is not None:
        color = torch.where(probes.is_probe_camera == 1.0, color * 0.3, color)
    return color
