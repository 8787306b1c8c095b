"""Reflection-probe fallback on ray miss (PathTracingFallback.hlsl:264-318).

Ported here: the oct mapping and the resolution-1 (constant-sky) probe
path that the offline BoxScene frame takes. Box projection, probe mips,
bilinear sampling of larger probes and the two-probe blend are ROADMAP
Queue 1 item 12; a probe that needs them raises ``NotImplementedError``.
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


def sample_probe(probe: EnvProbe, direction, position_ws, mip_level: float = 0.0):
    """One probe, resolution-1 path: the oct lookup lands on the single
    texel whatever the direction, so the result is its colour."""
    if probe.texture.shape[0] != 1 or probe.texture.shape[1] != 1:
        raise NotImplementedError(
            "probes above resolution 1 (bilinear oct sampling, box "
            "projection, mips): ROADMAP Queue 1 item 12"
        )
    color = probe.texture[0, 0].expand(direction.shape[:-1] + (3,))
    return color * probe.hdr_mult


def sample_reflection_probes(probes: ProbeSet, direction, position_ws, mip_level=1.0):
    """SampleReflectionProbes analog (PathTracingFallback.hlsl:306-318)."""
    if probes.probe1 is not None and probes.blend_weight is not None:
        raise NotImplementedError("two-probe blend: ROADMAP Queue 1 item 12")
    color = sample_probe(probes.probe0, direction, position_ws, mip_level)
    if probes.probe_set is not None:
        color = torch.where(probes.probe_set == 1.0, color, torch.zeros_like(color))
    if probes.is_probe_camera is not None:
        color = torch.where(probes.is_probe_camera == 1.0, color * 0.3, color)
    return color
