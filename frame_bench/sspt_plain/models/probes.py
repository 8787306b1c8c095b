"""Reflection-probe baking and per-frame selection (the C11 binder analog).

A numpy copy of ``unitysspathtracingurp_tpu.models.probes`` (that package
imports JAX, which the port's runtime does not have):

  * ``bake_probe`` renders an oct-mapped probe texture by casting rays
    through the analytic scene from the probe origin (emission plus one
    cosine-sampled diffuse bounce), the stand-in for Unity's baked
    probes, with its prefiltered mip chain;
  * ``closest_probes`` is the binder's per-frame choice of the two probes
    closest to the camera and their blend weight
    (PathTracingSetReflectionProbe.cs:49-83).

The rays are cast in host numpy (``models/scene.intersect_scene``); the
probes come back as the port's ``EnvProbe`` / ``ProbeSet`` on ``device``,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.envprobe import EnvProbe, ProbeSet, build_probe_mips
from .scene import Scene, intersect_scene


def _oct_grid_dirs(resolution: int) -> np.ndarray:
    """The direction of every texel of an oct-mapped texture."""
    t = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    u, v = np.meshgrid(t, t)
    f = np.stack([u, v], -1) * 2.0 - 1.0
    z = 1.0 - np.abs(f[..., 0]) - np.abs(f[..., 1])
    tt = np.clip(-z, 0.0, 1.0)
    xy = f + np.where(f >= 0.0, -tt[..., None], tt[..., None])
    d = np.concatenate([xy, z[..., None]], -1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32)).to(device)


def bake_probe(scene: Scene, position, resolution: int = 64, bounce_samples: int = 16,
               seed: int = 0, box_min=None, box_max=None, device="cuda") -> EnvProbe:
    """Bake an oct-mapped radiance probe at ``position``: the emission
    along each texel's direction plus a cosine-sampled diffuse bounce of
    ``bounce_samples`` rays (numpy ``default_rng(seed)``). With
    ``box_min`` / ``box_max`` the probe is box-projected."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(position, np.float32)
    dirs = _oct_grid_dirs(resolution).reshape(-1, 3)
    n = dirs.shape[0]
    origins = np.broadcast_to(pos, (n, 3)).astype(np.float32)
    prims = list(scene.primitives)
    mats = [p.material for p in prims]
    sky = np.asarray(scene.sky_color, np.float32)

    t, normal, idx = intersect_scene(prims, origins, dirs)
    hit = np.isfinite(t)
    radiance = np.where(hit[..., None], 0.0, sky).astype(np.float32)
    albedo = np.zeros((n, 3), np.float32)
    emis = np.zeros((n, 3), np.float32)
    for i, m in enumerate(mats):
        sel = hit & (idx == i)
        albedo[sel] = m.albedo
        emis[sel] = m.emission
    radiance += emis

    # One diffuse bounce, Monte Carlo over the hemisphere.
    hp = origins + dirs * np.where(hit, t, 0.0)[..., None] + normal * 1e-4
    bounce = np.zeros((n, 3), np.float32)
    for _ in range(bounce_samples):
        u1 = rng.random(n, np.float32)
        u2 = rng.random(n, np.float32)
        r = np.sqrt(u1)
        phi = 2 * np.pi * u2
        # A tangent frame around the hit normal.
        s = np.where(normal[..., 2] >= 0.0, 1.0, -1.0)
        a = -1.0 / (s + normal[..., 2])
        b = normal[..., 0] * normal[..., 1] * a
        tang = np.stack([1.0 + s * normal[..., 0] ** 2 * a, s * b, -s * normal[..., 0]], -1)
        bit = np.stack([b, s + normal[..., 1] ** 2 * a, -normal[..., 1]], -1)
        local = np.stack([r * np.cos(phi), r * np.sin(phi), np.sqrt(np.clip(1 - u1, 0, 1))], -1)
        d2 = local[..., 0:1] * tang + local[..., 1:2] * bit + local[..., 2:3] * normal
        t2, _, idx2 = intersect_scene(prims, hp, d2.astype(np.float32))
        hit2 = np.isfinite(t2)
        e2 = np.where(hit2[..., None], 0.0, sky).astype(np.float32)
        for i, m in enumerate(mats):
            e2[hit2 & (idx2 == i)] += m.emission
        bounce += e2
    radiance += np.where(hit[..., None], albedo * bounce / bounce_samples, 0.0)

    boxed = box_min is not None and box_max is not None
    texture = _f32(radiance.reshape(resolution, resolution, 3), device)
    return EnvProbe(
        texture=texture,
        hdr_mult=_f32(1.0, device),
        box_min=_f32(box_min if boxed else np.zeros(3), device),
        box_max=_f32(box_max if boxed else np.zeros(3), device),
        position=_f32(pos, device),
        box_projection=_f32(1.0 if boxed else 0.0, device),
        # The tracer samples mip 1 on every miss (PathTracingFallback.hlsl:306-318).
        mips=build_probe_mips(texture),
    )


def closest_probes(probes: Sequence[EnvProbe], positions: Sequence, camera_position,
                   device="cuda") -> ProbeSet:
    """Bind the two probes closest to the camera, with the blend weight
    d0 / (d0 + d1) / 2 (favouring the closest), as the binder does each
    frame; one probe binds alone. The probes move to ``device``."""
    cam = np.asarray(camera_position, np.float32)
    d = [float(np.linalg.norm(np.asarray(p, np.float32) - cam)) for p in positions]
    order = np.argsort(d)
    on = _f32(1.0, device)
    if len(probes) == 1:
        return ProbeSet(probe0=probes[order[0]], probe_set=on).to(device)
    d0, d1 = d[order[0]], d[order[1]]
    w = 0.0 if d0 + d1 == 0 else d0 / (d0 + d1) * 0.5
    return ProbeSet(probe0=probes[order[0]], probe1=probes[order[1]],
                    blend_weight=_f32(w, device), probe_set=on).to(device)
