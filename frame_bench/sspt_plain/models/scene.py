"""Analytic scene description + intersection (host-side, numpy).

A copy of ``unitysspathtracingurp_tpu.models.scene``: importing that
package imports JAX, which the port's runtime does not have. Scenes are
lists of analytic primitives with PBR materials; ``fixtures.py``
ray-casts them into G-buffers. Everything here is host numpy; the
intersection is the pure-numpy path (the JAX package may also use its
optional native rasterizer, which agrees with it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class Material:
    """PBR material matching the reference's G-buffer semantics
    (metallic workflow by default; ``specular`` set => specular setup;
    ``ior`` set => refractive transparent, range [1, 3])."""

    albedo: tuple = (0.8, 0.8, 0.8)
    smoothness: float = 0.5
    metallic: float = 0.0
    specular: Optional[tuple] = None
    emission: tuple = (0.0, 0.0, 0.0)
    ior: Optional[float] = None

    @property
    def is_refractive(self) -> bool:
        return self.ior is not None


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: tuple
    radius: float
    material: Material
    two_sided = True  # spheres have backfaces


@dataclasses.dataclass(frozen=True)
class Quad:
    """One-sided rectangle: corner + two edge vectors; normal = e1 x e2
    normalized. Like Unity's plane primitives, it has no backface."""

    corner: tuple
    edge1: tuple
    edge2: tuple
    material: Material
    two_sided = False


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box (outward normals)."""

    box_min: tuple
    box_max: tuple
    material: Material
    two_sided = True


@dataclasses.dataclass
class Scene:
    primitives: Sequence
    sky_color: tuple = (0.0, 0.0, 0.0)

    def opaque(self):
        return [p for p in self.primitives if not p.material.is_refractive]

    def refractive(self):
        return [p for p in self.primitives if p.material.is_refractive]


# ---------------------------------------------------------------------------
# Vectorized ray-primitive intersection. origins/dirs: (N, 3) float32.
# Returns (t, normal) with t = +inf on miss. ``backface=True`` intersects
# back-facing surfaces instead (the front-cull rasterization analog,
# reference BackfaceDepthPass cs:1226-1328).
# ---------------------------------------------------------------------------


def _intersect_sphere(p: Sphere, o, d, backface):
    c = np.asarray(p.center, np.float32)
    oc = o - c
    b = np.sum(oc * d, axis=-1)
    cc = np.sum(oc * oc, axis=-1) - p.radius * p.radius
    disc = b * b - cc
    ok = disc >= 0.0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t_near = -b - sq
    t_far = -b + sq
    eps = 1e-4
    if backface:
        t = np.where(ok & (t_far > eps), t_far, INF)
    else:
        t = np.where(ok & (t_near > eps), t_near, INF)
        # Ray starting inside the sphere front-hits the far wall's inner
        # side only in backface mode; for front faces it misses.
    hit_p = o + d * t[..., None]
    n = (hit_p - c) / p.radius
    if backface:
        n = n  # geometric outward normal; caller flips as needed
    return t, n.astype(np.float32)


def _intersect_quad(p: Quad, o, d, backface):
    corner = np.asarray(p.corner, np.float32)
    e1 = np.asarray(p.edge1, np.float32)
    e2 = np.asarray(p.edge2, np.float32)
    n = np.cross(e1, e2)
    n = n / np.linalg.norm(n)
    denom = np.sum(d * n, axis=-1)
    facing = denom < 0.0  # front face when ray opposes the normal
    if backface:
        return np.full(o.shape[0], INF, np.float32), np.broadcast_to(
            n, o.shape
        ).astype(np.float32)
    t = np.sum((corner - o) * n, axis=-1) / np.where(
        np.abs(denom) < 1e-9, 1e-9, denom
    )
    hit_p = o + d * t[..., None]
    rel = hit_p - corner
    u = np.sum(rel * e1, axis=-1) / np.sum(e1 * e1)
    v = np.sum(rel * e2, axis=-1) / np.sum(e2 * e2)
    ok = facing & (t > 1e-4) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return np.where(ok, t, INF).astype(np.float32), np.broadcast_to(n, o.shape).astype(
        np.float32
    )


def _intersect_box(p: Box, o, d, backface):
    bmin = np.asarray(p.box_min, np.float32)
    bmax = np.asarray(p.box_max, np.float32)
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tsmall = np.minimum(t0, t1)
    tbig = np.maximum(t0, t1)
    tmin = tsmall.max(axis=-1)
    tmax = tbig.min(axis=-1)
    ok = tmax >= np.maximum(tmin, 0.0)
    t = np.where(backface, tmax, tmin)
    valid = ok & (t > 1e-4)
    t = np.where(valid, t, INF).astype(np.float32)
    hit_p = o + d * t[..., None]
    center = (bmin + bmax) / 2
    half = (bmax - bmin) / 2
    local = (hit_p - center) / half
    axis = np.argmax(np.abs(local), axis=-1)
    n = np.zeros_like(o)
    idx = np.arange(o.shape[0])
    n[idx, axis] = np.sign(local[idx, axis])
    return t, n.astype(np.float32)


def intersect_primitive(p, o, d, backface=False):
    if isinstance(p, Sphere):
        return _intersect_sphere(p, o, d, backface)
    if isinstance(p, Quad):
        return _intersect_quad(p, o, d, backface)
    if isinstance(p, Box):
        return _intersect_box(p, o, d, backface)
    raise TypeError(f"unknown primitive {type(p)}")


def intersect_scene(prims, o, d, backface=False):
    """Nearest hit over ``prims``. Returns (t, normal, prim_index);
    t = +inf, index = -1 on miss."""
    n_rays = o.shape[0]
    best_t = np.full(n_rays, INF, np.float32)
    best_n = np.zeros((n_rays, 3), np.float32)
    best_i = np.full(n_rays, -1, np.int32)
    for i, p in enumerate(prims):
        t, n = intersect_primitive(p, o, d, backface)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_n = np.where(closer[..., None], n, best_n)
        best_i = np.where(closer, i, best_i)
    return best_t, best_n, best_i


# ---------------------------------------------------------------------------
# Canonical scenes (fixture analogs of the reference's demo content, C14).
# ---------------------------------------------------------------------------

WHITE = Material(albedo=(0.78, 0.78, 0.78), smoothness=0.05)
RED = Material(albedo=(0.65, 0.06, 0.06), smoothness=0.05)
GREEN = Material(albedo=(0.12, 0.45, 0.12), smoothness=0.05)
# The reference's area light: Light.mat emission 5.161 (BoxScene.unity).
LIGHT = Material(albedo=(0.9, 0.9, 0.9), smoothness=0.05, emission=(5.161, 5.161, 5.161))
MIRROR = Material(albedo=(0.9, 0.9, 0.9), smoothness=0.95, metallic=1.0)
GLASS = Material(albedo=(0.95, 0.95, 0.95), smoothness=1.0, ior=1.45)


def build_box_scene(with_glass: bool = False, with_mirror: bool = True) -> Scene:
    """Cornell-box analog of the reference BoxScene (C14): colored walls,
    ceiling area light, a glossy-metal sphere, a diffuse box, optionally
    the IOR-1.45 glass sphere."""
    s = 3.0  # half-width
    h = 4.0  # height
    prims = [
        # floor (normal +y = e1 x e2)
        Quad((-s, 0, -s), (0, 0, 2 * s), (2 * s, 0, 0), WHITE),
        # ceiling (normal -y)
        Quad((-s, h, -s), (2 * s, 0, 0), (0, 0, 2 * s), WHITE),
        # back wall z=-s (normal +z)
        Quad((-s, 0, -s), (2 * s, 0, 0), (0, h, 0), WHITE),
        # left wall x=-s (normal +x)
        Quad((-s, 0, -s), (0, h, 0), (0, 0, 2 * s), RED),
        # right wall x=+s (normal -x)
        Quad((s, 0, -s), (0, 0, 2 * s), (0, h, 0), GREEN),
        # ceiling light (slightly below ceiling, normal -y)
        Quad((-1.0, h - 0.01, -1.0), (2.0, 0, 0), (0, 0, 2.0), LIGHT),
        # diffuse box
        Box((-1.9, 0.0, -1.9), (-0.4, 1.7, -0.6), WHITE),
    ]
    if with_mirror:
        prims.append(Sphere((1.35, 0.8, -0.9), 0.8, MIRROR))
    if with_glass:
        prims.append(Sphere((-0.1, 0.7, 0.9), 0.7, GLASS))
    return Scene(primitives=prims, sky_color=(0.0, 0.0, 0.0))


def build_classroom_scene() -> Scene:
    """Classroom-like interior (the reference's 'Classroom' demo is not
    redistributable, README.md:36-42 — this synthesizes an equivalent
    workload: a room with window light, desks, and a board)."""
    wall = Material(albedo=(0.65, 0.62, 0.55), smoothness=0.1)
    floor_m = Material(albedo=(0.45, 0.35, 0.25), smoothness=0.35)
    ceil_m = Material(albedo=(0.8, 0.8, 0.8), smoothness=0.05)
    desk = Material(albedo=(0.5, 0.33, 0.18), smoothness=0.45)
    board = Material(albedo=(0.05, 0.15, 0.08), smoothness=0.7)
    window = Material(albedo=(1, 1, 1), smoothness=0.0, emission=(6.0, 6.2, 6.8))
    lamp = Material(albedo=(1, 1, 1), smoothness=0.0, emission=(3.0, 3.0, 2.6))
    sx, h, sz = 4.0, 3.0, 5.0
    prims = [
        Quad((-sx, 0, -sz), (0, 0, 2 * sz), (2 * sx, 0, 0), floor_m),
        Quad((-sx, h, -sz), (2 * sx, 0, 0), (0, 0, 2 * sz), ceil_m),
        Quad((-sx, 0, -sz), (2 * sx, 0, 0), (0, h, 0), wall),  # back
        Quad((-sx, 0, -sz), (0, h, 0), (0, 0, 2 * sz), wall),  # left
        Quad((sx, 0, -sz), (0, 0, 2 * sz), (0, h, 0), wall),  # right
        # Window on the left wall (emissive daylight).
        Quad((-sx + 0.01, 1.0, -3.0), (0, 1.6, 0), (0, 0, 2.5), window),
        # Ceiling lamp strip.
        Quad((-0.4, h - 0.01, -3.5), (0.8, 0, 0), (0, 0, 4.0), lamp),
        # Blackboard on the back wall.
        Quad((-2.5, 1.0, -sz + 0.02), (5.0, 0, 0), (0, 1.5, 0), board),
    ]
    # Rows of desks.
    for rz in (-2.5, -0.5, 1.5):
        for rx in (-2.5, 0.0, 2.5):
            prims.append(Box((rx - 0.6, 0.0, rz - 0.4), (rx + 0.6, 0.75, rz + 0.4), desk))
    return Scene(primitives=prims, sky_color=(0.0, 0.0, 0.0))


