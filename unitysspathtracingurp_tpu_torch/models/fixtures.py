"""G-buffer fixtures: the host "rasterizer" for the analytic scenes.

A copy of the parts of ``unitysspathtracingurp_tpu.models.fixtures``
that the offline slices use (``rasterize_gbuffers`` for the opaque
G-buffer + depth, the backface depth + normals and the transparent
G-buffer + layer-1 depth; ``box_scene_camera``): the JAX package imports
JAX, which the port's runtime does not have. Primary rays are cast in
host numpy; the result is the port's ``GBuffers`` on ``device`` (the
card unless the caller asks for the CPU). The motion-vector layer is
ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import Camera, make_camera
from ..gbuffer import GBuffers, MATERIAL_FLAG_SPECULAR_SETUP, SURFACE_TYPE_REFRACTION
from .scene import Scene, intersect_scene


def _np_pixel_uv(h, w):
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    u = (np.arange(w, dtype=np.float32) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    return np.stack([uu, vv], axis=-1)


def _np_world_to_ndc(vp, p):
    clip = p @ vp[:3, :3].T + vp[:3, 3]
    w = p @ vp[3, :3] + vp[3, 3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    ndc = clip / w[..., None]
    return np.concatenate([ndc[..., :2] * 0.5 + 0.5, ndc[..., 2:3]], axis=-1)


def _np_world_from_uv_depth(ivp, uv, raw):
    clip = np.concatenate(
        [uv * 2.0 - 1.0, raw[..., None], np.ones_like(raw)[..., None]], axis=-1
    )
    hpos = clip @ ivp.T
    return hpos[..., :3] / hpos[..., 3:4]


def primary_rays(cam: Camera, h: int, w: int):
    """Camera origin + per-pixel unit directions, (H*W, 3) each."""
    ivp = cam.inv_view_proj.cpu().numpy()
    pos = cam.position.cpu().numpy()
    uv = _np_pixel_uv(h, w).reshape(-1, 2)
    pts = _np_world_from_uv_depth(ivp, uv, np.full(uv.shape[0], 0.5, np.float32))
    d = pts - pos
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(pos, d.shape).astype(np.float32)
    return o.copy(), d.astype(np.float32)


def _material_arrays(prims, idx, n_rays):
    alb = np.zeros((n_rays, 3), np.float32)
    g1 = np.zeros((n_rays, 3), np.float32)
    flags = np.zeros(n_rays, np.uint32)
    smooth = np.zeros(n_rays, np.float32)
    emis = np.zeros((n_rays, 3), np.float32)
    ior = np.full(n_rays, -1.0, np.float32)
    for i, p in enumerate(prims):
        m = p.material
        sel = idx == i
        alb[sel] = m.albedo
        smooth[sel] = m.smoothness
        emis[sel] = m.emission
        if m.specular is not None:
            g1[sel] = m.specular
            flags[sel] |= MATERIAL_FLAG_SPECULAR_SETUP
        else:
            g1[sel] = (m.metallic, 0.0, 0.0)
        if m.ior is not None:
            ior[sel] = m.ior
    return alb, g1, flags, smooth, emis, ior


def rasterize_gbuffers(scene: Scene, cam: Camera, height: int, width: int,
                       device="cuda", with_backface: bool = False) -> GBuffers:
    """Cast primary rays and assemble the GBuffers: the opaque pass, the
    backface pass when ``with_backface`` (two-sided primitives only;
    planes give the far sentinel, ref PathTracing.hlsl:119-130), and the
    transparent pass + layer-1 depth when the scene has refractive
    primitives."""
    h, w = height, width
    vp = cam.view_proj.cpu().numpy()
    o, d = primary_rays(cam, h, w)
    n_rays = o.shape[0]
    opaque = scene.opaque()
    t, normal, idx = intersect_scene(opaque, o, d)
    hit = np.isfinite(t)
    hit_p = o + d * np.where(hit, t, 1.0)[..., None]
    raw = np.where(hit, _np_world_to_ndc(vp, hit_p)[..., 2], 0.0).astype(np.float32)
    alb, g1, flags, smooth, emis, _ = _material_arrays(
        opaque, np.where(hit, idx, -1), n_rays)
    emis = np.where(hit[..., None], emis, np.asarray(scene.sky_color, np.float32))
    normal = np.where(hit[..., None], normal, 0.0)

    def img(a, ch=None):
        shape = (h, w) if ch is None else (h, w, ch)
        return torch.as_tensor(np.ascontiguousarray(a.reshape(shape))).to(device)

    gb = dict(
        albedo=img(alb.astype(np.float32), 3),
        material_flags=img(flags.astype(np.int64)),
        gbuffer1=img(g1.astype(np.float32), 3),
        normal=img(normal.astype(np.float32), 3),
        smoothness=img(smooth.astype(np.float32)),
        emission=img(emis.astype(np.float32), 3),
        depth=img(raw),
    )
    if with_backface:
        solid = [p for p in scene.primitives if p.two_sided]
        if solid:
            tb, nb, _ = intersect_scene(solid, o, d, backface=True)
            hitb = np.isfinite(tb)
            pb = o + d * np.where(hitb, tb, 1.0)[..., None]
            rawb = np.where(hitb, _np_world_to_ndc(vp, pb)[..., 2], 0.0)
            gb["back_depth"] = img(rawb.astype(np.float32))
            gb["back_normal"] = img(np.where(hitb[..., None], nb, 0.0).astype(np.float32), 3)
        else:
            gb["back_depth"] = img(np.zeros(n_rays, np.float32))
            gb["back_normal"] = img(np.zeros((n_rays, 3), np.float32), 3)
    refr = scene.refractive()
    if refr:
        tt, nt, it = intersect_scene(refr, o, d)
        hitt = np.isfinite(tt) & (tt < t)  # visible in front of the opaque hit
        t_alb, _, _, t_smooth, _, t_ior = _material_arrays(
            refr, np.where(hitt, it, -1), n_rays)
        gb["t_albedo"] = img(np.where(hitt[..., None], t_alb, 0.0).astype(np.float32), 3)
        gb["t_ior_raw"] = img(
            np.where(hitt, (t_ior - 0.921875) / 2.0, 0.0).astype(np.float32))
        gb["t_surface_type"] = img(
            np.where(hitt, SURFACE_TYPE_REFRACTION, 0).astype(np.int64))
        gb["t_normal"] = img(np.where(hitt[..., None], nt, 0.0).astype(np.float32), 3)
        gb["t_smoothness"] = img(np.where(hitt, t_smooth, 0.0).astype(np.float32))
        # Layer-1 depth: the nearer of the opaque and transparent hits
        # (the depth attachment after the transparent depth prepass).
        t1 = np.minimum(t, tt)
        hit1 = np.isfinite(t1)
        p1 = o + d * np.where(hit1, t1, 1.0)[..., None]
        raw1 = np.where(hit1, _np_world_to_ndc(vp, p1)[..., 2], 0.0)
        gb["depth_layer1"] = img(raw1.astype(np.float32))
    return GBuffers(**gb)


def box_scene_camera(height: int, width: int, jitter: float = 0.0, device="cuda") -> Camera:
    """Canonical BoxScene viewpoint: inside the open front of the box."""
    return make_camera(
        eye=[0.0 + jitter, 1.8, 6.5],
        target=[0.0, 1.5, 0.0],
        up=[0.0, 1.0, 0.0],
        fov_y=np.radians(50.0),
        aspect=width / height,
        near=0.1,
        far=100.0,
        device=device,
    )
