"""World-space brute-force path tracer (numpy) — the end-to-end oracle.

Independent reimplementation of the same Monte Carlo estimator the
framework's screen-space tracer uses (lobe probabilities, GGX/cosine
sampling, Russian roulette — including the reference's lobe-roulette
termination quirk, see ops/pathtrace.py docstring), but traced against
the *analytic geometry* instead of the depth buffer. Converged images
from this tracer are the ground truth for end-to-end RMSE tests
(SURVEY.md §4): for scenes fully visible on screen, the screen-space
result must approach it.

Pure numpy, host-side, deliberately sharing no code with ops/brdf.py.
A copy of ``unitysspathtracingurp_tpu.models.groundtruth`` (which the
port cannot import: the JAX package's ``__init__`` imports JAX); the
camera is the port's ``Camera``, read on the host.
"""

from __future__ import annotations

import numpy as np

from .fixtures import primary_rays
from .scene import Scene, intersect_scene


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _onb(n):
    # Independent construction (Frisvad-style via sign trick).
    s = np.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = np.stack(
        [1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], axis=-1
    )
    bt = np.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t, bt


def _ggx_sample_h(u1, u2, alpha):
    cos_t = np.sqrt(np.clip((1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1), 0, 1))
    sin_t = np.sqrt(np.clip(1.0 - cos_t * cos_t, 0, 1))
    phi = 2.0 * np.pi * u2
    return np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], axis=-1)


def _smith_v(ndotl, ndotv, alpha):
    a2 = alpha * alpha
    lv = ndotl * np.sqrt((-ndotv * a2 + ndotv) * ndotv + a2)
    ll = ndotv * np.sqrt((-ndotl * a2 + ndotl) * ndotl + a2)
    return 0.5 / np.maximum(lv + ll, 1e-5)


def _schlick(f0, f90, u):
    return f0 + (f90 - f0) * (1.0 - u) ** 5


def path_trace(
    scene: Scene,
    cam,
    height: int,
    width: int,
    bounces: int = 1,
    spp: int = 256,
    seed: int = 0,
    use_disney: bool = True,
    visible_only: bool = False,
) -> np.ndarray:
    """Converged world-space render, (H, W, 3). ``bounces`` counts the
    indirect segments after the primary hit, matching the framework's
    maximum_depth semantics (total path length = bounces + 1).

    ``visible_only=True`` gives the **ideal screen-space** oracle: a
    bounce hit only counts if its hit point is visible in the camera
    depth buffer (on-screen and the nearest surface at its pixel);
    invisible hits become environment misses. This isolates the
    screen-space tracer's march fidelity from SSPT's inherent
    information limit (off-screen/occluded geometry cannot be hit).
    """
    rng = np.random.default_rng(seed)
    o0, d0 = primary_rays(cam, height, width)
    if visible_only:
        vp = cam.view_proj.detach().cpu().numpy()

        def _hit_visible(points, t_hit):
            clip = points @ vp[:3, :3].T + vp[:3, 3]
            w_h = points @ vp[3, :3] + vp[3, 3]
            in_front = w_h > 1e-6
            w_safe = np.where(in_front, w_h, 1.0)
            ndc = clip / w_safe[..., None]
            uvx = ndc[..., 0] * 0.5 + 0.5
            uvy = ndc[..., 1] * 0.5 + 0.5
            on_screen = in_front & (uvx > 0) & (uvx < 1) & (uvy > 0) & (uvy < 1)
            # Re-cast a primary ray at the hit point: visible iff this is
            # the nearest surface along the camera ray to it.
            cam_pos = cam.position.detach().cpu().numpy()
            to_hit = points - cam_pos
            dist = np.linalg.norm(to_hit, axis=-1)
            dirs = to_hit / np.maximum(dist[..., None], 1e-9)
            t_vis, _, _ = intersect_scene(list(scene.primitives),
                                          np.broadcast_to(cam_pos, points.shape).astype(np.float32),
                                          dirs.astype(np.float32))
            nearest = np.isfinite(t_vis) & (t_vis >= dist - 1e-3)
            del t_hit
            return on_screen & nearest
    else:
        _hit_visible = None
    n_rays = o0.shape[0]
    prims = list(scene.primitives)
    mats = [p.material for p in prims]
    sky = np.asarray(scene.sky_color, np.float32)

    accum = np.zeros((n_rays, 3), np.float32)

    for _ in range(spp):
        pos = o0.copy()
        direction = d0.copy()
        energy = np.ones((n_rays, 3), np.float32)
        alive = np.ones(n_rays, bool)

        for bounce in range(bounces + 1):
            t, normal, idx = intersect_scene(prims, pos, direction)
            hit = np.isfinite(t) & alive
            if _hit_visible is not None and bounce > 0:
                pts = pos + direction * np.where(np.isfinite(t), t, 0.0)[..., None]
                hit = hit & _hit_visible(pts, t)
            miss = alive & ~hit

            # Environment on miss (constant sky here).
            accum[miss] += energy[miss] * sky

            if not hit.any():
                break

            hp = pos + direction * np.where(np.isfinite(t), t, 0.0)[..., None]
            alb = np.zeros((n_rays, 3), np.float32)
            smooth = np.zeros(n_rays, np.float32)
            metal = np.zeros(n_rays, np.float32)
            spec = np.zeros((n_rays, 3), np.float32)
            emis = np.zeros((n_rays, 3), np.float32)
            for i, m in enumerate(mats):
                sel = hit & (idx == i)
                alb[sel] = m.albedo
                smooth[sel] = m.smoothness
                metal[sel] = m.metallic
                emis[sel] = m.emission
                spec[sel] = (
                    m.specular
                    if m.specular is not None
                    else tuple(
                        0.04 * (1 - m.metallic) + a * m.metallic for a in m.albedo
                    )
                )

            accum[hit] += (energy * emis)[hit]

            if bounce == bounces:
                break

            # One-lobe roulette with the reference's selection chain.
            view = -direction
            ndotv = np.maximum(np.sum(normal * view, axis=-1), 1e-4)
            spec_p = np.maximum(np.maximum(spec[..., 0], spec[..., 1]), spec[..., 2])
            spec_p = np.maximum(spec_p, 0.04)
            diff_p = 1.0 - spec_p
            roulette = rng.random(n_rays, np.float32)
            u1 = rng.random(n_rays, np.float32)
            u2 = rng.random(n_rays, np.float32)

            p_rough = 1.0 - smooth
            alpha = p_rough * p_rough  # linear roughness (ref convention)

            tangent, bitan = _onb(normal)

            def to_world(local):
                return (
                    local[..., 0:1] * tangent
                    + local[..., 1:2] * bitan
                    + local[..., 2:3] * normal
                )

            def to_local(wv):
                return np.stack(
                    [
                        np.sum(wv * tangent, -1),
                        np.sum(wv * bitan, -1),
                        np.sum(wv * normal, -1),
                    ],
                    axis=-1,
                )

            # Specular lobe.
            h = _ggx_sample_h(u1, u2, alpha * alpha)  # NDF alpha = roughness^2
            lv = to_local(view)
            vdoth = np.clip(np.sum(lv * h, -1), 0, 1)
            l_spec_local = -lv + 2.0 * vdoth[..., None] * h
            ndotl_s = np.clip(l_spec_local[..., 2], 0, 1)
            ndoth = h[..., 2]
            vis = _smith_v(ndotl_s, ndotv, alpha)
            w_spec = np.where(
                (alpha > 0.001) & (ndoth > 0),
                4.0 * vis * ndotl_s * vdoth / np.maximum(ndoth, 1e-12),
                1.0,
            )
            f = _schlick(spec, 1.0, vdoth[..., None])
            spec_scale = f * w_spec[..., None] / np.maximum(spec_p, 1e-12)[..., None]
            l_spec = to_world(l_spec_local)

            # Diffuse lobe (cosine).
            r = np.sqrt(u1)
            phi = 2 * np.pi * u2
            l_diff_local = np.stack(
                [r * np.cos(phi), r * np.sin(phi), np.sqrt(np.clip(1 - u1, 0, 1))],
                axis=-1,
            )
            l_diff = to_world(l_diff_local)
            ndotl_d = l_diff_local[..., 2]
            if use_disney:
                ldotv = np.clip(np.sum(l_diff * view, -1), 0, 1)
                fd90 = 0.5 + p_rough + p_rough * ldotv
                burley = (
                    _schlick(1.0, fd90, ndotl_d)
                    * _schlick(1.0, fd90, ndotv)
                    / 1.03571
                )
                dbrdf = alb * burley[..., None]
            else:
                dbrdf = alb
            diff_scale = dbrdf / np.maximum(diff_p, 1e-12)[..., None]

            sel_spec = hit & (roulette < spec_p)
            sel_diff = hit & ~sel_spec & (roulette < diff_p)
            killed = hit & ~sel_spec & ~sel_diff  # reference quirk

            direction = np.where(
                sel_spec[..., None], l_spec, np.where(sel_diff[..., None], l_diff, direction)
            )
            energy = np.where(
                sel_spec[..., None],
                energy * spec_scale,
                np.where(sel_diff[..., None], energy * diff_scale, energy),
            )
            pos = np.where(hit[..., None], hp + normal * 1e-4, pos)
            alive = hit & ~killed & (energy.max(axis=-1) > 0)

            # Russian roulette with survivor boost.
            stop = rng.random(n_rays, np.float32)
            max_e = energy.max(axis=-1)
            survive = max_e >= stop
            energy = np.where(
                (alive & survive)[..., None],
                energy / np.maximum(max_e, 1e-12)[..., None],
                energy,
            )
            alive &= survive

    img = accum / spp
    return img.reshape(height, width, 3)
