"""Camera model: matrices, reversed-Z depth, world/NDC transforms.

Same conventions as ``unitysspathtracingurp_tpu.camera``: right-handed
view space looking down -Z, reversed-Z raw depth in [0, 1] (1 = near,
0 = far = sky sentinel), uv in [0, 1]^2 with row 0 at the bottom.

The projections are the planar f32 expansion (explicit muls and adds),
never ``p @ vp.T``: a matrix product may run at reduced precision (TF32
on the card) and move u/v by texels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

RAW_FAR_CLIP = 0.0


@dataclasses.dataclass
class Camera:
    """One frame's camera. Every tensor is f32 on the frame's device."""

    position: torch.Tensor  # (3,)
    view: torch.Tensor  # (4, 4) world -> view
    proj: torch.Tensor  # (4, 4) view -> clip (reversed-Z)
    view_proj: torch.Tensor  # (4, 4)
    inv_view_proj: torch.Tensor  # (4, 4)
    near: torch.Tensor  # ()
    far: torch.Tensor  # ()

    def to(self, device) -> "Camera":
        return Camera(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def perspective_reversed_z(fov_y: float, aspect: float, near: float, far: float):
    f32 = torch.float32
    fy = 1.0 / torch.tan(torch.tensor(fov_y, dtype=f32) / 2.0)
    fx = fy / aspect
    n = torch.tensor(near, dtype=f32)
    f = torch.tensor(far, dtype=f32)
    a = n / (f - n)
    b = n * f / (f - n)
    proj = torch.zeros((4, 4), dtype=f32)
    proj[0, 0] = fx
    proj[1, 1] = fy
    proj[2, 2] = a
    proj[2, 3] = b
    proj[3, 2] = -1.0
    return proj


def look_at(eye, target, up):
    f32 = torch.float32
    eye = torch.as_tensor(np.asarray(eye, np.float32))
    target = torch.as_tensor(np.asarray(target, np.float32))
    up = torch.as_tensor(np.asarray(up, np.float32))
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(right, fwd)
    rot = torch.stack([right, true_up, -fwd])
    trans = -(rot @ eye)
    view = torch.eye(4, dtype=f32)
    view[:3, :3] = rot
    view[:3, 3] = trans
    return view


def make_camera(eye, target, up, fov_y, aspect, near, far, device="cuda") -> Camera:
    """Built in f32 on the CPU (full-precision matmul), then moved to
    ``device`` (the card unless the caller asks for the CPU)."""
    view = look_at(eye, target, up)
    proj = perspective_reversed_z(fov_y, aspect, near, far)
    view_proj = proj @ view
    cam = Camera(
        position=torch.as_tensor(np.asarray(eye, np.float32)),
        view=view,
        proj=proj,
        view_proj=view_proj,
        inv_view_proj=torch.linalg.inv(view_proj),
        near=torch.tensor(near, dtype=torch.float32),
        far=torch.tensor(far, dtype=torch.float32),
    )
    return cam.to(device)


def world_to_ndc(view_proj, position_ws):
    """World position(s) (..., 3) -> (u, v, raw_depth) (..., 3)."""
    m = view_proj
    x, y, z = position_ws[..., 0], position_ws[..., 1], position_ws[..., 2]
    clipx = x * m[0, 0] + y * m[0, 1] + z * m[0, 2] + m[0, 3]
    clipy = x * m[1, 0] + y * m[1, 1] + z * m[1, 2] + m[1, 3]
    clipz = x * m[2, 0] + y * m[2, 1] + z * m[2, 2] + m[2, 3]
    w = x * m[3, 0] + y * m[3, 1] + z * m[3, 2] + m[3, 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.stack(
        [clipx / w * 0.5 + 0.5, clipy / w * 0.5 + 0.5, clipz / w], dim=-1
    )


def world_from_uv_depth(inv_view_proj, uv, raw_depth):
    """Screen uv (..., 2) + raw depth (...) -> world position (..., 3)."""
    m = inv_view_proj
    nx = uv[..., 0] * 2.0 - 1.0
    ny = uv[..., 1] * 2.0 - 1.0
    d = raw_depth
    hx = nx * m[0, 0] + ny * m[0, 1] + d * m[0, 2] + m[0, 3]
    hy = nx * m[1, 0] + ny * m[1, 1] + d * m[1, 2] + m[1, 3]
    hz = nx * m[2, 0] + ny * m[2, 1] + d * m[2, 2] + m[2, 3]
    hw = nx * m[3, 0] + ny * m[3, 1] + d * m[3, 2] + m[3, 3]
    return torch.stack([hx / hw, hy / hw, hz / hw], dim=-1)


def depth_coeffs(near, far):
    """(zz, zw) of ``linear_eye_depth``: 1/z_eye = raw*zz + zw."""
    return 1.0 / near - 1.0 / far, 1.0 / far


def linear_eye_depth(raw_depth, near, far):
    zz, zw = depth_coeffs(near, far)
    return 1.0 / (raw_depth * zz + zw)


def pixel_uv(height: int, width: int, device):
    """Per-pixel uv grid (H, W, 2); row 0 = bottom of the image.

    Rounding. Eager JAX, and torch on the CPU, compute the IEEE quotient
    (x + 0.5) / n. Jitted JAX, which is how the JAX Renderer runs its
    steps, multiplies by the f32 reciprocal of the static n, which
    differs by an ulp for many x where n is not a power of two. Torch on
    the card does the same with a Python-number divisor. The divisors
    here are tensors on ``device``, so the card, the CPU and kernel T1
    all take the IEEE quotient and agree with each other bit for bit;
    uv is held against the JAX package at a tolerance, not bit for
    bit."""
    f32 = torch.float32

    def axis(n):
        i = torch.arange(n, dtype=f32, device=device) + 0.5
        return i / torch.full_like(i, float(n))

    vv, uu = torch.meshgrid(axis(height), axis(width), indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def pixel_spread_angle_tangent(fov_y: float, width: int, height: int) -> float:
    """_PixelSpreadAngleTangent = tan(fov / 2) * 2 / min(w, h)
    (ScreenSpacePathTracingAccumulation.cs:880-896)."""
    return math.tan(fov_y / 2.0) * 2.0 / min(width, height)
