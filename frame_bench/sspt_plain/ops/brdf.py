"""BRDF sampling and microfacet math (GGX, Smith, Schlick, Burley, Lambert).

The counterpart of ``unitysspathtracingurp_tpu.ops.brdf``. Roughness
arguments are linear roughness (perceptualRoughness^2); the GGX alpha is
roughness^2. Three-component sums are written out in the order the JAX
reference reduces them.
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def clamp_ndotv(ndotv):
    return torch.clamp(ndotv, min=1.0e-4)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(v):
    return torch.sqrt(dot3(v, v))


def normalize(v, eps=1e-12):
    return v / torch.clamp(norm3(v), min=eps)[..., None]


def pow5(x):
    """x**5 as XLA's integer_pow computes it: x * (x^2)^2."""
    x2 = x * x
    return x * (x2 * x2)


def reflect(incident, normal):
    return incident - 2.0 * dot3(incident, normal)[..., None] * normal


def refract(incident, normal, eta):
    """Snell refraction of a unit ``incident`` (into the surface).
    Returns (direction, valid); on total internal reflection the
    direction is zero and valid is False (HLSL refract()'s null vector,
    PathTracing.hlsl:293-303)."""
    cos_i = -dot3(incident, normal)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    valid = k >= 0.0
    d = eta[..., None] * incident + (eta * cos_i - torch.sqrt(torch.clamp(k, min=0.0)))[
        ..., None] * normal
    return torch.where(valid[..., None], d, torch.zeros_like(d)), valid


def get_local_frame(normal):
    """Branchless orthonormal basis (Duff et al. 2017)."""
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    sz = torch.where(z >= 0.0, torch.ones_like(z), -torch.ones_like(z))
    a = 1.0 / (sz + z)
    ya = y * a
    b = x * ya
    c = x * sz
    local_x = torch.stack([c * x * a - 1.0, sz * b, c], dim=-1)
    local_y = torch.stack([b, y * ya - sz, y], dim=-1)
    return local_x, local_y, normal


def to_world(local_vec, frame):
    fx, fy, fz = frame
    return (
        local_vec[..., 0:1] * fx + local_vec[..., 1:2] * fy + local_vec[..., 2:3] * fz
    )


def to_local(world_vec, frame):
    fx, fy, fz = frame
    return torch.stack(
        [dot3(world_vec, fx), dot3(world_vec, fy), dot3(world_vec, fz)], dim=-1
    )


def spherical_to_cartesian(phi, cos_theta):
    sin_theta = torch.sqrt(saturate(1.0 - cos_theta * cos_theta))
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def f_schlick(f0, u):
    """Schlick Fresnel with f90 = 1; ``f0`` may be (..., 3)."""
    x = pow5(1.0 - u)
    if torch.is_tensor(f0) and f0.dim() > u.dim():
        x = x[..., None]
    return f0 + (1.0 - f0) * x


def f_schlick_f90(f0, f90, u):
    x = pow5(1.0 - u)
    return f0 + (f90 - f0) * x


def v_smith_joint_ggx(ndotl, ndotv, roughness):
    a2 = roughness * roughness
    lambda_v = ndotl * torch.sqrt((-ndotv * a2 + ndotv) * ndotv + a2)
    lambda_l = ndotv * torch.sqrt((-ndotl * a2 + ndotl) * ndotl + a2)
    return 0.5 / torch.clamp(lambda_v + lambda_l, min=1e-5)


def disney_diffuse_no_pi(ndotv, ndotl, ldotv, perceptual_roughness):
    fd90 = 0.5 + (perceptual_roughness + perceptual_roughness * ldotv)
    light_scatter = f_schlick_f90(1.0, fd90, ndotl)
    view_scatter = f_schlick_f90(1.0, fd90, ndotv)
    return (1.0 / 1.03571) * light_scatter * view_scatter


def reflectivity_specular(specular_rgb):
    return torch.amax(specular_rgb, dim=-1)


def sample_ggx_cos_theta(u1, roughness):
    a = roughness * roughness
    denom = 1.0 + (a * a - 1.0) * u1
    return torch.sqrt(saturate((1.0 - u1) / torch.clamp(denom, min=1e-12)))


def sample_ggx_dir(u, view, frame, roughness):
    cos_theta = sample_ggx_cos_theta(u[..., 0], roughness)
    phi = TWO_PI * u[..., 1]
    local_h = spherical_to_cartesian(phi, cos_theta)
    ndoth = cos_theta
    local_v = to_local(view, frame)
    vdoth = saturate(dot3(local_v, local_h))
    local_l = -local_v + 2.0 * vdoth[..., None] * local_h
    ndotl = local_l[..., 2]
    light = to_world(local_l, frame)
    return light, ndotl, ndoth, vdoth


def sample_ggx_ndf(u, view, frame, roughness):
    """GGX microfacet normal only (PathTracingUtilities.hlsl:214-251):
    (H, NdotH, VdotH)."""
    cos_theta = sample_ggx_cos_theta(u[..., 0], roughness)
    local_h = spherical_to_cartesian(TWO_PI * u[..., 1], cos_theta)
    vdoth = saturate(dot3(to_local(view, frame), local_h))
    return to_world(local_h, frame), cos_theta, vdoth


def importance_sample_ggx_pdf(u, view, frame, roughness, ndotv):
    """GGX sample with weight-over-pdf (PathTracingUtilities.hlsl:253-280)."""
    light, ndotl, ndoth, vdoth = sample_ggx_dir(u, view, frame, roughness)
    ndotl = saturate(ndotl)
    vis = v_smith_joint_ggx(ndotl, ndotv, roughness)
    w = 4.0 * vis * ndotl * vdoth / torch.clamp(ndoth, min=1e-12)
    weight_over_pdf = torch.where(
        (roughness > 0.001) & (ndoth > 0.0), w, torch.ones_like(w)
    )
    return light, vdoth, ndotl, weight_over_pdf


def importance_sample_lambert(u, frame):
    """Cosine-weighted hemisphere sample: (L, NdotL, weightOverPdf=1)."""
    r = torch.sqrt(u[..., 0])
    phi = TWO_PI * u[..., 1]
    local_l = torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(saturate(1.0 - u[..., 0]))],
        dim=-1,
    )
    ndotl = local_l[..., 2]
    light = to_world(local_l, frame)
    return light, ndotl, torch.ones_like(ndotl)
