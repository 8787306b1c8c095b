"""Counter-based per-pixel RNG, hashed mode (PathTracingUtilities.hlsl:74-113).

The Jenkins one-at-a-time hash of (pixel, frame_index + draw counter),
turned into a float in [0, 1). Stateless, so no ``torch.Generator`` is
involved. uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks:
torch's ``uint32`` lacks add, shifts and comparisons on the CPU.

The draw counter (``seed``) is uniform over lanes (every potential draw
site advances it for every lane), so it is a Python int here; the JAX
package carries the same value in a per-pixel array.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import FRAME_INDEX_MOD, FRAME_INDEX_STRIDE

M32 = 0xFFFFFFFF


def jenkins_hash_u32(x):
    """Bob Jenkins' one-at-a-time hash of a uint32 (int64 tensor or int)."""
    x = x & M32
    x = (x + (x << 10)) & M32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & M32
    return x


def jenkins_hash_u32_3(x, y, z):
    """h(x ^ h(y ^ h(z)))."""
    return jenkins_hash_u32(x ^ jenkins_hash_u32(y ^ jenkins_hash_u32(z)))


def construct_float(m):
    """uint32 (int64 tensor) -> f32 in [0, 1): 23 mantissa bits in [1, 2), minus 1."""
    bits = (m & 0x007FFFFF) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


@dataclasses.dataclass
class RNG:
    pix_x: torch.Tensor  # (...) int64 pixel column
    pix_y: torch.Tensor  # (...) int64 pixel row
    frame_index: int
    seed: int  # draw counter, uniform over lanes


def make_rng(height: int, width: int, frame_index: int, device) -> RNG:
    xs = torch.arange(width, dtype=torch.int64, device=device)
    ys = torch.arange(height, dtype=torch.int64, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return RNG(pix_x=px, pix_y=py, frame_index=int(frame_index) & M32, seed=0)


def draw(rng: RNG):
    """One draw per lane: the counter increments, then the value is
    hash(pixel, frame_index + counter). Returns (value, new rng)."""
    seed = rng.seed + 1
    value = construct_float(
        jenkins_hash_u32_3(rng.pix_x, rng.pix_y, (rng.frame_index + seed) & M32)
    )
    return value, dataclasses.replace(rng, seed=seed)


def draw2(rng: RNG):
    a, rng = draw(rng)
    b, rng = draw(rng)
    return torch.stack([a, b], dim=-1), rng


def advance_frame_index(frame_index: int) -> int:
    return (frame_index + FRAME_INDEX_STRIDE) % FRAME_INDEX_MOD
