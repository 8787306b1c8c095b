"""Bit-packed G-buffer: one uint32 word per G-buffer slot per pixel.

  pack0  albedo.rgb (unorm8 x3)  | materialFlags (u8)     [GBuffer0]
  pack1  gbuffer1.rgb (unorm8 x3)                         [GBuffer1]
  pack2  normal (oct 12+12)      | smoothness (unorm8)    [GBuffer2]
  pack3  emission (RGBE shared-exponent HDR)              [GBuffer3]

The reference's own render-target precision (PathTracingInput.hlsl:23-26).
Words are held in int64 tensors with values in [0, 2^32): torch's uint32
lacks shifts and comparisons on the CPU. The transparent and backface
words belong to ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import PTVariants
from .gbuffer import GBuffers, opaque_surface, uv_to_pixel
from .ops.envprobe import oct_decode, oct_encode


def _pack_unorm8(x, shift):
    q = torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.int64)
    return q << shift


def _unpack_unorm8(word, shift):
    return ((word >> shift) & 0xFF).to(torch.float32) / 255.0


def _pack_oct12(normal):
    uv = oct_encode(normal)
    q = torch.clamp(torch.round(uv * 4095.0), 0, 4095).to(torch.int64)
    return q[..., 0] | (q[..., 1] << 12)


def _unpack_oct12(word):
    u = (word & 0xFFF).to(torch.float32) / 4095.0
    v = ((word >> 12) & 0xFFF).to(torch.float32) / 4095.0
    return oct_decode(torch.stack([u, v], dim=-1))


def _pack_rgbe(rgb):
    peak = torch.amax(rgb, dim=-1)
    maxc = torch.clamp(peak, min=1e-32)
    e = torch.clamp(torch.ceil(torch.log2(maxc)), -64.0, 63.0)
    scale = torch.exp2(-e) * 255.0
    q = torch.clamp(torch.round(rgb * scale[..., None]), 0, 255).to(torch.int64)
    eb = e.to(torch.int64) + 64
    word = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (eb << 24)
    return torch.where(peak <= 0.0, torch.zeros_like(word), word)


def _unpack_rgbe(word):
    e = ((word >> 24) & 0xFF) - 64
    scale = torch.exp2(e.to(torch.float32)) / 255.0
    rgb = torch.stack(
        [(word & 0xFF), (word >> 8) & 0xFF, (word >> 16) & 0xFF], dim=-1
    ).to(torch.float32) * scale[..., None]
    return torch.where((word == 0)[..., None], torch.zeros_like(rgb), rgb)


@dataclasses.dataclass
class PackedGBuffers:
    packs: torch.Tensor  # (H, W, 4) int64 words [pack0..pack3]
    depth: torch.Tensor  # (H, W) raw reversed-Z

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]


def pack_gbuffers(gb: GBuffers) -> PackedGBuffers:
    """Dense encode of the opaque G-buffer layers."""
    pack0 = (
        _pack_unorm8(gb.albedo[..., 0], 0)
        | _pack_unorm8(gb.albedo[..., 1], 8)
        | _pack_unorm8(gb.albedo[..., 2], 16)
        | ((gb.material_flags.to(torch.int64) & 0xFF) << 24)
    )
    pack1 = (
        _pack_unorm8(gb.gbuffer1[..., 0], 0)
        | _pack_unorm8(gb.gbuffer1[..., 1], 8)
        | _pack_unorm8(gb.gbuffer1[..., 2], 16)
    )
    pack2 = _pack_oct12(gb.normal) | (
        torch.clamp(torch.round(gb.smoothness * 255.0), 0, 255).to(torch.int64) << 24
    )
    pack3 = _pack_rgbe(gb.emission)
    return PackedGBuffers(
        packs=torch.stack([pack0, pack1, pack2, pack3], dim=-1),
        depth=gb.depth,
    )


def hit_surface_from_packed(pgb: PackedGBuffers, uv, inside_object,
                            variants: PTVariants, direct: bool = False):
    """HitSurfaceDataFromGBuffer over the packed words: one 4-word fetch."""
    variants.check_supported()
    if direct:
        words = pgb.packs
    else:
        h, w = pgb.height, pgb.width
        iy, ix = uv_to_pixel(uv, h, w)
        words = pgb.packs.reshape(h * w, 4)[(iy * w + ix).clamp(0, h * w - 1)]
    w0, w1, w2, w3 = words[..., 0], words[..., 1], words[..., 2], words[..., 3]
    albedo = torch.stack(
        [_unpack_unorm8(w0, 0), _unpack_unorm8(w0, 8), _unpack_unorm8(w0, 16)], dim=-1
    )
    flags = (w0 >> 24) & 0xFF
    g1 = torch.stack(
        [_unpack_unorm8(w1, 0), _unpack_unorm8(w1, 8), _unpack_unorm8(w1, 16)], dim=-1
    )
    normal = _unpack_oct12(w2)
    smoothness = ((w2 >> 24) & 0xFF).to(torch.float32) / 255.0
    emission = _unpack_rgbe(w3)
    return opaque_surface(albedo, flags, g1, normal, smoothness, emission, inside_object)
