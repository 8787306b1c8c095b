"""Bit-packed G-buffer: one uint32 word per G-buffer slot per pixel.

  pack0  albedo.rgb (unorm8 x3)  | materialFlags (u8)     [GBuffer0]
  pack1  gbuffer1.rgb (unorm8 x3)                         [GBuffer1]
  pack2  normal (oct 12+12)      | smoothness (unorm8)    [GBuffer2]
  pack3  emission (RGBE shared-exponent HDR)              [GBuffer3]
  t_pack0 t_albedo.rgb (unorm8 x3) | ior raw (unorm8)     [TGBuffer0/1]
  t_pack1 t_normal (oct 12+12)     | t_smoothness (u7) + refractive bit
  bn_pack back_normal (oct 12+12)  | has-normal bit

The reference's own render-target precision (PathTracingInput.hlsl:23-26).
Words are held in int64 tensors with values in [0, 2^32): torch's uint32
lacks shifts and comparisons on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from typing import Optional

from .config import PTVariants
from .gbuffer import (
    SURFACE_TYPE_REFRACTION, GBuffers, gather2d, opaque_surface, transparent_surface,
    uv_to_pixel,
)
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
    t_packs: Optional[torch.Tensor] = None  # (H, W, 2) int64 [t_pack0, t_pack1]
    bn_pack: Optional[torch.Tensor] = None  # (H, W) int64

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    def back_normal_at(self, fetch):
        """(back normal, has-normal bit) through ``fetch``; None without
        the word."""
        if self.bn_pack is None:
            return None
        bw = fetch(self.bn_pack)
        return _unpack_oct12(bw), (bw >> 31) == 1


def pack_gbuffers(gb: GBuffers) -> PackedGBuffers:
    """Dense encode of the G-buffer layers (transparent and backface
    normal words where the G-buffer has those layers).

    ``gb.normal`` is packed as a unit normal whatever the variant, as the
    JAX package packs it (``gbuffer_packed.py:135``): under the
    oct-normals variant it holds the oct-encoded rgb (u, v, 0), which
    ``oct_encode`` L1-normalises, so the packed decode reads the normal
    as normalize((u, v, 0)), not the oct decode of (u, v). The port
    keeps that reference behaviour (ROADMAP Queue 3, reference-side
    mismatches)."""
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
    kw = {}
    if gb.t_surface_type is not None:
        t_pack0 = (
            _pack_unorm8(gb.t_albedo[..., 0], 0)
            | _pack_unorm8(gb.t_albedo[..., 1], 8)
            | _pack_unorm8(gb.t_albedo[..., 2], 16)
            | _pack_unorm8(gb.t_ior_raw, 24)
        )
        refract_bit = (gb.t_surface_type == SURFACE_TYPE_REFRACTION).to(torch.int64)
        t_pack1 = (
            _pack_oct12(gb.t_normal)
            | (torch.clamp(torch.round(gb.t_smoothness * 127.0), 0, 127).to(torch.int64) << 24)
            | (refract_bit << 31)
        )
        kw["t_packs"] = torch.stack([t_pack0, t_pack1], dim=-1)
    if gb.back_normal is not None:
        has_bn = torch.any(gb.back_normal != 0.0, dim=-1).to(torch.int64)
        kw["bn_pack"] = _pack_oct12(gb.back_normal) | (has_bn << 31)
    return PackedGBuffers(
        packs=torch.stack([pack0, pack1, pack2, pack3], dim=-1),
        depth=gb.depth,
        **kw,
    )


def hit_surface_from_packed(pgb: PackedGBuffers, uv, inside_object,
                            variants: PTVariants, back_depth_enabled: int = 0,
                            direct: bool = False):
    """HitSurfaceDataFromGBuffer over the packed words: one 4-word fetch,
    plus one 2-word transparent fetch and one backface-normal word under
    refraction."""
    h, w = pgb.height, pgb.width
    if direct:
        fetch = lambda img: img  # noqa: E731
    else:
        iy, ix = uv_to_pixel(uv, h, w)
        fetch = lambda img: gather2d(img, iy, ix)  # noqa: E731
    words = fetch(pgb.packs)
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
    surf = opaque_surface(albedo, flags, g1, normal, smoothness, emission, inside_object,
                          forward_only=variants.ignore_forward_objects)
    if not (variants.support_refraction and pgb.t_packs is not None):
        return surf
    t_words = fetch(pgb.t_packs)
    tw0, tw1 = t_words[..., 0], t_words[..., 1]
    back_normal = pgb.back_normal_at(fetch) if back_depth_enabled == 2 else None
    return transparent_surface(
        surf, inside_object, (tw1 >> 31) == 1,
        torch.stack([_unpack_unorm8(tw0, 0), _unpack_unorm8(tw0, 8),
                     _unpack_unorm8(tw0, 16)], dim=-1),
        _unpack_unorm8(tw0, 24) * 2.0 + 0.921875,
        _unpack_oct12(tw1),
        ((tw1 >> 24) & 0x7F).to(torch.float32) / 127.0,
        back_normal,
    )
