"""Tiled + hierarchical depth structures for the hiz march, plain layout.

  * ``pair_table`` (NP, 128): each row covers a pair of horizontally
    adjacent 16x8-texel tiles; word w holds texel w of the left tile's
    raw depth as f16 in its low half and the right tile's in its high
    half.
  * ``mini_table`` (chunks, 128): per 32x16-px minitile, the min/max
    linear eye depth (sky linearises to ``far``), conservatively
    rounded to f16, packed f16(min) | f16(max) << 16.

Both hold uint32 bit patterns in int32 tensors (the JAX package keeps
the same bits in f32 arrays). Bit-identical to
``unitysspathtracingurp_tpu.ops.depth_tiles.build_depth_tiles``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera import linear_eye_depth

TILE_W = 16
TILE_H = 8
MINI_TX = 2
MINI_TY = 2


@dataclasses.dataclass
class DepthTiles:
    pair_table: torch.Tensor  # (NP, 128) int32 bits: f16 pair raw depth
    mini_table: torch.Tensor  # (chunks, 128) int32 bits: f16 min | max << 16
    height: int
    width: int
    tiles_x: int
    tiles_y: int
    pairs_x: int
    minis_x: int

    @property
    def n_mini_chunks(self) -> int:
        return self.mini_table.shape[0]


def f16_bits(x):
    """f32 -> f16 (round to nearest even) -> its 16 bits, as int64."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def f16_from_bits(bits):
    """16 f16 bits (int64 in [0, 65536)) -> f32, exact incl. subnormals."""
    signed = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def as_int32_bits(u32):
    """uint32 values held in int64 -> the same 32 bits in an int32 tensor."""
    return torch.where(u32 >= 0x80000000, u32 - 0x100000000, u32).to(torch.int32)


def u32_from_int32(x):
    return x.to(torch.int64) & 0xFFFFFFFF


def build_depth_tiles(depth, near, far) -> DepthTiles:
    """Pair table + minitile interval table from a raw depth image (H, W)."""
    h, w = depth.shape
    pad_y = (-h) % (TILE_H * MINI_TY)
    pad_x = (-w) % (TILE_W * MINI_TX)
    d = torch.nn.functional.pad(depth, (0, pad_x, 0, pad_y))  # sky padding
    hp, wp = h + pad_y, w + pad_x
    ty, tx = hp // TILE_H, wp // TILE_W
    tiles = (
        d.reshape(ty, TILE_H, tx, TILE_W)
        .permute(0, 2, 1, 3)
        .reshape(ty, tx, TILE_H * TILE_W)
    )
    px_n = tx // 2
    pairs = f16_bits(tiles[:, 0::2, :]) | (f16_bits(tiles[:, 1::2, :]) << 16)
    pair_table = as_int32_bits(pairs.reshape(ty * px_n, TILE_H * TILE_W))

    lin_tiles = linear_eye_depth(tiles, near, far)
    tmin = torch.amin(lin_tiles, dim=2) * (1.0 - 2.0**-9)
    tmax = torch.amax(lin_tiles, dim=2) * (1.0 + 2.0**-9)
    mx_n = tx // MINI_TX
    my_n = ty // MINI_TY
    mmin = tmin.reshape(my_n, MINI_TY, mx_n, MINI_TX).amin(dim=(1, 3)).reshape(-1)
    mmax = tmax.reshape(my_n, MINI_TY, mx_n, MINI_TX).amax(dim=(1, 3)).reshape(-1)
    n_mini = my_n * mx_n
    m_chunks = -(-n_mini // 128)
    padn = m_chunks * 128 - n_mini
    mmin = torch.nn.functional.pad(mmin, (0, padn), value=float("inf"))
    mmax = torch.nn.functional.pad(mmax, (0, padn), value=float("-inf"))
    packed = f16_bits(mmin) | (f16_bits(mmax) << 16)
    return DepthTiles(
        pair_table=pair_table,
        mini_table=as_int32_bits(packed).reshape(m_chunks, 128),
        height=h,
        width=w,
        tiles_x=tx,
        tiles_y=ty,
        pairs_x=px_n,
        minis_x=mx_n,
    )


def unpack_minmax(words):
    """Mini-table words (int32 bits) -> (min, max) f32."""
    u = u32_from_int32(words)
    return f16_from_bits(u & 0xFFFF), f16_from_bits(u >> 16)


def unpack_pair_half(words, take_high):
    """Raw f16 depth from a pair word: low half = left tile, high = right."""
    u = u32_from_int32(words)
    return f16_from_bits(torch.where(take_high, u >> 16, u & 0xFFFF))


def pair_of(ix, iy, pairs_x: int):
    """(pair_row, texel_word, is_high_half) of pixel (iy, ix)."""
    txi = ix // TILE_W
    p = (iy // TILE_H) * pairs_x + (txi // 2)
    texel = (iy % TILE_H) * TILE_W + (ix % TILE_W)
    return p, texel, (txi % 2) == 1


def mini_of(ix, iy, minis_x: int):
    """Minitile index of pixel (iy, ix)."""
    return (iy // (TILE_H * MINI_TY)) * minis_x + (ix // (TILE_W * MINI_TX))
