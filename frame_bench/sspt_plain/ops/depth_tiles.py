"""Tiled + hierarchical depth structures for the hiz march.

Plain layout (``DepthTiles``, the no-refraction / no-backface variants):

  * ``pair_table`` (NP, 128): each row covers a pair of horizontally
    adjacent 16x8-texel tiles; word w holds texel w of the left tile's
    raw depth as f16 in its low half and the right tile's in its high
    half.
  * ``mini_table`` (chunks, 128): per 32x16-px minitile, the min/max
    linear eye depth (sky linearises to ``far``), conservatively
    rounded to f16, packed f16(min) | f16(max) << 16.

Dual layout (``DualDepthTiles``, the refraction / backface variants):
one (test, back) depth-image pair per insideObject combo, see
``variant_combos``.

All tables hold uint32 bit patterns in int32 tensors (the JAX package
keeps the same bits in f32 arrays). Bit-identical to
``unitysspathtracingurp_tpu.ops.depth_tiles``'s ``build_depth_tiles``
and ``build_dual_depth_tiles``. The home strips of the port's home
prefix are not in this frozen copy.
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


@dataclasses.dataclass
class DualDepthTiles:
    """Per-combo dual-layer depth tables (PathTracing.hlsl:79-98 layer
    selection, :111-136 backface thickness rules).

      combo 0 (inside == 0): (layer1, back)
      combo 1 (inside == 1): (back, opaque)    [refraction + backface]
      combo 2 (inside == 2): (opaque, back)    [refraction + backface]
      refraction only:       (layer1, none) / (opaque, none)
      backface only:         (layer1, back)

    ``tile_table`` rows hold one 16x8 tile per combo, one word per
    texel: low f16 = test-layer raw depth, high f16 = back-layer raw
    depth (0 = no back data). Row = combo * tiles_per_combo + tile.
    ``mini_table`` packs per 32x16-px minitile and combo
    f16(mmin) | f16(umax) << 16, umax the max over texels of
    (back valid ? max(back, test) : test) in linear depth; ``bmax_table``
    the max valid back depth (-inf where none) in its low half.
    """

    tile_table: torch.Tensor  # (n_combos * NT, 128) int32 bits: test | back << 16
    mini_table: torch.Tensor  # (n_combos * chunks, 128) int32 bits: mmin | umax << 16
    bmax_table: torch.Tensor  # (n_combos * chunks, 128) int32 bits: f16 bmax
    height: int
    width: int
    tiles_x: int
    tiles_y: int
    minis_x: int
    n_combos: int

    @property
    def tiles_per_combo(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def chunks_per_combo(self) -> int:
        return self.mini_table.shape[0] // self.n_combos


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


def _tile_layout(img, h: int, w: int):
    """(H, W) -> (ty, tx, 128) single-tile texel layout, sky-padded."""
    pad_y = (-h) % (TILE_H * MINI_TY)
    pad_x = (-w) % (TILE_W * MINI_TX)
    d = torch.nn.functional.pad(img, (0, pad_x, 0, pad_y))
    ty, tx = (h + pad_y) // TILE_H, (w + pad_x) // TILE_W
    return d.reshape(ty, TILE_H, tx, TILE_W).permute(0, 2, 1, 3).reshape(
        ty, tx, TILE_H * TILE_W), ty, tx


def _mini_reduce(per_tile, reduce, my_n, mx_n):
    """(ty, tx) per-tile values -> flat per-minitile values."""
    r = per_tile.reshape(my_n, MINI_TY, mx_n, MINI_TX)
    return (r.amin(dim=(1, 3)) if reduce == "min" else r.amax(dim=(1, 3))).reshape(-1)


def build_dual_depth_tiles(combos, near, far, height: int, width: int) -> DualDepthTiles:
    """DualDepthTiles from per-combo (test_depth, back_depth) raw images;
    ``back_depth`` None packs the sky sentinel 0 (no back data, so the
    hit rule reduces to the plain thickness window)."""
    tile_rows, mini_rows, bmax_rows = [], [], []
    ty = tx = mx_n = 0
    for test, back in combos:
        tiles_t, ty, tx = _tile_layout(test, height, width)
        back_b = torch.zeros_like(tiles_t) if back is None else _tile_layout(back, height, width)[0]
        tile_rows.append(f16_bits(tiles_t) | (f16_bits(back_b) << 16))

        lin_t = linear_eye_depth(tiles_t, near, far)
        lin_b = linear_eye_depth(back_b, near, far)
        back_ok = (back_b != 0.0) & (lin_b >= lin_t)
        upper = torch.where(back_ok, torch.maximum(lin_b, lin_t), lin_t)
        tmin = torch.amin(lin_t, dim=2) * (1.0 - 2.0**-9)
        tumax = torch.amax(upper, dim=2) * (1.0 + 2.0**-9)
        tbmax = torch.amax(
            torch.where(back_ok, lin_b, torch.full_like(lin_b, float("-inf"))), dim=2
        ) * (1.0 + 2.0**-9)
        mx_n, my_n = tx // MINI_TX, ty // MINI_TY
        n_mini = my_n * mx_n
        m_chunks = -(-n_mini // 128)
        padn = m_chunks * 128 - n_mini
        pad = torch.nn.functional.pad
        mmin = pad(_mini_reduce(tmin, "min", my_n, mx_n), (0, padn), value=float("inf"))
        mumax = pad(_mini_reduce(tumax, "max", my_n, mx_n), (0, padn), value=float("-inf"))
        mbmax = pad(_mini_reduce(tbmax, "max", my_n, mx_n), (0, padn), value=float("-inf"))
        mini_rows.append((f16_bits(mmin) | (f16_bits(mumax) << 16)).reshape(m_chunks, 128))
        bmax_rows.append(f16_bits(mbmax).reshape(m_chunks, 128))
    return DualDepthTiles(
        tile_table=as_int32_bits(torch.cat(tile_rows, 0).reshape(-1, TILE_H * TILE_W)),
        mini_table=as_int32_bits(torch.cat(mini_rows, 0)),
        bmax_table=as_int32_bits(torch.cat(bmax_rows, 0)),
        height=height, width=width, tiles_x=tx, tiles_y=ty, minis_x=mx_n,
        n_combos=len(combos),
    )


def variant_combos(gb, variants):
    """The (test, back) depth-image combos of a variant set, indexed by
    the per-lane insideObject state (PathTracing.hlsl:79-98)."""
    layer1 = gb.layer1_depth()
    back = gb.back_depth if variants.backface_textures else None
    if variants.support_refraction:
        if back is not None:
            return [(layer1, back), (back, gb.depth), (gb.depth, back)]
        return [(layer1, None), (gb.depth, None)]  # no back data: 2 layers
    return [(layer1, back)]


def tile_of(ix, iy, tiles_x: int):
    """(tile_row, texel_word) of pixel (iy, ix) in single-tile rows."""
    return (iy // TILE_H) * tiles_x + (ix // TILE_W), (iy % TILE_H) * TILE_W + (ix % TILE_W)


def unpack_dual(words):
    """Dual tile words (int32 bits) -> (test_raw, back_raw) f32."""
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
