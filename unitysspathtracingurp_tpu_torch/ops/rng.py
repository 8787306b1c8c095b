"""Counter-based per-pixel RNG (PathTracingUtilities.hlsl:74-113).

Three modes, as in the JAX package (``ops/rng.py``):
  * hashed: the Jenkins one-at-a-time hash of (pixel, frame_index +
    draw counter), turned into a float in [0, 1);
  * blue noise (``make_rng(tables=...)``): the reference's
    GetBNDSequenceSample over the tables of ``ops/blue_noise.py``, with
    a Cranley-Patterson rotation keyed by the 256-frame epoch;
  * Sobol-Owen (``make_rng(sobol_owen=True)``): per-pixel index-shuffled,
    Owen-scrambled 2D Sobol pairs (Burley, "Practical Hash-based Owen
    Scrambling", JCGT 2020).

Stateless, so no ``torch.Generator`` is involved. uint32 arithmetic runs
in int64 with ``& 0xFFFFFFFF`` masks: torch's ``uint32`` lacks add,
shifts and comparisons on the CPU. Products by 32-bit constants go
through 16-bit halves of the constant, so that no product leaves int64.

The draw counter (``seed``) is uniform over lanes (every potential draw
site advances it for every lane), so it is a Python int here, as are
every term that depends only on it and the frame index (the Sobol pair
and component, the blue-noise dimension, epoch and rotation); the JAX
package carries the same values in per-pixel arrays. Only the pixel
terms are tensors, and lane compaction gathers them.

Every draw goes through kernel S1 (``csrc/sampler.cu``), in every
mode: ``sampler_draws`` launches it for CUDA tensors, one launch a
``draw`` or ``draw2``, and runs the plain version ``sampler_draws_ref``
for CPU tensors. The kernel reads each lane's pixel, so it serves the
pixel grid and compacted lanes alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import FRAME_INDEX_MOD, FRAME_INDEX_STRIDE
from .blue_noise import BlueNoiseTables

M32 = 0xFFFFFFFF
# S1's modes (the kernel's template argument).
BLUE_NOISE, SOBOL_OWEN, HASHED = 0, 1, 2


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


def hashed_random_float(pix_x, pix_y, z):
    """GenerateHashedRandomFloat(uint3(pixel, z)): int64 tensors (or
    ints) holding uint32 values -> f32 in [0, 1)."""
    return construct_float(jenkins_hash_u32_3(pix_x & M32, pix_y & M32, z & M32))


# ---------------------------------------------------------------- Sobol-Owen


def _sobol2_dirs():
    """Direction numbers of Sobol dimension 2 (primitive polynomial x + 1:
    m_k = (m_{k-1} << 1) ^ m_{k-1}, the Pascal matrix), 32 bits."""
    m = 1
    dirs = []
    for j in range(32):
        dirs.append((m << (31 - j)) & M32)
        m = ((m << 1) ^ m) & M32
    return tuple(dirs)


_SOBOL2_DIRS = _sobol2_dirs()


def _mul32(x, c: int):
    """(x * c) mod 2^32 for a uint32 ``x`` (int64 tensor or int) and a
    32-bit constant ``c``, by the 16-bit halves of ``c``."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def reverse_bits_u32(x):
    """Bit-reverse a uint32 (5 mask / shift rounds)."""
    x = x & M32
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & M32) | (x >> 16)


def _laine_karras(x, seed):
    """Laine-Karras hash: bit i of the output depends only on bits <= i
    of the input (constants from Burley 2020)."""
    x = (x + seed) & M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble of a uint32 radical-inverse value: each bit flipped
    by a hash of the bits above it and the seed."""
    return reverse_bits_u32(_laine_karras(reverse_bits_u32(x), seed))


def _sobol_pair(n, comp: int):
    """Component ``comp`` (0 or 1, a host int) of the 2D Sobol
    (0, 2)-sequence at index ``n``."""
    if comp == 0:
        return reverse_bits_u32(n)
    v = torch.zeros_like(n)
    for j, dj in enumerate(_SOBOL2_DIRS):
        v = v ^ (((n >> j) & 1) * dj)
    return v


def _frame_number(frame_index: int) -> int:
    """The frame number k from the stride-33 counter: 33 * 9697 == 1 (mod 64000)."""
    return ((frame_index * 9697) & M32) % 64000


def _sobol_owen_sample(pix_x, pix_y, frame_index: int, seed: int):
    """Draw ``seed`` (>= 1) of every lane: pair p = d >> 1 and component
    c = d & 1 of d = seed - 1; the frame number index-shuffled by a key of
    (pixel, p), the Sobol point Owen-scrambled by a key of (pixel, d),
    its top 24 bits in [0, 1)."""
    d = (seed - 1) & M32
    pair, comp = d >> 1, d & 1
    pkey = jenkins_hash_u32_3(pix_x, pix_y, (pair * 0x51633E2D + 0xA511E9B3) & M32)
    n = nested_uniform_scramble(_frame_number(frame_index), pkey)
    vkey = jenkins_hash_u32_3(pix_x, pix_y, (d * 0x68BC21EB + 0x02E5BE93) & M32)
    v = nested_uniform_scramble(_sobol_pair(n, comp), vkey)
    return (v >> 8).to(torch.float32) * (1.0 / 16777216.0)


# ---------------------------------------------------------------- blue noise


def blue_noise_rotation(frame_index: int, seed: int) -> float:
    """The Cranley-Patterson rotation of draw ``seed`` (an f32 value): 0
    in the first 256 frames (the reference's sampler), then a hash of
    (epoch, draw), constant over pixels so that the tiles' blue-noise
    arrangement survives (JAX ``rng.py:134-153``)."""
    epoch = _frame_number(frame_index) >> 8
    if epoch == 0:
        return 0.0
    bits = (jenkins_hash_u32((epoch * 9173 + seed) & M32) & 0x007FFFFF) | 0x3F800000
    return float(np.array(bits, np.uint32).view(np.float32) - np.float32(1.0))


def _blue_noise_sample(pix_x, pix_y, frame_index: int, seed: int, tables: BlueNoiseTables):
    """GetBNDSequenceSample (PathTracingUtilities.hlsl:78-99): pixel
    wrapped to 128, sample index to 256, dimension to 256; the sequence
    value XOR-scrambled by the pixel's ranking / scrambling cells,
    jittered by the scrambling value, then rotated by the epoch's
    ``blue_noise_rotation`` modulo 1 (x - floor(x): exact, as the JAX
    package's ``jnp.mod`` is, for x in [0, 2))."""
    sample_index = frame_index & 255
    dim = seed & 255
    cell = ((pix_x & 127) + (pix_y & 127) * 128) * 8 + (dim & 7)
    ranked = (tables.ranking[cell] ^ sample_index) & 255
    value = tables.sobol.reshape(-1)[ranked.to(torch.int64) * 256 + dim]
    scrambling = tables.scrambling[cell]
    value = value ^ scrambling
    scramble_f = torch.clamp(scrambling.to(torch.float32) / 256.0, max=0.999)
    u = (scramble_f + (value & 255).to(torch.float32)) / 256.0
    x = u + blue_noise_rotation(frame_index, seed)
    return x - torch.floor(x)


# ---------------------------------------------------------------- S1


def sampler_draws_ref(pix_x, pix_y, frame_index: int, first: int, count: int, mode: int,
                      tables: Optional[BlueNoiseTables] = None):
    """S1's plain version: draws ``first`` .. ``first + count - 1``
    (``count`` 1 or 2) of every lane in ``mode`` (``BLUE_NOISE``, which
    reads ``tables``, ``SOBOL_OWEN`` or ``HASHED``). Returns f32 of the
    lanes' shape, with a last axis of 2 when ``count`` is 2."""
    if mode == HASHED:
        vals = [construct_float(jenkins_hash_u32_3(pix_x, pix_y, (frame_index + first + i) & M32))
                for i in range(count)]
    elif mode == SOBOL_OWEN:
        vals = [_sobol_owen_sample(pix_x, pix_y, frame_index, first + i) for i in range(count)]
    else:
        vals = [_blue_noise_sample(pix_x, pix_y, frame_index, first + i, tables)
                for i in range(count)]
    return vals[0] if count == 1 else torch.stack(vals, dim=-1)


def sampler_draws(pix_x, pix_y, frame_index: int, first: int, count: int, mode: int,
                  tables: Optional[BlueNoiseTables] = None):
    """``sampler_draws_ref``'s draws. CPU tensors: the plain version.
    CUDA tensors: one launch of kernel S1, or an exception; there is no
    fallback. ``pix_x`` / ``pix_y`` are int64."""
    if pix_x.device.type == "cpu":
        return sampler_draws_ref(pix_x, pix_y, frame_index, first, count, mode, tables)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    if count not in (1, 2) or mode not in (BLUE_NOISE, SOBOL_OWEN, HASHED):
        raise ValueError(f"sampler_draws: count {count}, mode {mode}")
    px, py = pix_x.contiguous(), pix_y.contiguous()
    if px.dtype != torch.int64 or py.dtype != torch.int64 or px.shape != py.shape:
        raise RuntimeError("sampler_draws: pixel coordinates must be int64 of one shape")
    tabs = []
    if mode == BLUE_NOISE:
        tabs = [tables.sobol, tables.ranking, tables.scrambling]
        if any(t.dtype != torch.int32 for t in tabs) or tables.sobol.numel() != 65536 or any(
                t.numel() != 131072 for t in tabs[1:]):
            raise RuntimeError("sampler_draws: blue-noise tables must be int32 (256, 256), "
                               "(131072,), (131072,)")
    require_cuda("sampler_draws", px, py, *tabs)
    out = torch.empty(px.shape + ((2,) if count == 2 else ()), dtype=torch.float32,
                      device=px.device)
    n = px.numel()
    if n == 0:
        return out
    rc = lib.sspt_sampler(
        px.data_ptr(), py.data_ptr(), *([t.data_ptr() for t in tabs] or [0, 0, 0]),
        out.data_ptr(), n, mode, frame_index & M32, first & M32, count, stream_of(out),
    )
    check(rc, "sampler")
    LAUNCHES["sampler"] += 1
    return out


# ---------------------------------------------------------------- the stream


@dataclasses.dataclass
class RNG:
    pix_x: torch.Tensor  # (...) int64 pixel column
    pix_y: torch.Tensor  # (...) int64 pixel row
    frame_index: int
    seed: int  # draw counter, uniform over lanes
    tables: Optional[BlueNoiseTables] = None  # blue-noise mode
    sobol_owen: bool = False

    @property
    def mode(self) -> int:
        """S1's mode (Sobol-Owen wins, as in JAX; hashed without tables)."""
        if self.sobol_owen:
            return SOBOL_OWEN
        return HASHED if self.tables is None else BLUE_NOISE


def make_rng(height: int, width: int, frame_index: int, device,
             tables: Optional[BlueNoiseTables] = None, sobol_owen: bool = False) -> RNG:
    """A fresh per-frame RNG grid. ``tables`` selects blue noise,
    ``sobol_owen`` the Owen-scrambled Sobol mode, neither the hashed
    mode; S1 reads the pixel grid, so it is held contiguous."""
    xs = torch.arange(width, dtype=torch.int64, device=device)
    ys = torch.arange(height, dtype=torch.int64, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px, py = px.contiguous(), py.contiguous()
    return RNG(pix_x=px, pix_y=py, frame_index=int(frame_index) & M32, seed=0,
               tables=tables, sobol_owen=sobol_owen)


def draw(rng: RNG):
    """One draw per lane: the counter increments, then the value is that
    draw of the mode's stream (hashed: hash(pixel, frame_index +
    counter)). Returns (value, new rng)."""
    seed = rng.seed + 1
    return (sampler_draws(rng.pix_x, rng.pix_y, rng.frame_index, seed, 1, rng.mode, rng.tables),
            dataclasses.replace(rng, seed=seed))


def draw2(rng: RNG):
    """Two draws as a 2D sample (..., 2). In Sobol mode the counter is
    first rounded up to even, so the two values are the two components
    of one Sobol pair. Both come from one S1 launch."""
    seed = (rng.seed + 1) & ~1 if rng.sobol_owen else rng.seed
    values = sampler_draws(rng.pix_x, rng.pix_y, rng.frame_index, seed + 1, 2, rng.mode,
                           rng.tables)
    return values, dataclasses.replace(rng, seed=seed + 2)


def draws_per_sample(maximum_depth: int) -> int:
    """Draws one path sample takes: 3 for bounce 0 (the BRDF's draw2 and
    roulette), 4 a bounce after it (draw2, roulette, Russian roulette)."""
    return 3 + 4 * maximum_depth


def sample_rng(rng: RNG, s: int, maximum_depth: int) -> RNG:
    """The stream of path sample ``s``: the counter offset by ``s`` samples'
    draws, so samples drawn one after another reproduce the JAX package's
    samples drawn side by side (``pathtrace.py:942-949``)."""
    return dataclasses.replace(rng, seed=rng.seed + s * draws_per_sample(maximum_depth))


def advance_frame_index(frame_index: int) -> int:
    return (frame_index + FRAME_INDEX_STRIDE) % FRAME_INDEX_MOD
