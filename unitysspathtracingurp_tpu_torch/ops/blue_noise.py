"""Blue-noise sampler tables (the reference's three noise textures, generated).

GetBNDSequenceSample (PathTracingUtilities.hlsl:78-99) reads a
256-sample x 256-dimension Owen-scrambled sequence and two 128x128x8
tiles (ranking, scrambling) that arrange the Monte Carlo error as blue
noise in screen space (Heitz et al. 2019). The tables are generated,
not copied: an Owen-scrambled 2D Sobol sequence quantized to 8 bits,
and void-and-cluster masks (Ulichney 1993) under a periodic Gaussian
energy filter.

This is a numpy copy of the JAX package's generator
(``ops/blue_noise.py:37-173``); the port keeps its own so that it never
imports that package. Its output is committed beside this module
(``_blue_noise_tables.npz``, version 2) and equals the JAX package's
committed tables bit for bit. Generating all 16 masks takes about a
minute and a half on one CPU core, so the Renderer loads the file and
never regenerates it; ``generate_tables(cache_path=None)`` recomputes
them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

SEQ_SAMPLES = 256
SEQ_DIMS = 256
TILE = 128
TILE_DIMS = 8

DEFAULT_CACHE = os.path.join(os.path.dirname(__file__), "_blue_noise_tables.npz")

_TABLE_VERSION = 2  # a true 2D Sobol pair for each two consecutive dimensions


def _reverse_bits8(i: np.ndarray) -> np.ndarray:
    i = i.astype(np.uint32)
    out = np.zeros_like(i)
    for b in range(8):
        out |= ((i >> b) & 1) << (7 - b)
    return out


def _sobol2_8bit(i: np.ndarray) -> np.ndarray:
    """The second Sobol dimension (primitive polynomial x^2 + x + 1),
    8 bits: with the radical inverse it forms a (0, 2)-net in base 2."""
    m = [1, 3, 5, 15, 17, 51, 85, 255]  # the Pascal / Sierpinski matrix
    v = np.array([mm << (8 - j - 1) for j, mm in enumerate(m)], np.uint32) & 0xFF
    i = i.astype(np.uint32)
    out = np.zeros_like(i)
    for b in range(8):
        out ^= np.where((i >> b) & 1, v[b], 0).astype(np.uint32)
    return out & np.uint32(0xFF)


def _owen_scramble8(value: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Nested (Owen) scrambling of an 8-bit radical-inverse value: each
    bit flipped by a hash of the bits above it and the seed."""
    v = value.astype(np.uint32)
    out = np.zeros_like(v)
    prefix = np.zeros_like(v)
    for b in range(7, -1, -1):  # most significant first
        h = (prefix * np.uint32(0x9E3779B9)) ^ seed.astype(np.uint32)
        h ^= h >> 16
        h = (h * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
        h ^= h >> 13
        flip = (h >> np.uint32(b)) & 1
        bit = ((v >> b) & 1) ^ flip
        out |= bit << b
        prefix = (prefix << 1) | bit
    return out & np.uint32(0xFF)


def _void_and_cluster(size: int, seed: int, sigma: float = 1.9) -> np.ndarray:
    """Periodic void-and-cluster blue-noise rank mask in [0, size*size)."""
    rng = np.random.default_rng(seed)
    n = size * size

    # Periodic Gaussian energy kernel, applied through the FFT.
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    dy = np.minimum(yy, size - yy)
    dx = np.minimum(xx, size - xx)
    kernel = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    kf = np.fft.rfft2(kernel)

    def energy(binary):
        return np.fft.irfft2(np.fft.rfft2(binary) * kf, s=(size, size))

    # Initial pattern: 10% random points, relaxed.
    binary = np.zeros((size, size))
    pts = rng.choice(n, n // 10, replace=False)
    binary.ravel()[pts] = 1.0
    for _ in range(24):
        e = energy(binary)
        tight = np.unravel_index(np.argmax(np.where(binary > 0, e, -np.inf)), e.shape)
        binary[tight] = 0.0
        e = energy(binary)
        void = np.unravel_index(np.argmin(np.where(binary > 0, np.inf, e)), e.shape)
        if void == tight:
            binary[tight] = 1.0
            break
        binary[void] = 1.0

    rank = np.zeros((size, size), np.int64)
    # Phase 1: remove from the initial pattern, ranking tightest first.
    work = binary.copy()
    count = int(work.sum())
    for r in range(count - 1, -1, -1):
        e = energy(work)
        p = np.unravel_index(np.argmax(np.where(work > 0, e, -np.inf)), e.shape)
        work[p] = 0.0
        rank[p] = r
    # Phase 2: fill the remaining voids.
    work = binary.copy()
    for r in range(count, n):
        e = energy(work)
        p = np.unravel_index(np.argmin(np.where(work > 0, np.inf, e)), e.shape)
        work[p] = 1.0
        rank[p] = r
    return rank


def sequence_table() -> np.ndarray:
    """The (sample, dimension) table, (256, 256) uint32 in [0, 256):
    even dimensions the radical inverse, odd ones the second Sobol
    dimension, so every draw2 pair (d, d + 1) is a (0, 2)-net; each
    dimension Owen-scrambled with its own seed."""
    i = np.arange(SEQ_SAMPLES, dtype=np.uint32)
    base0 = _reverse_bits8(i)
    base1 = _sobol2_8bit(i)
    dims = np.arange(SEQ_DIMS, dtype=np.uint32)
    dim_seed = (dims * np.uint32(0x9E3779B1)) ^ np.uint32(0xA511E9B3)
    base = np.where((dims[None, :] & 1) == 0, base0[:, None], base1[:, None])
    return _owen_scramble8(
        base, np.broadcast_to(dim_seed[None, :], (SEQ_SAMPLES, SEQ_DIMS))).astype(np.uint32)


def generate_tables(seed: int = 0, cache_path: str | None = DEFAULT_CACHE) -> dict:
    """The three tables as numpy uint32 arrays, laid out as the sampler
    indexes them: ``sobol`` (256, 256), ``ranking`` and ``scrambling``
    (128 * 128 * 8,) with cell = (x + y * 128) * 8 + (dim & 7). Loaded
    from ``cache_path`` when it holds this version; otherwise generated
    and, with a ``cache_path``, written there."""
    if cache_path and os.path.exists(cache_path):
        data = np.load(cache_path)
        if "version" in data and int(data["version"]) == _TABLE_VERSION:
            return {k: data[k] for k in ("sobol", "ranking", "scrambling")}

    ranking = np.zeros((TILE * TILE, TILE_DIMS), np.uint32)
    scrambling = np.zeros((TILE * TILE, TILE_DIMS), np.uint32)
    for d in range(TILE_DIMS):
        r = _void_and_cluster(TILE, seed=seed * 31 + d)
        s = _void_and_cluster(TILE, seed=seed * 31 + 101 + d)
        ranking[:, d] = (r.ravel() * 256 // (TILE * TILE)).astype(np.uint32)
        scrambling[:, d] = (s.ravel() * 256 // (TILE * TILE)).astype(np.uint32)
    tables = {"sobol": sequence_table(), "ranking": ranking.reshape(-1),
              "scrambling": scrambling.reshape(-1)}
    if cache_path:
        np.savez_compressed(cache_path, version=_TABLE_VERSION, **tables)
    return tables


class BlueNoiseTables:
    """The three tables as int32 tensors on ``device`` (1.25 MB in all),
    for ``ops.rng.make_rng(tables=...)``: ``sobol`` (256, 256),
    ``ranking`` and ``scrambling`` (131072,), every value in [0, 256).
    ``tables`` is a dict of numpy arrays (``generate_tables()``'s, the
    committed file's, by default)."""

    def __init__(self, tables: dict | None = None, device="cuda"):
        t = tables if tables is not None else generate_tables()
        for name in ("sobol", "ranking", "scrambling"):
            arr = np.asarray(t[name]).astype(np.int32)
            setattr(self, name, torch.as_tensor(arr).to(device))
