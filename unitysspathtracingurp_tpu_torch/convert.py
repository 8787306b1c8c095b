"""Carry state across from the JAX package, as weights carry across for a model.

Every function takes the JAX objects' leaves as numpy arrays (the caller
runs ``np.asarray`` on them, so this module never imports JAX) and
returns the port's object on ``device``, the card unless the caller
asks for the CPU. Bit patterns carry over unchanged: the JAX package
keeps uint32 table words in f32 arrays, the port in int32 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as tconfig
from .camera import Camera
from .gbuffer import GBuffers
from .ops.accumulate import OfflineAccumState
from .ops.depth_tiles import DepthTiles, DualDepthTiles
from .ops.envprobe import EnvProbe, ProbeSet


def _t(a, device, dtype=None):
    if a is None:
        return None
    arr = np.array(a)  # a writable, contiguous copy; keeps 0-d shapes
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    t = torch.as_tensor(arr)
    return (t if dtype is None else t.to(dtype)).to(device)


def gbuffers(leaves: dict, device="cuda") -> GBuffers:
    """``leaves``: field name -> numpy array (None for absent layers),
    the transparent and backface layers included. Layers the port does
    not decode yet (motion vectors) raise rather than drop."""
    names = {f.name for f in dataclasses.fields(GBuffers)}
    extra = sorted(k for k, v in leaves.items() if v is not None and k not in names)
    if extra:
        raise NotImplementedError(
            f"G-buffer layers {extra}: ROADMAP Queue 1 item 10 (motion vectors)"
        )
    return GBuffers(**{name: _t(leaves.get(name), device) for name in names})


def camera(leaves: dict, device="cuda") -> Camera:
    return Camera(**{
        f.name: _t(leaves[f.name], device, torch.float32)
        for f in dataclasses.fields(Camera)
    })


def env_probe(leaves: dict, device="cuda") -> EnvProbe:
    return EnvProbe(
        texture=_t(leaves["texture"], device, torch.float32),
        hdr_mult=_t(leaves["hdr_mult"], device, torch.float32),
        box_min=_t(leaves["box_min"], device, torch.float32),
        box_max=_t(leaves["box_max"], device, torch.float32),
        position=_t(leaves["position"], device, torch.float32),
        box_projection=_t(leaves["box_projection"], device, torch.float32),
        mips=tuple(_t(m, device, torch.float32) for m in leaves.get("mips", ())),
    )


def probe_set(probe0: dict, probe1: dict | None = None, blend_weight=None,
              probe_set=None, is_probe_camera=None, device="cuda") -> ProbeSet:
    return ProbeSet(
        probe0=env_probe(probe0, device),
        probe1=None if probe1 is None else env_probe(probe1, device),
        blend_weight=_t(blend_weight, device, torch.float32),
        probe_set=_t(probe_set, device, torch.float32),
        is_probe_camera=_t(is_probe_camera, device, torch.float32),
    )


def _bits_i32(a, device):
    """An f32-bitcast uint32 table -> the same bits in an int32 tensor."""
    return torch.as_tensor(np.array(np.asarray(a, np.float32).view(np.int32))).to(device)


def depth_tiles(pair_table, mini_table, *, height, width, tiles_x, tiles_y,
                pairs_x, minis_x, device="cuda") -> DepthTiles:
    """The JAX ``DepthTiles``: f32-bitcast uint32 tables + static ints."""
    return DepthTiles(
        pair_table=_bits_i32(pair_table, device), mini_table=_bits_i32(mini_table, device),
        height=height, width=width, tiles_x=tiles_x, tiles_y=tiles_y,
        pairs_x=pairs_x, minis_x=minis_x,
    )


def dual_depth_tiles(tile_table, mini_table, bmax_table, *, height, width, tiles_x,
                     tiles_y, minis_x, n_combos, device="cuda") -> DualDepthTiles:
    """The JAX ``DualDepthTiles``: three f32-bitcast uint32 tables + ints."""
    return DualDepthTiles(
        tile_table=_bits_i32(tile_table, device), mini_table=_bits_i32(mini_table, device),
        bmax_table=_bits_i32(bmax_table, device), height=height, width=width,
        tiles_x=tiles_x, tiles_y=tiles_y, minis_x=minis_x, n_combos=n_combos,
    )


def offline_state(accum, sample, device="cuda") -> OfflineAccumState:
    return OfflineAccumState(accum=_t(accum, device), sample=int(np.asarray(sample)))


def _fields(src, cls, skip=()):
    names = {f.name for f in dataclasses.fields(cls)}
    return {
        f.name: getattr(src, f.name)
        for f in dataclasses.fields(src)
        if f.name in names and f.name not in skip
    }


def pt_config(cfg) -> tconfig.PTConfig:
    """Field by field; the TPU-only lowering knobs are dropped."""
    return tconfig.PTConfig(**_fields(cfg, tconfig.PTConfig))


def pt_settings(settings) -> tconfig.PTSettings:
    kw = _fields(settings, tconfig.PTSettings)
    for name, enum_cls in (
        ("noise_method", tconfig.NoiseMethod),
        ("denoiser", tconfig.DenoiserType),
        ("accurate_thickness", tconfig.ThicknessMode),
        ("spatial_denoise_quality", tconfig.SpatialDenoiseQuality),
    ):
        kw[name] = enum_cls(kw[name].value)
    return tconfig.PTSettings(**kw)


def pt_variants(variants) -> tconfig.PTVariants:
    return tconfig.PTVariants(**_fields(variants, tconfig.PTVariants))
