"""Offline progressive accumulation + the convergence progress bar
(ScreenSpacePathTracing.shader pass 3 :287-344 and pass 4 :381-407).

The sample counter is a Python int: it is host control flow, as on the
reference's C# side, and reading it never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.image import luminance


@dataclasses.dataclass
class OfflineAccumState:
    accum: torch.Tensor  # (H, W, 3)
    sample: int  # samples accumulated so far

    @classmethod
    def create(cls, height: int, width: int, device="cuda"):
        return cls(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=device), sample=0)


def blend_alpha(sample: int, max_sample: int, paused: bool = False) -> float:
    """alpha = 1/(sample+1) in f32; 1 on restart; 0 when paused or full."""
    if sample >= max_sample or paused:
        return 0.0
    if sample == 0:
        return 1.0
    return float(np.float32(1.0) / (np.float32(sample) + np.float32(1.0)))


def offline_accumulate(state: OfflineAccumState, frame, max_sample: int,
                       paused=False) -> OfflineAccumState:
    """accum' = accum + (frame - accum) * alpha."""
    alpha = blend_alpha(state.sample, max_sample, bool(paused))
    prev = state.accum
    accum = prev + (frame - prev) * alpha
    hold = state.sample >= max_sample or bool(paused)
    return OfflineAccumState(accum=accum, sample=state.sample if hold else state.sample + 1)


def add_convergence_cue(color, sample: int, max_sample: int, height: int, width: int):
    """Progress bar over the bottom 0.5% (>= 4 px) of the frame, width
    sample/max_sample, luminance-inverted against the image."""
    sample_f = float(np.float32(sample))
    done = sample_f >= max_sample
    bar_height_px = max(4.0, math.ceil(height * 0.005))
    bar_height_uv = float(np.float32(bar_height_px) / np.float32(height))
    dev = color.device
    v = (torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5) / height
    u = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5) / width
    frac = float(np.float32(sample_f) / np.float32(max_sample))
    in_bar = (v < bar_height_uv) & (u <= frac) & (not done)
    lum = luminance(color)
    over = lum > 1.0
    normed = torch.where(
        over[..., None], color / torch.clamp(lum, min=1e-12)[..., None], color
    )
    lum = torch.clamp(lum, max=1.0)
    shifted = normed + torch.where(lum > 0.5, -0.5 * lum, 0.05 + 0.5 * lum)[..., None]
    return torch.where(in_bar[..., None], shifted, color)
