"""Ray-throughput accounting and image error metrics."""

from __future__ import annotations

import numpy as np


def rays_per_frame(height, width, spp, bounces, sky_fraction=0.0) -> float:
    """Marched rays per frame: every non-sky pixel casts ``spp`` paths of
    up to ``bounces`` marched rays (the primary hit is a G-buffer read)."""
    return height * width * (1.0 - sky_fraction) * spp * bounces


def mrays_per_sec(height, width, spp, bounces, seconds_per_frame, sky_fraction=0.0):
    return rays_per_frame(height, width, spp, bounces, sky_fraction) / seconds_per_frame / 1e6


def relative_rmse(a, b, mask=None) -> float:
    """RMSE normalised by the reference mean."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if mask is not None:
        a, b = a[np.asarray(mask)], b[np.asarray(mask)]
    return float(np.sqrt(((a - b) ** 2).mean()) / max(float(b.mean()), 1e-12))


def frame_agreement(port, ref, non_sky):
    """(pooled relative RMSE over non-sky pixels, fraction of non-sky
    pixels whose channels all agree within 1e-3 relative)."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    mask = np.asarray(non_sky)
    rel = relative_rmse(port, ref, mask)
    close = np.abs(port - ref) <= 1e-3 * np.maximum(np.abs(ref), 1e-6)
    within = float(close.all(-1)[mask].mean())
    return rel, within
