"""Image-space math: luminance and the HSV firefly clamp."""

from __future__ import annotations

import torch


def luminance(rgb):
    """Rec.709 luma (Unity's Luminance())."""
    return (
        0.2126729 * rgb[..., 0] + 0.7151522 * rgb[..., 1] + 0.0721750 * rgb[..., 2]
    )


def rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe_delta = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(
        maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(options):
        out = options[0]
        for k in range(1, 6):
            out = torch.where(i == k, options[k], out)
        return out

    r = pick([v, q, p, p, t, v])
    g = pick([t, v, v, q, p, p])
    b = pick([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def clamp_brightness_hsv(rgb, max_brightness):
    """Clamp the HSV value channel to ``max_brightness``
    (reference: ScreenSpacePathTracing.shader:141-144)."""
    hsv = rgb_to_hsv(rgb)
    hsv = torch.cat(
        [hsv[..., :2], torch.clamp(hsv[..., 2:], 0.0, max_brightness)], dim=-1
    )
    return hsv_to_rgb(hsv)
