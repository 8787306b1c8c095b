"""Frame orchestrator, offline half (ScreenSpacePathTracingAccumulation.cs).

Offline mode (DenoiserType.OFFLINE, static camera): trace (pass 0) ->
progressive average (pass 3) -> progress bar (pass 4). NONE mode
returns the traced frame. Host control flow mirrors the C# side:
invalidation on camera or scene-key change (cs:772-823), pause, the
converged skip (cs:436-438), the depth-tiles cache, and save / load.

The real-time modes (ROADMAP Queue 1 item 10), render-scale upscaling
(item 13), multi-device sharding (item 14), the 11-bit HDR target
(``hdr_64bit=False``, item 3b) and the parity march (``kernel="xla"``,
item 7) raise NotImplementedError, so accumulation is f32 and every
frame runs the hiz march.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..camera import Camera
from ..config import DenoiserType, PTConfig, PTSettings
from ..gbuffer import GBuffers
from ..ops.accumulate import OfflineAccumState, add_convergence_cue, offline_accumulate
from ..ops.envprobe import ProbeSet, constant_probe
from ..ops.depth_tiles import variant_combos
from ..ops.pathtrace_hiz import build_tiles_for, trace_frame_hiz
from ..ops.rng import advance_frame_index


class Renderer:
    """Stateful frame renderer; call ``render_frame(gbuffers, camera)``
    once per frame. Every tensor lives on ``device``: the card unless the
    caller passes ``device="cpu"``."""

    def __init__(
        self,
        settings: PTSettings,
        height: int,
        width: int,
        cfg: PTConfig = PTConfig(),
        probes: Optional[ProbeSet] = None,
        fov_y: float = float(np.radians(60.0)),
        hdr_64bit: bool = True,
        display_size: Optional[tuple] = None,
        mesh=None,
        kernel: str = "auto",
        device="cuda",
    ):
        """The JAX ``Renderer``'s arguments in its order, then ``device``.
        ``fov_y`` is kept for the real-time modes (item 10). ``kernel``:
        "auto" and "hiz" run the hiz march; "xla" (the parity march) is
        not ported."""
        settings.validate()
        if not hdr_64bit:
            raise NotImplementedError(
                "hdr_64bit=False (bf16 accumulation): ROADMAP Queue 1 item 3b"
            )
        if kernel == "xla":
            raise NotImplementedError("kernel='xla' (the parity march): ROADMAP Queue 1 item 7")
        if kernel not in ("auto", "hiz"):
            raise ValueError(f"unknown kernel {kernel!r} (auto|hiz|xla)")
        if settings.denoiser not in (DenoiserType.NONE, DenoiserType.OFFLINE):
            raise NotImplementedError(
                f"{settings.denoiser}: the real-time modes are ROADMAP Queue 1 item 10"
            )
        if display_size is not None:
            raise NotImplementedError("display_size (upscale): ROADMAP Queue 1 item 13")
        if mesh is not None:
            raise NotImplementedError("mesh (sharded frames): ROADMAP Queue 1 item 14")
        self.settings = settings
        self.cfg = cfg
        self.fov_y = fov_y
        self.variants = settings.variants().check_supported()
        # ThicknessMode value: 2 (DepthNormals) lets back normals feed the
        # inside-object and back-hit normal flips.
        self.back_depth_enabled = int(settings.accurate_thickness.value)
        self.height, self.width = height, width
        self.device = torch.device(device)
        self.probes = (
            probes or ProbeSet(probe0=constant_probe([0.0, 0.0, 0.0], device=self.device))
        ).to(self.device)
        self.frame_index = 0
        self.paused = False
        self.max_sample = settings.maximum_samples
        self._tiles = None
        self._tiles_key = None  # (depth tensors held by reference, near, far)
        self.offline_state = OfflineAccumState.create(height, width, device=self.device)
        self._prev_vp: Optional[np.ndarray] = None
        self._scene_key = None

    def _check_invalidation(self, cam: Camera, scene_key=None):
        vp = cam.view_proj.detach().cpu().numpy()
        moved = self._prev_vp is not None and not np.allclose(vp, self._prev_vp)
        scene_changed = scene_key is not None and scene_key != self._scene_key
        if moved or scene_changed or self._prev_vp is None:
            self.offline_state.sample = 0
        self._prev_vp = vp
        self._scene_key = scene_key

    @property
    def sample(self) -> int:
        return self.offline_state.sample

    def _depth_sources(self, gb: GBuffers):
        """Every depth image the tiles read: layer-1 for the plain layout,
        each combo's test and back image for the dual one."""
        if not (self.variants.backface_textures or self.variants.support_refraction):
            return (gb.layer1_depth(),)
        return tuple(img for pair in variant_combos(gb, self.variants) for img in pair)

    def _get_tiles(self, gb: GBuffers, cam: Camera):
        """Depth tiles, rebuilt only when a depth image they read (by
        identity) or the clip range changes."""
        srcs = self._depth_sources(gb)
        near, far = float(cam.near), float(cam.far)
        key = self._tiles_key
        if (self._tiles is None or len(key[0]) != len(srcs)
                or any(a is not b for a, b in zip(key[0], srcs))
                or key[1:] != (near, far)):
            self._tiles = build_tiles_for(gb, cam, self.variants)
            self._tiles_key = (srcs, near, far)
        return self._tiles

    def render_frame(self, gb: GBuffers, cam: Camera, scene_key=None):
        """Render one frame; returns the displayed image (H, W, 3)."""
        if not self.settings.state:
            return gb.emission
        denoiser = self.settings.denoiser
        self._check_invalidation(cam, scene_key)
        if denoiser == DenoiserType.OFFLINE and self.sample >= self.max_sample:
            image = self.offline_state.accum
        else:
            traced = trace_frame_hiz(
                gb, cam, self.probes, self.settings, self.cfg, self.variants,
                self.frame_index, back_depth_enabled=self.back_depth_enabled,
                tiles=self._get_tiles(gb, cam),
            )
            self.offline_state = offline_accumulate(
                self.offline_state, traced, self.max_sample, self.paused
            )
            image = traced if denoiser == DenoiserType.NONE else self.offline_state.accum
        if denoiser == DenoiserType.OFFLINE and self.settings.progress_bar:
            image = add_convergence_cue(
                image, self.sample, self.max_sample, self.height, self.width
            )
        self.frame_index = advance_frame_index(self.frame_index)
        return image

    def save(self, path: str):
        state = {
            "frame_index": self.frame_index,
            "offline_accum": self.offline_state.accum.cpu().numpy(),
            "offline_sample": np.asarray(self.offline_state.sample),
        }
        if self._prev_vp is not None:
            state["prev_vp"] = self._prev_vp
        np.savez(path, **state)

    def load(self, path: str):
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        self.frame_index = int(data["frame_index"])
        self.offline_state = OfflineAccumState(
            accum=torch.as_tensor(data["offline_accum"]).to(self.device),
            sample=int(data["offline_sample"]),
        )
        if "prev_vp" in data:
            self._prev_vp = data["prev_vp"]
