"""Frame orchestrator (ScreenSpacePathTracingAccumulation.cs).

Offline mode (DenoiserType.OFFLINE, static camera): trace (pass 0) ->
progressive average (pass 3) -> progress bar (pass 4). NONE mode
returns the traced frame. Host control flow mirrors the C# side:
invalidation on camera or scene-key change (cs:772-823), pause, the
converged skip (cs:436-438), the depth-tiles cache, and save / load.

Real-time modes (TEMPORAL / SPATIAL_TEMPORAL): trace with adaptive spp
(pass 0) -> [SPATIAL_TEMPORAL] À-Trous x (2q + 1) (pass 5, kernel A1)
-> temporal reprojection (pass 1, kernel T1) -> the history update
(emission, color / count, depth). They neither run nor reset the
offline invalidation, as in the JAX package.

A frozen copy of the port's plain path for the benchmark's reference:
the hiz march only (the plain versions of K1 / R1 on the plain depth
tiles and, for refraction and back faces, of K4 / R1-dual on the dual
ones, as torch ops) and the hashed RNG. ``hdr_64bit=False`` is the
11-bit-float HDR target: a bf16 accumulator and color / emission
history, and a 64-sample budget. ``bind_probes`` binds the two probes
closest to the camera. What the copy leaves out (the parity march, the
home prefix, the unfused resolve, the samplers, upscaling, sharding)
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..camera import Camera, pixel_spread_angle_tangent
from ..config import MAX_SAMPLES_LOW_PRECISION, DenoiserType, PTConfig, PTSettings
from ..gbuffer import GBuffers
from ..ops.accumulate import OfflineAccumState, add_convergence_cue, offline_accumulate
from ..ops.atrous import atrous_filter
from ..ops.depth_tiles import variant_combos
from ..ops.envprobe import ProbeSet, constant_probe
from ..ops.pathtrace_hiz import build_tiles_for, trace_frame_hiz
from ..ops.rng import advance_frame_index
from ..ops.temporal import TemporalState, temporal_reproject
from .probes import closest_probes


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
        ``fov_y`` sets the temporal pass's pixel spread. ``kernel``:
        "auto" and "hiz" run the hiz march (the only one copied).
        ``hdr_64bit=False``: the accumulator and the color / emission
        history are bf16 and the offline budget caps at 64 samples
        (cs:810-814)."""
        settings.validate()
        if kernel not in ("auto", "hiz"):
            raise ValueError(f"kernel {kernel!r}: this copy has the hiz march only (auto|hiz)")
        if display_size is not None:
            raise NotImplementedError("display_size (upscale): ROADMAP Queue 1 item 13")
        if mesh is not None:
            raise NotImplementedError("mesh (sharded frames): ROADMAP Queue 1 item 14")
        self.settings = settings
        self.cfg = cfg
        self.fov_y = fov_y
        self.kernel = "hiz"
        self.variants = settings.variants()
        # ThicknessMode value: 2 (DepthNormals) lets back normals feed the
        # inside-object and back-hit normal flips.
        self.back_depth_enabled = int(settings.accurate_thickness.value)
        self.pixel_spread_tangent = pixel_spread_angle_tangent(fov_y, width, height)
        self.spatial_passes = (2 * settings.spatial_denoise_quality.value + 1
                               if settings.denoiser == DenoiserType.SPATIAL_TEMPORAL else 0)
        self.height, self.width = height, width
        self.device = torch.device(device)
        self.probes = (
            probes or ProbeSet(probe0=constant_probe([0.0, 0.0, 0.0], device=self.device))
        ).to(self.device)
        self.frame_index = 0
        self.paused = False
        self.max_sample = (settings.maximum_samples if hdr_64bit else
                           min(settings.maximum_samples, MAX_SAMPLES_LOW_PRECISION))
        self.accum_dtype = torch.float32 if hdr_64bit else torch.bfloat16
        self._tiles = None
        self._tiles_key = None  # (depth tensors held by reference, near, far)
        self.offline_state = OfflineAccumState.create(height, width, dtype=self.accum_dtype,
                                                      device=self.device)
        self.temporal_state: Optional[TemporalState] = None
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

    def bind_probes(self, probe_list, positions, cam: Camera):
        """Per-frame probe binding (PathTracingSetReflectionProbe.cs:49-83):
        the two probes closest to the camera become the tracer's
        environment fallback, moved to the Renderer's device."""
        self.probes = closest_probes(probe_list, positions,
                                     cam.position.detach().cpu().numpy(),
                                     device=self.device)

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

    def _trace(self, gb: GBuffers, cam: Camera, history_sample=None):
        """Pass 0 through the hiz march."""
        return trace_frame_hiz(
            gb, cam, self.probes, self.settings, self.cfg, self.variants,
            self.frame_index, back_depth_enabled=self.back_depth_enabled,
            tiles=self._get_tiles(gb, cam), history_sample=history_sample,
        )

    def _realtime(self, gb: GBuffers, cam: Camera):
        """One real-time frame (JAX ``renderer.py:94-134``): trace with
        adaptive spp, À-Trous x ``spatial_passes``, temporal
        reprojection, then the new history. The new history's depth and
        (f32) emission are the G-buffer's own tensors, and its (f32)
        color is the returned image's."""
        if self.temporal_state is None:
            self.temporal_state = TemporalState.create(
                self.height, self.width, cam, dtype=self.accum_dtype, device=self.device)
        state = self.temporal_state
        refr = self.variants.support_refraction
        color = self._trace(gb, cam, history_sample=state.history_sample)
        emission = gb.emission
        for _ in range(self.spatial_passes):
            color = atrous_filter(color, gb, emission, state.history_sample, self.cfg,
                                  support_refraction=refr)
        result = temporal_reproject(
            color, gb, cam, state, emission, self.cfg,
            temporal_intensity=self.settings.temporal_intensity,
            pixel_spread_angle_tangent=self.pixel_spread_tangent, support_refraction=refr)
        self.temporal_state = TemporalState(
            history_color=result.color.to(self.accum_dtype),
            history_sample=result.sample_count,
            history_depth=gb.layer1_depth(),
            history_emission=emission.to(self.accum_dtype),
            prev_inv_view_proj=cam.inv_view_proj,
            prev_view_proj=cam.view_proj,
            prev_camera_position=cam.position,
        )
        return result.color

    def render_frame(self, gb: GBuffers, cam: Camera, scene_key=None):
        """Render one frame; returns the displayed image (H, W, 3)."""
        if not self.settings.state:
            return gb.emission
        denoiser = self.settings.denoiser
        if denoiser in (DenoiserType.TEMPORAL, DenoiserType.SPATIAL_TEMPORAL):
            image = self._realtime(gb, cam)
        else:
            self._check_invalidation(cam, scene_key)
            if denoiser == DenoiserType.OFFLINE and self.sample >= self.max_sample:
                image = self.offline_state.accum
            else:
                traced = self._trace(gb, cam)
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
            # f32 holds a bf16 accumulator exactly (numpy has no bf16).
            "offline_accum": self.offline_state.accum.float().cpu().numpy(),
            "offline_sample": np.asarray(self.offline_state.sample),
        }
        if self._prev_vp is not None:
            state["prev_vp"] = self._prev_vp
        if self.temporal_state is not None:
            for f in dataclasses.fields(TemporalState):
                state[f"temporal_{f.name}"] = (
                    getattr(self.temporal_state, f.name).float().cpu().numpy())
        np.savez(path, **state)

    def load(self, path: str):
        # A path, or an open file (the benchmark loads a snapshot from memory).
        named = isinstance(path, str) and not path.endswith(".npz")
        data = np.load(path + ".npz" if named else path)
        self.frame_index = int(data["frame_index"])
        self.offline_state = OfflineAccumState(
            accum=torch.as_tensor(data["offline_accum"]).to(self.device, self.accum_dtype),
            sample=int(data["offline_sample"]),
        )
        if "prev_vp" in data:
            self._prev_vp = data["prev_vp"]
        if "temporal_history_color" in data:
            low = ("history_color", "history_emission")
            self.temporal_state = TemporalState(**{
                f.name: torch.as_tensor(data[f"temporal_{f.name}"]).to(
                    self.device, self.accum_dtype if f.name in low else torch.float32)
                for f in dataclasses.fields(TemporalState)
            })
