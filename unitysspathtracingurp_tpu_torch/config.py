"""Configuration: the three tiers of ``unitysspathtracingurp_tpu.config``.

``PTConfig`` (tracer constants), ``PTVariants`` (shader-keyword axes) and
``PTSettings`` (runtime volume settings) keep the JAX package's fields,
defaults and ``validate()`` ranges. The TPU-only lowering knobs
(``march_unroll``, ``packed_temporal``, ``fused_schedule``,
``pallas_extract``) are gone: they changed how XLA/Mosaic compiled the
same math, and PyTorch has no such choice to make.

Behaviour knobs whose code paths are not ported yet stay as fields, so a
configuration carries over field by field, but ``PTVariants.
check_supported`` (and the entry points, for settings) raises
``NotImplementedError`` naming the ROADMAP item that ports them instead
of silently running something else.
"""

from __future__ import annotations

import dataclasses
import enum


class NoiseMethod(enum.Enum):
    HASHED_RANDOM = 0
    BLUE_NOISE = 1
    SOBOL_OWEN = 2


class DenoiserType(enum.Enum):
    NONE = 0
    OFFLINE = 1
    TEMPORAL = 2
    SPATIAL_TEMPORAL = 3


class SpatialDenoiseQuality(enum.Enum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2


class ThicknessMode(enum.Enum):
    CONSTANT = 0
    DEPTH_ONLY = 1
    DEPTH_NORMALS = 2


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """Tracer constants (reference: PathTracingConfig.hlsl:41-98)."""

    max_small_step: int = 6
    max_medium_step: int = 18
    small_step_size: float = 0.005
    medium_step_size: float = 0.1
    marching_thickness: float = 0.4
    marching_thickness_small: float = 0.0075  # dead in the reference
    marching_thickness_medium: float = 0.1  # dead in the reference
    ray_bias: float = 1.0e-4
    use_disney_diffuse: bool = True
    max_accum_frame_num: int = 8
    ray_count_low_sample: int = 4
    max_reprojection_distance: float = 0.02
    max_pixel_tolerance: float = 4.0
    projection_epsilon: float = 1.0e-6
    reflection_history_rejection_threshold: float = 0.75
    roughness_accumulation_threshold: float = 0.5
    spec_accum_curve: float = 1.0
    spec_accum_base_power: float = 1.0
    clamp_max: float = 65472.0
    step_growth: float = 0.1
    thickness_growth: float = 0.25
    # Bounce hits decode from the bit-packed G-buffer (gbuffer_packed.py).
    use_packed_gbuffer: bool = True
    # Between-bounce lane compaction: caps[b] is bounce b's lane capacity
    # as a fraction of the pixel count (last entry extends); None = off.
    compaction_caps: tuple | None = None
    # Resolve-round lane compaction: after one dense round, the rounds
    # run on at most this fraction of the lanes (unresolved lanes first;
    # those past the capacity finalize as misses); None = off.
    hiz_round_cap: float | None = None
    # Candidates tested per fetched 32x8-px depth window per round.
    hiz_chain: int = 4
    # Resolve-round budget: None = default_rounds(h, w); an int; or a
    # tuple of per-bounce budgets (last entry extends).
    hiz_rounds: int | tuple | None = None
    # Home-prefix resolve (kernel K6) on bounce 0 of a screen-ordered
    # frame: None or False = off, True = on.
    hiz_home_prefix: bool | None = None
    # With the home prefix on, the rounds run compacted from round 0 at
    # this lane fraction; None = dense rounds.
    hiz_home_round_cap: float | None = None

    @classmethod
    def boxscene_headline(cls) -> "PTConfig":
        """The BoxScene 1080p production config (the JAX package's
        ``PTConfig.boxscene_headline``): measured zero-drop caps."""
        return cls(compaction_caps=(1.0, 0.34, 0.21, 0.15))


@dataclasses.dataclass(frozen=True)
class PTVariants:
    """Static variant axes (reference: ScreenSpacePathTracing.shader:47-55)."""

    temporal_accumulation: bool = False
    blue_noise: bool = False
    sobol_owen: bool = False
    support_refraction: bool = False
    backface_textures: bool = False
    ignore_forward_objects: bool = False
    gbuffer_normals_oct: bool = False

    def check_supported(self) -> "PTVariants":
        if self.blue_noise or self.sobol_owen:
            raise NotImplementedError(
                "blue-noise / Sobol-Owen samplers: ROADMAP Queue 1 item 11"
            )
        if self.temporal_accumulation:
            raise NotImplementedError(
                "temporal accumulation: ROADMAP Queue 1 item 10"
            )
        if self.gbuffer_normals_oct or self.ignore_forward_objects:
            raise NotImplementedError(
                "oct-encoded G-buffer normals / forward-only objects: "
                "ROADMAP Queue 1 item 3b"
            )
        return self


@dataclasses.dataclass(frozen=True)
class PTSettings:
    """Runtime settings (reference: PathTracingVolume.cs:17-71)."""

    state: bool = True
    maximum_samples: int = 256
    maximum_depth: int = 4
    maximum_intensity: float = 10.0
    samples_per_pixel: int = 1
    maximum_steps: int = 24
    step_size: float = 0.4
    noise_method: NoiseMethod = NoiseMethod.HASHED_RANDOM
    denoiser: DenoiserType = DenoiserType.NONE
    accum_factor: float = 0.9
    accurate_thickness: ThicknessMode = ThicknessMode.CONSTANT
    spatial_denoise_quality: SpatialDenoiseQuality = SpatialDenoiseQuality.MEDIUM
    support_refraction: bool = False
    progress_bar: bool = True
    dithering: bool = False
    dither_intensity: float = 1.0
    ignore_forward_objects: bool = False
    gbuffer_normals_oct: bool = False

    def validate(self) -> "PTSettings":
        def _check(name, value, lo, hi):
            if not (lo <= value <= hi):
                raise ValueError(f"{name}={value} outside [{lo}, {hi}]")

        _check("maximum_samples", self.maximum_samples, 4, 512)
        _check("maximum_depth", self.maximum_depth, 1, 16)
        _check("samples_per_pixel", self.samples_per_pixel, 1, 16)
        _check("maximum_steps", self.maximum_steps, 16, 64)
        _check("step_size", self.step_size, 0.1, 1.0)
        _check("accum_factor", self.accum_factor, 0.5, 1.0)
        if self.maximum_intensity < 0.1:
            raise ValueError("maximum_intensity must be >= 0.1")
        return self

    def variants(self) -> PTVariants:
        return PTVariants(
            temporal_accumulation=self.denoiser
            in (DenoiserType.TEMPORAL, DenoiserType.SPATIAL_TEMPORAL),
            blue_noise=self.noise_method == NoiseMethod.BLUE_NOISE,
            sobol_owen=self.noise_method == NoiseMethod.SOBOL_OWEN,
            support_refraction=self.support_refraction,
            backface_textures=self.accurate_thickness != ThicknessMode.CONSTANT,
            ignore_forward_objects=self.ignore_forward_objects,
            gbuffer_normals_oct=self.gbuffer_normals_oct,
        )


FRAME_INDEX_STRIDE = 33
FRAME_INDEX_MOD = 64000
