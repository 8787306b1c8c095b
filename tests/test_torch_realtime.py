"""The real-time slice of the port against the JAX package, on the CPU:
the camera's pixel spread, the hashed random float, bilinear history
reads, motion vectors, À-Trous (A1's plain version), temporal
reprojection (T1's plain version), adaptive spp and the Renderer's
SPATIAL_TEMPORAL mode.

Inputs are made from a numpy seed and carried across with
``unitysspathtracingurp_tpu_torch.convert``; each JAX reference is
computed once per module (eagerly, except the traced frames).

Tolerances, and why:
  * bit-exact: the pixel spread, the hash, the dilation radius, the
    bilinear reads at negative and > 1 uv, the motion vectors (both
    sides run the same numpy or integer arithmetic);
  * À-Trous: 1e-5 relative. XLA:CPU's exp is its own approximation and a
    jitted XLA program contracts a * b + c into FMAs, so weights differ
    by ulps;
  * temporal: a pixel counts as flipped when one of its branch decisions
    (can_reproject, rough_ok, use_rough) differs, its count differs by
    more than 1e-6 or its color by more than 1e-5 relative; at most 0.1%
    of the pixels may flip. XLA:CPU's exp2, log and pow differ from
    torch's by a few ulps (only ~11% of exp2 values agree bit for bit),
    and the smooth branch reads the history bilinearly at the virtual uv
    that pow and log move: on a noisy history a uv change of a few ulps
    moves the read by ~1e-5 of the history's value (0-2 pixels of 2304
    in these cases). The flipped pixels' colors stay within 1e-4;
  * adaptive spp and the Renderer: the frame gate of
    tests/test_torch_march.py (pooled relative RMSE < 1% and >= 99% of
    non-sky pixels within 1e-3 relative) for the traced frame; the
    Renderer's frames within 1e-5 pooled relative RMSE and counts equal
    on >= 99.9% of the pixels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu import camera as jcamera
from unitysspathtracingurp_tpu.config import (
    DenoiserType, PTConfig, PTSettings, SpatialDenoiseQuality,
)
from unitysspathtracingurp_tpu.models import fixtures, scene
from unitysspathtracingurp_tpu.models.renderer import Renderer as JRenderer
from unitysspathtracingurp_tpu.ops import atrous as jatrous
from unitysspathtracingurp_tpu.ops import envprobe as jenv
from unitysspathtracingurp_tpu.ops import pathtrace as jpathtrace
from unitysspathtracingurp_tpu.ops import rng as jrng
from unitysspathtracingurp_tpu.ops import temporal as jtemporal

from unitysspathtracingurp_tpu_torch import camera as tcamera
from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch.config import DenoiserType as TDenoiser
from unitysspathtracingurp_tpu_torch.config import PTSettings as TSettings
from unitysspathtracingurp_tpu_torch.models import fixtures as tfixtures
from unitysspathtracingurp_tpu_torch.models import scene as tscene
from unitysspathtracingurp_tpu_torch.models.renderer import Renderer as TRenderer
from unitysspathtracingurp_tpu_torch.ops import atrous as tatrous
from unitysspathtracingurp_tpu_torch.ops import envprobe as tenv
from unitysspathtracingurp_tpu_torch.ops import pathtrace as tpathtrace
from unitysspathtracingurp_tpu_torch.ops import rng as trng
from unitysspathtracingurp_tpu_torch.ops import temporal as ttemporal
from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement, relative_rmse

torch.set_num_threads(1)

H = W = 48
PROBE = [0.05, 0.06, 0.08]
FLIP_SHARE = 0.001


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


def _carry(gb, cam):
    return convert.gbuffers(_np_tree(gb), device="cpu"), convert.camera(_np_tree(cam), device="cpu")


# ---------------------------------------------------------------- helpers


def test_pixel_spread_angle_tangent_matches_jax():
    for fov, w, h in ((np.radians(60.0), 1920, 1080), (np.radians(45.0), 32, 48), (1.0, 7, 7)):
        assert (tcamera.pixel_spread_angle_tangent(fov, w, h)
                == jcamera.pixel_spread_angle_tangent(fov, w, h))


@pytest.mark.parametrize("row_offset", [0, 17, 4093])
def test_hashed_random_float_bit_exact(row_offset):
    xs = np.arange(64, dtype=np.uint32)
    ys = np.arange(40, dtype=np.uint32) + np.uint32(row_offset)
    px, py = np.meshgrid(xs, ys)
    for z in (1, 7, 0xFFFFFFFF):
        ref = np.asarray(jrng.hashed_random_float(jnp.asarray(px), jnp.asarray(py), jnp.uint32(z)))
        got = trng.hashed_random_float(torch.as_tensor(px.astype(np.int64)),
                                       torch.as_tensor(py.astype(np.int64)), z)
        np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    radius = tatrous.dilation_radius(40, 64, row_offset, "cpu").numpy()
    rnd = jrng.hashed_random_float(jnp.asarray(px), jnp.asarray(py), jnp.uint32(1))
    np.testing.assert_array_equal(radius, np.floor(3.0 + 6.0 * np.asarray(rnd)).astype(np.int64))
    assert radius.min() >= 3 and radius.max() <= 9


@pytest.mark.parametrize("channels,size", [(3, (5, 7)), (1, (6, 4)), (3, (1, 1))])
def test_sample_bilinear_matches_jax(channels, size):
    rs = np.random.default_rng(3)
    tex = rs.uniform(-1, 2, size + (channels,)).astype(np.float32)
    uv = rs.uniform(-0.6, 1.7, (9, 11, 2)).astype(np.float32)
    uv[0, :3] = [[-0.0, 0.0], [1.0, 1.0], [-1e-8, 1.0 + 1e-7]]
    ref = np.asarray(jenv.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv)))
    got = tenv.sample_bilinear(torch.as_tensor(tex), torch.as_tensor(uv)).numpy()
    np.testing.assert_array_equal(got, ref)
    bf = torch.as_tensor(tex).to(torch.bfloat16)
    ref = np.asarray(jenv.sample_bilinear(jnp.asarray(tex).astype(jnp.bfloat16), jnp.asarray(uv)))
    got = tenv.sample_bilinear(bf, torch.as_tensor(uv))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("which", ["box", "classroom"])
def test_motion_vectors_match_jax(which):
    """rasterize_gbuffers(prev_cam=): exact zeros for an unmoved camera,
    the moved camera's reprojection elsewhere (sky reprojects the far
    plane), bit for bit."""
    if which == "box":
        jsc, tsc, make = scene.build_box_scene(), tscene.build_box_scene(), fixtures.box_scene_camera
    else:
        jsc, tsc = scene.build_classroom_scene(), tscene.build_classroom_scene()
        make = fixtures.classroom_camera
    cam, prev = make(H, W), make(H, W, jitter=0.05)
    tcam, tprev = (convert.camera(_np_tree(c), device="cpu") for c in (cam, prev))
    for jprev, tp in ((prev, tprev), (cam, tcam)):
        ref = np.asarray(fixtures.rasterize_gbuffers(jsc, cam, H, W, prev_cam=jprev).motion)
        got = tfixtures.rasterize_gbuffers(tsc, tcam, H, W, device="cpu", prev_cam=tp).motion
        np.testing.assert_array_equal(got.numpy(), ref)
    assert np.abs(ref).max() == 0.0
    assert tfixtures.rasterize_gbuffers(tsc, tcam, H, W, device="cpu").motion is None


def test_cameras_match_jax():
    for name in ("classroom_camera", "figure_camera", "plane_scene_camera"):
        kw = {} if name == "plane_scene_camera" else {"jitter": 0.05}
        ref = getattr(fixtures, name)(H, W, **kw)
        got = getattr(tfixtures, name)(H, W, device="cpu", **kw)
        for f in ("position", "view_proj", "inv_view_proj"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- scenes


@pytest.fixture(scope="module")
def scenes():
    """JAX G-buffers of the current and previous cameras (the current
    frame's with motion vectors), carried across."""
    out = {}
    for name, sc, make, moves in (
        ("classroom", scene.build_classroom_scene(), fixtures.classroom_camera,
         {"static": 0.0, "moved": 0.05, "jump": None}),
        ("mirror", scene.build_box_scene(), fixtures.box_scene_camera, {"moved": 0.08}),
        ("glass", scene.build_box_scene(with_glass=True, with_mirror=False),
         fixtures.box_scene_camera, {"moved": 0.08}),
    ):
        cam = make(H, W)
        for move, jitter in moves.items():
            prev = make(H, W, jitter=jitter) if move != "jump" else _turned_camera()
            gb = fixtures.rasterize_gbuffers(sc, cam, H, W, prev_cam=prev)
            pgb = fixtures.rasterize_gbuffers(sc, prev, H, W)
            out[(name, move)] = dict(gb=gb, cam=cam, prev=prev, pgb=pgb,
                                     port=_carry(gb, cam))
    return out


def _turned_camera():
    """The classroom camera turned 50 degrees to the left: a jump after
    which most pixels reproject off screen."""
    return jcamera.make_camera(eye=[0.0, 1.6, 4.2], target=[-5.2, 1.2, 0.0], up=[0.0, 1.0, 0.0],
                               fov_y=np.radians(60.0), aspect=W / H, near=0.1, far=100.0)


def _noisy(rs, shape, hi=2.0):
    return rs.uniform(0.0, hi, shape).astype(np.float32)


# ---------------------------------------------------------------- À-Trous

ATROUS_CASES = {
    "mixed counts": ("classroom", (0, 1, 5, 8, 9), False, 0),
    "count 0": ("classroom", (0,), False, 0),
    "count 5": ("classroom", (5,), False, 0),
    "count 8": ("classroom", (8,), False, 0),
    "count 9": ("classroom", (9,), False, 0),
    "glass, refraction": ("glass", (0, 1, 5), True, 0),
    "row offset 17": ("classroom", (0, 1, 5, 8), False, 17),
}


@pytest.mark.parametrize("case", list(ATROUS_CASES))
def test_atrous_filter_ref_matches_jax(scenes, case):
    name, counts, refr, row_offset = ATROUS_CASES[case]
    s = scenes[(name, "moved")]
    rs = np.random.default_rng(11)
    color = _noisy(rs, (H, W, 3))
    count = rs.choice(np.asarray(counts, np.float32), (H, W))
    cfg = PTConfig()
    ref = np.asarray(jatrous.atrous_filter(
        jnp.asarray(color), s["gb"], s["gb"].emission, jnp.asarray(count), cfg,
        support_refraction=refr, row_offset=row_offset))
    tgb = s["port"][0]
    got = tatrous.atrous_filter(torch.as_tensor(color), tgb, tgb.emission,
                                torch.as_tensor(count), convert.pt_config(cfg),
                                support_refraction=refr, row_offset=row_offset).numpy()
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)
    moved = np.any(ref != color, axis=-1).mean()
    print(f"{case}: max relative {rel.max():.3e}, pixels filtered {moved:.4f}")
    assert rel.max() <= 1e-5
    if 9 in counts and len(counts) == 1:
        np.testing.assert_array_equal(got, color)  # blur 0: every pixel passes through
    else:
        assert moved > 0.5


# ---------------------------------------------------------------- temporal

TEMPORAL_CASES = {
    "static camera": ("classroom", "static", "f32", False),
    "translated camera": ("classroom", "moved", "f32", False),
    "camera jump": ("classroom", "jump", "f32", False),
    "emission change": ("classroom", "moved", "f32", "emission"),
    "mirror (smooth branch)": ("mirror", "moved", "f32", False),
    "glass guides": ("glass", "moved", "f32", "refraction"),
    "bf16 history": ("classroom", "moved", "bf16", False),
}


def _temporal_inputs(s, hist_dtype, emission_change, seed=5):
    """(current, JAX state, port state): noisy current and history color,
    counts 0 / 1 / 3 / 5 / 8 / 9, the previous camera's depth and
    emission (brightened in a block for the emission change)."""
    rs = np.random.default_rng(seed)
    current = _noisy(rs, (H, W, 3))
    hist_color = _noisy(rs, (H, W, 3))
    counts = rs.choice(np.asarray([0, 1, 3, 5, 8, 9], np.float32), (H, W))
    emis = np.array(s["pgb"].emission)
    if emission_change:
        emis[H // 4:H // 2, W // 4:3 * W // 4] += 1.5
    jdt = jnp.bfloat16 if hist_dtype == "bf16" else jnp.float32
    jstate = jtemporal.TemporalState.create(H, W, s["prev"]).replace(
        history_color=jnp.asarray(hist_color).astype(jdt),
        history_sample=jnp.asarray(counts),
        history_depth=s["pgb"].layer1_depth(),
        history_emission=jnp.asarray(emis).astype(jdt),
    )
    tdt = torch.bfloat16 if hist_dtype == "bf16" else torch.float32
    tstate = ttemporal.TemporalState(**{
        k: torch.as_tensor(np.asarray(v, np.float32)).to(
            tdt if k in ("history_color", "history_emission") else torch.float32)
        for k, v in dataclasses.asdict(jstate).items()
    })
    return current, jstate, tstate


@pytest.mark.parametrize("case", list(TEMPORAL_CASES))
def test_temporal_reproject_ref_matches_jax(scenes, case):
    name, move, hist_dtype, extra = TEMPORAL_CASES[case]
    s = scenes[(name, move)]
    refr = extra == "refraction"
    current, jstate, tstate = _temporal_inputs(s, hist_dtype, extra == "emission")
    cfg = PTConfig(packed_temporal=False)
    intensity, spread = PTSettings().temporal_intensity, jcamera.pixel_spread_angle_tangent(
        np.radians(60.0), W, H)
    ref = jtemporal.temporal_reproject(jnp.asarray(current), s["gb"], s["cam"], jstate,
                                       s["gb"].emission, cfg, intensity, spread,
                                       support_refraction=refr)
    tgb, tcam = s["port"]
    decisions = {}
    got = ttemporal.temporal_reproject_ref(torch.as_tensor(current), tgb, tcam, tstate,
                                           tgb.emission, convert.pt_config(cfg), intensity,
                                           spread, support_refraction=refr,
                                           _decisions=decisions)
    ref_color, ref_count = np.asarray(ref.color), np.asarray(ref.sample_count)
    color, count = got.color.numpy(), got.sample_count.numpy()
    # The JAX decisions, recomputed from its outputs where they show:
    # rough_ok / can_reproject give counts > 1, and a pixel the
    # decisions pass through keeps its current color.
    ref_accum = ref_count > 1.0
    accum = count > 1.0
    rel = (np.abs(color - ref_color) / np.maximum(np.abs(ref_color), 1e-6)).max(-1)
    flipped = (accum != ref_accum) | (np.abs(count - ref_count) > 1e-6) | (rel > 1e-5)
    share = flipped.mean()
    d = {k: float(v.float().mean()) for k, v in decisions.items()}
    print(f"{case}: flipped {flipped.sum()} of {flipped.size} ({share:.4f}), max relative "
          f"{rel.max():.3e} (unflipped {rel[~flipped].max(initial=0.0):.3e}); shares {d}")
    assert np.isfinite(color).all() and color.dtype == np.float32
    assert share <= FLIP_SHARE
    assert rel.max() <= 1e-4
    # The branches the case is about occur.
    smooth = ~decisions["use_rough"] & decisions["can_reproject"]
    assert decisions["rough_ok"].any()
    if move == "jump":
        assert d["can_reproject"] < 0.3
    else:
        assert smooth.any()
    if name == "mirror":
        assert smooth.sum() >= 50


# ---------------------------------------------------------------- adaptive spp


def test_adaptive_spp_trace_frame_matches_jax():
    """trace_frame with a history_sample of 0 / 1 / 3 under TEMPORAL:
    smooth or one-sample pixels take 4 samples, the others 1. Lane
    compaction at 0.75 (2048 of the 2304 lanes) carries each lane's
    1 / ray count."""
    h = w = 48
    sc = scene.build_box_scene()
    cam = fixtures.box_scene_camera(h, w)
    gb = fixtures.rasterize_gbuffers(sc, cam, h, w)
    probes = jenv.ProbeSet(probe0=jenv.constant_probe(PROBE))
    settings = PTSettings(maximum_depth=1, maximum_steps=24, dithering=False,
                          denoiser=DenoiserType.TEMPORAL)
    cfg = PTConfig(march_unroll=1, compaction_caps=(0.75,))
    hist = np.random.default_rng(9).choice(np.asarray([0, 1, 3], np.float32), (h, w))
    ref = np.asarray(jax.jit(lambda fi, hs: jpathtrace.trace_frame(
        gb, cam, probes, settings, cfg, settings.variants(), fi, history_sample=hs))(
            jnp.uint32(33), jnp.asarray(hist)))
    tgb, tcam = _carry(gb, cam)
    ts = convert.pt_settings(settings)
    tprobes = convert.probe_set(_np_tree(probes.probe0), device="cpu")
    got = tpathtrace.trace_frame(tgb, tcam, tprobes, ts, convert.pt_config(cfg), ts.variants(),
                                 33, march_fn=tpathtrace.ray_march,
                                 history_sample=torch.as_tensor(hist)).numpy()
    plain = tpathtrace.trace_frame(tgb, tcam, tprobes, ts, convert.pt_config(cfg),
                                   ts.variants(), 33, march_fn=tpathtrace.ray_march).numpy()
    non_sky = np.asarray(gb.depth) != 0.0
    rel, within = frame_agreement(got, ref, non_sky)
    boosted = ((np.asarray(gb.smoothness) > 0.5) | (hist == 1.0)) & non_sky
    print(f"adaptive spp: pooled relative RMSE {rel:.3e}, within 1e-3 {within:.6f}, "
          f"boosted {boosted.mean():.4f}")
    assert rel < 0.01 and within >= 0.99
    assert 0.1 < boosted.mean() < 0.9
    # Pixels on one sample are the frame without a history; boosted ones differ.
    np.testing.assert_array_equal(got[~boosted & non_sky], plain[~boosted & non_sky])
    assert not np.array_equal(got[boosted], plain[boosted])


# ---------------------------------------------------------------- the slice


def test_renderer_spatial_temporal_matches_jax(tmp_path):
    """Renderer(SPATIAL_TEMPORAL, LOW, kernel xla) for 3 frames of a
    moving camera (alternating cameras, each G-buffer with its motion to
    the other) against the JAX Renderer; then a save / load round trip
    of the temporal state."""
    h = w = 32
    sc = scene.build_classroom_scene()
    cams = [fixtures.classroom_camera(h, w, jitter=j) for j in (0.0, 0.05)]
    gbs = [fixtures.rasterize_gbuffers(sc, cams[i], h, w, prev_cam=cams[1 - i]) for i in (0, 1)]
    probes = jenv.ProbeSet(probe0=jenv.constant_probe(PROBE))
    settings = PTSettings(maximum_depth=2, maximum_steps=24, dithering=False,
                          denoiser=DenoiserType.SPATIAL_TEMPORAL,
                          spatial_denoise_quality=SpatialDenoiseQuality.LOW)
    cfg = PTConfig(ray_count_low_sample=1, march_unroll=1)
    jr = JRenderer(settings, h, w, cfg=cfg, probes=probes, kernel="xla")
    ts, tcfg = convert.pt_settings(settings), convert.pt_config(cfg)
    tprobes = convert.probe_set(_np_tree(probes.probe0), device="cpu")
    tr = TRenderer(ts, h, w, cfg=tcfg, probes=tprobes, kernel="xla", device="cpu")
    assert tr.spatial_passes == jr.spatial_passes == 1
    assert tr.pixel_spread_tangent == jr.pixel_spread_tangent
    port = [_carry(gb, cam) for gb, cam in zip(gbs, cams)]
    for frame in range(3):
        i = frame % 2
        ref = np.asarray(jr.render_frame(gbs[i], cams[i]))
        got = tr.render_frame(*port[i]).numpy()
        rel = relative_rmse(got, ref)
        same = np.mean(tr.temporal_state.history_sample.numpy()
                       == np.asarray(jr.temporal_state.history_sample))
        print(f"frame {frame}: pooled relative RMSE {rel:.3e}, counts equal {same:.6f}")
        assert np.isfinite(got).all()
        assert rel <= 1e-5 and same >= 0.999
    assert tr.frame_index == jr.frame_index and tr.sample == 0
    path = str(tmp_path / "rt.npz")
    tr.save(path)
    back = TRenderer(ts, h, w, cfg=tcfg, probes=tprobes, kernel="xla", device="cpu")
    back.load(path)
    for f in dataclasses.fields(ttemporal.TemporalState):
        assert torch.equal(getattr(back.temporal_state, f.name),
                           getattr(tr.temporal_state, f.name)), f.name
    assert torch.equal(back.render_frame(*port[1]), tr.render_frame(*port[1]))


def test_realtime_renderer_without_card_raises():
    """The entry points default to the card: without one, and without
    device="cpu", the real-time Renderer raises rather than running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    s = TSettings(denoiser=TDenoiser.TEMPORAL)
    with pytest.raises((RuntimeError, AssertionError)):
        TRenderer(s, 16, 16)
    with pytest.raises((RuntimeError, AssertionError)):
        ttemporal.TemporalState.create(16, 16, tfixtures.classroom_camera(16, 16, device="cpu"))
