"""The port's hiz march and frame against the JAX package, on the CPU.

The same BoxScene state (G-buffer, camera, depth tiles, probe) is
carried across with ``unitysspathtracingurp_tpu_torch.convert``, so both
sides compute from identical inputs; the port runs the plain PyTorch
versions of its kernels (CPU tensors). The JAX side runs as its own
tests run it off TPU: the unfused front half (Pallas interpret mode)
and the XLA resolve rounds, eagerly. Its fused kernel
``_fused_schedule_pack`` is held equal to that unfused front half by
tests/test_fused_schedule.py; interpreting it eagerly here would not
fit this file's time budget.

Tolerances, and why:
  * K1 packs (schedule_pack_ref vs the JAX unfused packs, 64x128
    lanes): n_cand and scode equal on >= 99.99% of entries, hist within
    one q40 code, cum within 1e-5 -- the gate of
    tests/test_fused_schedule.py:208-267. Two f32 op chains of the same
    math may still differ by an ulp (XLA:CPU may contract or reorder),
    which can flip a window-edge candidate.
  * R1 march (ray_march_hiz, 64x128 lanes): hit agreement >= 0.9995 and
    uv agreement >= 0.999 -- the gate of
    tests/test_fused_schedule.py:88-99, for the same reason.
  * Frames (trace_frame_hiz and a Renderer offline frame, 64x64, 2
    bounces): pooled relative RMSE < 1% and >= 99% of non-sky pixels
    within 1e-3 relative. Transcendentals (sin, cos, log2, sqrt) differ
    by ulps between XLA and torch, and a path whose roulette or window
    test sits on an edge takes another branch.
  * The hiz frame's variants, the same gate: step dithering with the
    headline caps against the JAX dithered frame; 2 and 3 samples a
    pixel with per-bounce round budgets (6, 2) against the mean of the
    JAX 1-spp frames f + s * (3 + 4 * maximum_depth), s < spp, with the
    HSV clamp out of reach (maximum_intensity 1e30). Under the hashed
    RNG sample s of frame f draws exactly the stream of sample 0 of
    that frame, so the mean is the JAX batched frame up to the order of
    its sums; the JAX package's batched samples through the hiz march
    would compile its interpret-mode kernels anew, too slowly for this
    file.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu.camera import linear_eye_depth, pixel_uv, world_from_uv_depth
from unitysspathtracingurp_tpu.config import DenoiserType, NoiseMethod, PTConfig, PTSettings
from unitysspathtracingurp_tpu.models import fixtures, scene
from unitysspathtracingurp_tpu.ops import pathtrace_hiz
from unitysspathtracingurp_tpu.ops.accumulate import add_convergence_cue, offline_accumulate
from unitysspathtracingurp_tpu.ops.accumulate import OfflineAccumState
from unitysspathtracingurp_tpu.ops.depth_tiles import build_depth_tiles
from unitysspathtracingurp_tpu.ops.blue_noise import BlueNoiseTables
from unitysspathtracingurp_tpu.ops.envprobe import ProbeSet, constant_probe

from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch.models import fixtures as tfixtures
from unitysspathtracingurp_tpu_torch.models import scene as tscene
from unitysspathtracingurp_tpu_torch.models.renderer import Renderer as TRenderer
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as tpathtrace_hiz
from unitysspathtracingurp_tpu_torch.ops.fused_schedule import (
    march_kwargs, schedule_pack, schedule_scalars,
)
from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

torch.set_num_threads(1)

MH, MW = 64, 128  # march lanes
FH = FW = 64  # frame
PROBE = [0.05, 0.06, 0.08]
BLUE_FRAME = 33 * 300  # epoch 1: the blue-noise rotation is on


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


def _port_tiles(tiles):
    return convert.depth_tiles(
        tiles.pair_table, tiles.mini_table, height=tiles.height, width=tiles.width,
        tiles_x=tiles.tiles_x, tiles_y=tiles.tiles_y, pairs_x=tiles.pairs_x,
        minis_x=tiles.minis_x, device="cpu",
    )


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def march_case():
    """BoxScene bounce-0 reflection rays with the tilt of
    tests/test_fused_schedule.py:36-61, marched by the JAX package."""
    sc = scene.build_box_scene()
    cam = fixtures.box_scene_camera(MH, MW)
    gb = fixtures.rasterize_gbuffers(sc, cam, MH, MW)
    uv = pixel_uv(MH, MW)
    depth = gb.depth
    pos_ws = world_from_uv_depth(cam.inv_view_proj, uv, depth)
    view_dir = pos_ws - cam.position
    view_dir = view_dir / jnp.linalg.norm(view_dir, axis=-1, keepdims=True)
    n = gb.normal
    refl = view_dir - 2.0 * jnp.sum(view_dir * n, -1, keepdims=True) * n
    tilt = jnp.stack([jnp.cos(uv[..., 0] * 7.0), jnp.sin(uv[..., 1] * 5.0),
                      jnp.cos(uv[..., 0] * 3.0)], -1)
    d = refl + 0.3 * tilt
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    alive = depth != 0.0
    origin = pos_ws + n * 1e-4
    scene_dist = linear_eye_depth(depth, cam.near, cam.far)
    zero = jnp.zeros((MH, MW), jnp.float32)
    settings = PTSettings(maximum_steps=24, dithering=False)
    cfg = PTConfig()
    tiles = build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)
    dbg = {}
    res = pathtrace_hiz.ray_march_hiz(
        cfg, settings, settings.variants(), gb, cam, origin, d, zero, zero,
        -view_dir, scene_dist, alive, tiles=tiles, n_rounds=10, _debug_out=dbg,
    )
    return dict(
        jax_res={k: np.asarray(v) for k, v in res._asdict().items()},
        jax_pk=[np.asarray(x) for x in dbg["c0_pk"]],
        jax_ncand=np.asarray(dbg["c0_n_cand"]).reshape(-1),
        gb=convert.gbuffers(_np_tree(gb), device="cpu"),
        cam=convert.camera(_np_tree(cam), device="cpu"),
        tiles=_port_tiles(tiles),
        origin=_t(origin), d=_t(d), alive=_t(alive), view_dir=_t(view_dir),
        scene_dist=_t(scene_dist), settings=settings, cfg=cfg,
    )


def test_schedule_pack_ref_matches_jax_packs(march_case):
    c = march_case
    cfg, settings, tiles = c["cfg"], c["settings"], c["tiles"]
    n = MH * MW
    large_step = settings.step_size + (20.0 - settings.step_size) * c["scene_dist"] * 0.001
    is_back = ((c["d"] * -c["view_dir"]).sum(-1) > 0.0).reshape(n)
    pk_cum, pk_scode, pk_hist, n_cand = schedule_pack(
        c["origin"].reshape(n, 3), c["d"].reshape(n, 3), torch.zeros(n),
        large_step.reshape(n), c["alive"].reshape(n), is_back,
        tiles.mini_table, schedule_scalars(c["cam"]), **march_kwargs(cfg, tiles, 24),
    )
    ref_cum, ref_scode, ref_hist = c["jax_pk"]
    assert (n_cand.numpy() == c["jax_ncand"]).mean() >= 0.9999
    same_scode = pk_scode.numpy() == ref_scode
    assert same_scode.mean() >= 0.9999, same_scode.mean()
    hist, ref_h = pk_hist.numpy()[same_scode], ref_hist[same_scode]
    assert np.abs(hist // 4096.0 - ref_h // 4096.0).max() <= 1.0
    assert np.abs(hist % 4096.0 - ref_h % 4096.0).max() <= 1.0
    assert np.abs(pk_cum.numpy() - ref_cum)[same_scode].max() < 1e-5
    assert (c["jax_ncand"] > 0).mean() > 0.2  # the case exercises the packs


def test_ray_march_hiz_matches_jax(march_case):
    c = march_case
    settings = c["settings"]
    from unitysspathtracingurp_tpu_torch.config import PTSettings as TSettings

    tsettings = TSettings(maximum_steps=24, dithering=False)
    zero = torch.zeros(MH, MW)
    res = tpathtrace_hiz.ray_march_hiz(
        convert.pt_config(c["cfg"]), tsettings, tsettings.variants(), c["gb"],
        c["cam"], c["origin"], c["d"], zero, zero, -c["view_dir"],
        c["scene_dist"], c["alive"], tiles=c["tiles"], n_rounds=10,
    )
    assert settings.maximum_steps == tsettings.maximum_steps
    f_hit, s_hit = res.hit.numpy(), c["jax_res"]["hit"]
    assert (f_hit == s_hit).mean() >= 0.9995, (f_hit == s_hit).mean()
    both = f_hit & s_hit
    assert both.mean() > 0.2  # the case exercises the resolve
    dd = np.abs(res.distance.numpy() - c["jax_res"]["distance"])[both]
    assert np.quantile(dd, 0.999) < 1e-4
    uv_same = np.abs(res.uv.numpy() - c["jax_res"]["uv"]).max(-1)[both] < 1e-6
    assert uv_same.mean() >= 0.999, uv_same.mean()


@pytest.fixture(scope="module")
def frame_case():
    """One JAX hiz frame at 64x64, 2 bounces, headline config, frame 0."""
    sc = scene.build_box_scene()
    cam = fixtures.box_scene_camera(FH, FW)
    gb = fixtures.rasterize_gbuffers(sc, cam, FH, FW)
    probes = ProbeSet(probe0=constant_probe(PROBE))
    settings = PTSettings(maximum_depth=2, maximum_steps=24, dithering=False,
                          denoiser=DenoiserType.OFFLINE, maximum_samples=64)
    cfg = PTConfig.boxscene_headline()
    traced = pathtrace_hiz.trace_frame_hiz(
        gb, cam, probes, settings, cfg, settings.variants(), jnp.uint32(0)
    )
    # Renderer frame 1 == _offline_step: accumulate, then the progress cue.
    state = offline_accumulate(OfflineAccumState.create(FH, FW), traced, 64)
    shown = add_convergence_cue(state.accum, state.sample, 64, FH, FW)
    return dict(
        traced=np.asarray(traced), shown=np.asarray(shown),
        non_sky=np.asarray(gb.depth) != 0.0,
        gb=convert.gbuffers(_np_tree(gb), device="cpu"),
        cam=convert.camera(_np_tree(cam), device="cpu"),
        probes=convert.probe_set(_np_tree(probes.probe0), device="cpu"),
        settings=convert.pt_settings(settings), cfg=convert.pt_config(cfg),
    )


def _assert_frame_close(port, ref, non_sky):
    assert np.isfinite(port).all()
    rel, within = frame_agreement(port, ref, non_sky)
    assert rel < 0.01, f"pooled relative RMSE {rel:.5f}"
    assert within >= 0.99, f"non-sky pixels within 1e-3: {within:.5f}"


def test_trace_frame_hiz_matches_jax(frame_case):
    c = frame_case
    s = c["settings"]
    out = tpathtrace_hiz.trace_frame_hiz(
        c["gb"], c["cam"], c["probes"], s, c["cfg"], s.variants(), 0
    )
    _assert_frame_close(out.numpy(), c["traced"], c["non_sky"])


def test_renderer_offline_frame_matches_jax(frame_case):
    c = frame_case
    r = TRenderer(c["settings"], FH, FW, cfg=c["cfg"], probes=c["probes"], device="cpu")
    out = r.render_frame(c["gb"], c["cam"])
    assert r.sample == 1 and r.frame_index == 33
    _assert_frame_close(out.numpy(), c["shown"], c["non_sky"])


def test_rasterizer_copy_matches_jax_fixtures():
    """The port's numpy rasterizer reproduces the JAX fixture G-buffer
    (both cast the same f32 primary rays; depth within 1e-6, since the
    JAX package may intersect through its native rasterizer)."""
    sc = scene.build_box_scene()
    cam = fixtures.box_scene_camera(32, 48)
    gb = fixtures.rasterize_gbuffers(sc, cam, 32, 48)
    tcam = convert.camera(_np_tree(cam), device="cpu")
    tgb = tfixtures.rasterize_gbuffers(tscene.build_box_scene(), tcam, 32, 48, device="cpu")
    assert np.abs(tgb.depth.numpy() - np.asarray(gb.depth)).max() < 1e-6
    for name in ("albedo", "gbuffer1", "smoothness", "emission"):
        assert np.array_equal(getattr(tgb, name).numpy(), np.asarray(getattr(gb, name)))
    assert np.array_equal(tgb.material_flags.numpy(), np.asarray(gb.material_flags))
    assert np.abs(tgb.normal.numpy() - np.asarray(gb.normal)).max() < 1e-5


@pytest.fixture(scope="module")
def hiz_variant_frames(frame_case):
    """JAX hiz frames for the variants (after ``frame_case``, which
    compiles the JAX hiz march's kernels in this process): the 1-spp
    frames f + s * 11 (s = 0, 1, 2) with round budgets (6, 2) and no
    reachable clamp, and a dithered frame with the headline caps."""
    sc = scene.build_box_scene()
    cam = fixtures.box_scene_camera(FH, FW)
    gb = fixtures.rasterize_gbuffers(sc, cam, FH, FW)
    probes = ProbeSet(probe0=constant_probe(PROBE))
    rounds = dataclasses.replace(PTConfig.boxscene_headline(), hiz_rounds=(6, 2))
    unclamped = PTSettings(maximum_depth=2, maximum_steps=24, maximum_intensity=1e30)
    samples = [
        np.asarray(pathtrace_hiz.trace_frame_hiz(gb, cam, probes, unclamped, rounds,
                                                 unclamped.variants(), jnp.uint32(11 * s)))
        for s in range(3)
    ]
    dithered = PTSettings(maximum_depth=2, maximum_steps=24, dithering=True)
    dither_frame = pathtrace_hiz.trace_frame_hiz(
        gb, cam, probes, dithered, PTConfig.boxscene_headline(), dithered.variants(),
        jnp.uint32(5))
    blue = PTSettings(maximum_depth=1, maximum_steps=24, dithering=False,
                      noise_method=NoiseMethod.BLUE_NOISE)
    blue_frame = pathtrace_hiz.trace_frame_hiz(
        gb, cam, probes, blue, PTConfig.boxscene_headline(), blue.variants(),
        jnp.uint32(BLUE_FRAME), rng_tables=BlueNoiseTables())
    return dict(samples=samples, dithered=np.asarray(dither_frame),
                rounds=convert.pt_config(rounds), unclamped=convert.pt_settings(unclamped),
                dithered_settings=convert.pt_settings(dithered),
                blue=np.asarray(blue_frame), blue_settings=convert.pt_settings(blue))


@pytest.mark.parametrize("spp", [2, 3])
def test_hiz_samples_per_pixel_match_jax(frame_case, hiz_variant_frames, spp):
    """The sample loop with a tuple round budget: every sample marches
    bounce b with budget b (6, then 2), as the JAX batched samples do."""
    c, v = frame_case, hiz_variant_frames
    s = dataclasses.replace(v["unclamped"], samples_per_pixel=spp)
    budgets = []
    real = tpathtrace_hiz.ray_march_hiz

    def spy(*args, **kw):
        budgets.append(kw["n_rounds"])
        return real(*args, **kw)

    tpathtrace_hiz.ray_march_hiz = spy
    try:
        out = tpathtrace_hiz.trace_frame_hiz(c["gb"], c["cam"], c["probes"], s, v["rounds"],
                                             s.variants(), 0)
    finally:
        tpathtrace_hiz.ray_march_hiz = real
    assert budgets == [6, 2] * spp
    ref = sum(v["samples"][:spp]) / spp
    _assert_frame_close(out.numpy(), ref, c["non_sky"])


def test_hiz_dithering_with_caps_matches_jax(frame_case, hiz_variant_frames):
    c, v = frame_case, hiz_variant_frames
    s = v["dithered_settings"]
    out = tpathtrace_hiz.trace_frame_hiz(c["gb"], c["cam"], c["probes"], s, c["cfg"],
                                         s.variants(), 5)
    _assert_frame_close(out.numpy(), v["dithered"], c["non_sky"])


def test_hiz_blue_noise_frame_matches_jax(frame_case, hiz_variant_frames):
    """A blue-noise hiz frame (K1 / R1 plain versions; S1's plain
    version draws from the port's committed tables) in epoch 1, with the
    headline caps, against the JAX frame on its own tables."""
    from unitysspathtracingurp_tpu_torch.ops.blue_noise import BlueNoiseTables as TTables

    c, v = frame_case, hiz_variant_frames
    s = v["blue_settings"]
    out = tpathtrace_hiz.trace_frame_hiz(c["gb"], c["cam"], c["probes"], s, c["cfg"],
                                         s.variants(), BLUE_FRAME,
                                         rng_tables=TTables(device="cpu"))
    _assert_frame_close(out.numpy(), v["blue"], c["non_sky"])
