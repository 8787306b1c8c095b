"""The refraction / backface slice of the port against the JAX package, on the CPU.

Scene: the 64x64 glass BoxScene (IOR-1.45 sphere, no mirror) with the
backface pass. The JAX G-buffer, camera and depth tables are carried
across with ``unitysspathtracingurp_tpu_torch.convert``, so both sides
compute from identical inputs; the port runs its kernels' plain PyTorch
versions (CPU tensors). The JAX side runs as its own tests run it off
TPU: eagerly, with the unfused dual front half (Pallas interpret mode)
and the XLA resolve rounds. Each JAX reference is computed once per
module.

The gated values each test observed print with ``pytest -rP``.

Tolerances, and why:
  * bit-exact: the dual depth tables (u32 words), the packed
    transparent / back-normal words, the raster layers (both sides cast
    the same f32 rays through the same numpy intersection; the JAX
    package's optional native rasterizer is switched off for that test);
  * 1e-7 absolute for the unpacked surface decode, 1e-6 for the packed
    one (the gate of tests/test_torch_units.py: the oct-decode
    normalisation may differ by a few ulps);
  * 2e-6: refract and the refraction lobe of evaluate_brdf (sqrt, exp,
    sin and cos from different math libraries, a few ulps at order 1;
    relative for energies, since the exit gain exp(albedo * dist) is
    large);
  * K4 packs (schedule_pack_dual_ref vs the JAX unfused dual packs):
    the K1 gate of tests/test_torch_march.py, n_cand and scode equal on
    >= 99.99% of entries, hist within one q40 code on <= 8 entries, cum
    within 1e-5;
  * the dual march (n_rounds=10): hit and is_back_hit agreement
    >= 0.9995, uv >= 0.999, distance within 1e-5 where both hit;
  * a 3-bounce frame and a 2-frame OFFLINE Renderer run: pooled relative
    RMSE < 1% and >= 99% of non-sky pixels within 1e-3 relative. A path
    whose roulette or window test sits on an ulp edge takes another
    branch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu import gbuffer as jgbuffer
from unitysspathtracingurp_tpu import gbuffer_packed as jpacked
from unitysspathtracingurp_tpu.camera import linear_eye_depth, pixel_uv, world_from_uv_depth
from unitysspathtracingurp_tpu.config import DenoiserType, PTConfig, PTSettings, ThicknessMode
from unitysspathtracingurp_tpu.models import fixtures, native_raster, scene
from unitysspathtracingurp_tpu.ops import brdf as jbrdf
from unitysspathtracingurp_tpu.ops import depth_tiles as jtiles
from unitysspathtracingurp_tpu.ops import pathtrace as jpathtrace
from unitysspathtracingurp_tpu.ops import pathtrace_hiz
from unitysspathtracingurp_tpu.ops import rng as jrng
from unitysspathtracingurp_tpu.ops.accumulate import (
    OfflineAccumState, add_convergence_cue, offline_accumulate,
)
from unitysspathtracingurp_tpu.ops.envprobe import ProbeSet, constant_probe

from unitysspathtracingurp_tpu_torch import camera as tcamera
from unitysspathtracingurp_tpu_torch import config as tconfig
from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch import gbuffer as tgbuffer
from unitysspathtracingurp_tpu_torch import gbuffer_packed as tpacked
from unitysspathtracingurp_tpu_torch.models import fixtures as tfixtures
from unitysspathtracingurp_tpu_torch.models import scene as tscene
from unitysspathtracingurp_tpu_torch.models.renderer import Renderer as TRenderer
from unitysspathtracingurp_tpu_torch.ops import accumulate as taccum
from unitysspathtracingurp_tpu_torch.ops import brdf as tbrdf
from unitysspathtracingurp_tpu_torch.ops import depth_tiles as ttiles
from unitysspathtracingurp_tpu_torch.ops import envprobe as tenv
from unitysspathtracingurp_tpu_torch.ops import pathtrace as tpathtrace
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as tpathtrace_hiz
from unitysspathtracingurp_tpu_torch.ops import rng as trng
from unitysspathtracingurp_tpu_torch.ops.fused_schedule import (
    march_kwargs, schedule_pack_dual_ref, schedule_scalars,
)
from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

torch.set_num_threads(1)

H = W = 64
PROBE = [0.05, 0.06, 0.08]
RS = np.random.default_rng(2024)
# (refraction, backface, inside) march cases of tests/test_hiz_dual.py:142-148.
MARCH_CASES = [(True, False, 0.0), (True, False, 2.0), (False, True, 0.0),
               (True, True, 0.0), (True, True, 1.0)]


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


def _t(a):
    return torch.as_tensor(np.array(a))


def _settings(refraction, backface, **kw):
    """JAX settings of a variant set; ``convert.pt_settings`` carries them."""
    return PTSettings(
        maximum_steps=24, dithering=False, support_refraction=refraction,
        accurate_thickness=(ThicknessMode.DEPTH_NORMALS if backface
                            else ThicknessMode.CONSTANT), **kw)


@pytest.fixture(scope="module")
def glass():
    """The JAX glass box, and its G-buffer and camera carried across."""
    sc = scene.build_box_scene(with_glass=True, with_mirror=False)
    cam = fixtures.box_scene_camera(H, W)
    gb = fixtures.rasterize_gbuffers(sc, cam, H, W, with_backface=True)
    return dict(gb=gb, cam=cam, tgb=convert.gbuffers(_np_tree(gb), device="cpu"),
                tcam=convert.camera(_np_tree(cam), device="cpu"))


def _port_dual_tiles(t):
    return convert.dual_depth_tiles(
        t.tile_table, t.mini_table, t.bmax_table, height=t.height, width=t.width,
        tiles_x=t.tiles_x, tiles_y=t.tiles_y, minis_x=t.minis_x, n_combos=t.n_combos,
        device="cpu")


# ---------------------------------------------------------------- (1) dual tables


@pytest.mark.parametrize("refraction,backface,n_combos", [
    (False, True, 1), (True, False, 2), (True, True, 3),
])
def test_dual_depth_tiles_bit_exact(glass, refraction, backface, n_combos):
    jv = _settings(refraction, backface).variants()
    jt = pathtrace_hiz.build_tiles_for(glass["gb"], glass["cam"], jv)
    tt = tpathtrace_hiz.build_tiles_for(glass["tgb"], glass["tcam"], convert.pt_variants(jv))
    assert isinstance(tt, ttiles.DualDepthTiles) and tt.n_combos == jt.n_combos == n_combos
    for name in ("tile_table", "mini_table", "bmax_table"):
        assert np.array_equal(getattr(tt, name).numpy(),
                              np.asarray(getattr(jt, name)).view(np.int32)), name
    assert (tt.tiles_x, tt.tiles_y, tt.minis_x, tt.tiles_per_combo, tt.chunks_per_combo) == (
        jt.tiles_x, jt.tiles_y, jt.minis_x, jt.tiles_per_combo, jt.chunks_per_combo)
    ix, iy = RS.integers(0, W, 300), RS.integers(0, H, 300)
    for got, ref in zip(ttiles.tile_of(_t(ix), _t(iy), tt.tiles_x),
                        jtiles.tile_of(jnp.asarray(ix), jnp.asarray(iy), jt)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(ttiles.unpack_dual(tt.tile_table.reshape(-1)[::7]),
                        jtiles.unpack_dual(jt.tile_table.reshape(-1)[::7])):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(ttiles.unpack_f16_low(tt.bmax_table.reshape(-1)).numpy(),
                          np.asarray(jtiles.unpack_f16_low(jt.bmax_table.reshape(-1))))


# ---------------------------------------------------------------- (2) raster layers, packed words


def test_raster_layers_and_packed_words_exact(glass, monkeypatch):
    monkeypatch.setattr(native_raster, "intersect_scene_native", lambda *a, **k: None)
    jgb = fixtures.rasterize_gbuffers(scene.build_box_scene(with_glass=True, with_mirror=False),
                                      glass["cam"], H, W, with_backface=True)
    tgb = tfixtures.rasterize_gbuffers(
        tscene.build_box_scene(with_glass=True, with_mirror=False), glass["tcam"], H, W,
        device="cpu", with_backface=True)
    for name in ("depth", "depth_layer1", "back_depth", "back_normal", "t_albedo",
                 "t_ior_raw", "t_surface_type", "t_normal", "t_smoothness"):
        got, ref = getattr(tgb, name).numpy(), np.asarray(getattr(jgb, name))
        assert np.array_equal(got, ref.astype(got.dtype)), name
    assert (np.asarray(jgb.t_surface_type) == 2).mean() > 0.05  # the glass is on screen
    assert (np.asarray(jgb.back_depth) != 0).mean() > 0.05
    jp, tp = jpacked.pack_gbuffers(glass["gb"]), tpacked.pack_gbuffers(glass["tgb"])
    for name in ("packs", "t_packs", "bn_pack"):
        assert np.array_equal(getattr(tp, name).numpy(),
                              np.asarray(getattr(jp, name)).astype(np.int64)), name


# ---------------------------------------------------------------- (3) surface decodes


@pytest.mark.parametrize("inside_val", [0.0, 1.0, 2.0])
def test_surface_decode_inside_states_match_jax(glass, inside_val):
    """Transparent decode, back-normal flip and the insideObject state
    machine (0 -> 1 -> 2 -> 0), unpacked and packed, direct and gathered."""
    jgb, tgb = glass["gb"], glass["tgb"]
    jv = _settings(True, True).variants()
    tv = convert.pt_variants(jv)
    uv = RS.uniform(0, 1, (H, W, 2)).astype(np.float32)
    inside = np.full((H, W), inside_val, np.float32)
    jp, tp = jpacked.pack_gbuffers(jgb), tpacked.pack_gbuffers(tgb)
    for direct in (True, False):
        ju, tu, ji = jnp.asarray(uv), _t(uv), jnp.asarray(inside)
        pairs = (
            (tgbuffer.hit_surface_from_gbuffer(tgb, tu, _t(inside), tv, 2, direct=direct),
             jgbuffer.hit_surface_from_gbuffer(jgb, ju, ji, jv, 2, direct=direct)),
            (tpacked.hit_surface_from_packed(tp, tu, _t(inside), tv, 2, direct=direct),
             jpacked.hit_surface_from_packed(jp, ju, ji, jv, 2, direct=direct)),
        )
        for (got, ref), atol in zip(pairs, (1e-7, 1e-6)):
            for f in dataclasses.fields(got):
                np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                           np.asarray(getattr(ref, f.name)), rtol=0,
                                           atol=atol, err_msg=f.name)
    t_frac = (np.asarray(ref.ior) != -1.0).mean()
    assert (t_frac == 0.0) if inside_val == 2.0 else (t_frac > 0.02)


# ---------------------------------------------------------------- (4) refraction lobe


def test_refract_and_refraction_lobe_match_jax():
    rs = np.random.default_rng(7)
    h, w = 30, 100
    n = h * w

    def units(k):
        v = rs.normal(size=(k, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    inc, nrm = units(n), units(n)
    nrm = np.where((inc * nrm).sum(-1, keepdims=True) > 0, -nrm, nrm).astype(np.float32)
    eta = rs.choice(np.float32([1.45, 1 / 1.45, 2.5]), n).astype(np.float32)
    jd, jok = jbrdf.refract(jnp.asarray(inc), jnp.asarray(nrm), jnp.asarray(eta))
    td, tok = tbrdf.refract(_t(inc), _t(nrm), _t(eta))
    assert np.array_equal(tok.numpy(), np.asarray(jok)) and 0.05 < tok.float().mean() < 0.95
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-6, atol=2e-6)

    surf = dict(
        albedo=rs.uniform(0.05, 0.95, (h, w, 3)), specular=rs.uniform(0, 0.5, (h, w, 3)),
        normal=nrm.reshape(h, w, 3), emission=rs.uniform(0, 2, (h, w, 3)),
        smoothness=rs.uniform(0, 1, (h, w)),
        ior=np.where(rs.uniform(size=(h, w)) < 0.7, 1.45, -1.0),
        inside_object=rs.integers(0, 3, (h, w)),
    )
    surf = {k: v.astype(np.float32) for k, v in surf.items()}
    hit = rs.uniform(size=(h, w)) < 0.9
    lanes = dict(
        ray_dir=inc.reshape(h, w, 3), ray_pos=rs.uniform(-2, 2, (h, w, 3)).astype(np.float32),
        energy=rs.uniform(0.1, 1, (h, w, 3)).astype(np.float32), hit=hit,
        hit_pos=rs.uniform(-2, 2, (h, w, 3)).astype(np.float32),
        hit_dist=rs.uniform(0, 6, (h, w)).astype(np.float32),
        primary_pos=rs.uniform(-2, 2, (h, w, 3)).astype(np.float32),
    )
    jv = _settings(True, True).variants()
    jr = jpathtrace.evaluate_brdf(
        PTConfig(), jv, jrng.make_rng(h, w, 99),
        surf=jgbuffer.SurfaceData(**{k: jnp.asarray(v) for k, v in surf.items()}),
        probes=ProbeSet(probe0=constant_probe(PROBE)),
        **{k: jnp.asarray(v) for k, v in lanes.items()})
    tr = tpathtrace.evaluate_brdf(
        tconfig.PTConfig(), convert.pt_variants(jv), trng.make_rng(h, w, 99, device="cpu"),
        surf=tgbuffer.SurfaceData(**{k: _t(v) for k, v in surf.items()}),
        probes=tenv.ProbeSet(probe0=tenv.constant_probe(PROBE, device="cpu")),
        **{k: _t(v) for k, v in lanes.items()})
    for name in ("direction", "position", "energy", "radiance"):
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                   rtol=2e-6, atol=2e-6, err_msg=name)
    # The lanes exercise the exit gain of inside == 2 refraction.
    exiting = hit & (surf["ior"] != -1.0) & (surf["inside_object"] == 2.0)
    assert (np.asarray(jr.energy)[exiting] > 2.0).any()


# ---------------------------------------------------------------- (5, 6) K4 packs and the dual march


def _march_inputs(gb, cam, inside_val):
    """Bounce-0 reflection rays with the tilt of tests/test_hiz_dual.py:65-87."""
    uv = pixel_uv(H, W)
    pos_ws = world_from_uv_depth(cam.inv_view_proj, uv, gb.depth)
    view_dir = pos_ws - cam.position
    view_dir = view_dir / jnp.linalg.norm(view_dir, axis=-1, keepdims=True)
    n = gb.normal
    refl = view_dir - 2.0 * jnp.sum(view_dir * n, -1, keepdims=True) * n
    tilt = jnp.stack([jnp.cos(uv[..., 0] * 7.0), jnp.sin(uv[..., 1] * 5.0),
                      jnp.cos(uv[..., 0] * 3.0)], -1)
    d = refl + 0.3 * tilt
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return dict(origin=pos_ws + n * 1e-4, d=d, alive=gb.depth != 0.0, view_dir=view_dir,
                scene_dist=linear_eye_depth(gb.depth, cam.near, cam.far),
                inside=jnp.full((H, W), inside_val, jnp.float32))


@pytest.fixture(scope="module")
def dual_marches(glass):
    """The JAX dual march (unfused, with its debug packs) per case."""
    out = {}
    for refraction, backface, inside_val in MARCH_CASES:
        settings = _settings(refraction, backface)
        variants = settings.variants()
        tiles = pathtrace_hiz.build_tiles_for(glass["gb"], glass["cam"], variants)
        x = _march_inputs(glass["gb"], glass["cam"], inside_val)
        dbg = {}
        res = pathtrace_hiz.ray_march_hiz(
            PTConfig(), settings, variants, glass["gb"], glass["cam"], x["origin"], x["d"],
            x["inside"], jnp.zeros((H, W), jnp.float32), -x["view_dir"], x["scene_dist"],
            x["alive"], tiles=tiles, n_rounds=10, _debug_out=dbg)
        out[(refraction, backface, inside_val)] = dict(
            res={k: np.asarray(v) for k, v in res._asdict().items()},
            pk=[np.asarray(a) for a in dbg["c0_pk"]],
            n_cand=np.asarray(dbg["c0_n_cand"]).reshape(-1),
            tiles=_port_dual_tiles(tiles), settings=convert.pt_settings(settings),
            x={k: _t(v) for k, v in x.items()},
        )
    return out


def _k4_inputs(case, tcam, variants):
    x, tiles, s = case["x"], case["tiles"], case["settings"]
    n = H * W
    inside = x["inside"].reshape(n)
    back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
    combo = {1: torch.zeros(n, dtype=torch.int32), 2: (inside != 0.0).to(torch.int32),
             3: torch.clamp(inside.to(torch.int32), 0, 2)}[tiles.n_combos]
    search = back | (inside == 2.0) if variants.support_refraction else back
    large_step = s.step_size + (20.0 - s.step_size) * x["scene_dist"] * 0.001
    args = (x["origin"].reshape(n, 3), x["d"].reshape(n, 3), torch.zeros(n),
            large_step.reshape(n), x["alive"].reshape(n), combo, search,
            tiles.mini_table, tiles.bmax_table, schedule_scalars(tcam))
    kw = dict(march_kwargs(tconfig.PTConfig(), tiles, 24),
              chunks_per_combo=tiles.chunks_per_combo)
    return args, kw


@pytest.mark.parametrize("case", [(True, True, 0.0), (True, True, 1.0), (True, False, 0.0)])
def test_schedule_pack_dual_ref_matches_jax_packs(glass, dual_marches, case):
    c = dual_marches[case]
    args, kw = _k4_inputs(c, glass["tcam"], c["settings"].variants())
    pk_cum, pk_scode, pk_hist, pk_step, n_cand = schedule_pack_dual_ref(*args, **kw)
    ref_cum, ref_scode, ref_hist = c["pk"]
    same_n = (n_cand.numpy() == c["n_cand"]).mean()
    same = pk_scode.numpy() == ref_scode
    hist, ref_h = pk_hist.numpy()[same], ref_hist[same]
    flips = (hist // 4096.0 != ref_h // 4096.0) | (hist % 4096.0 != ref_h % 4096.0)
    codes = max(np.abs(hist // 4096.0 - ref_h // 4096.0).max(),
                np.abs(hist % 4096.0 - ref_h % 4096.0).max())
    cum_err = np.abs(pk_cum.numpy() - ref_cum)[same].max()
    print(f"K4 packs {case}: n_cand equal {same_n:.6f}, scode equal {same.mean():.6f}, "
          f"hist flips {flips.sum()} (max {codes:.0f} code), cum max err {cum_err:.3e}")
    assert same_n >= 0.9999 and same.mean() >= 0.9999
    assert flips.sum() <= 8 and codes <= 1.0
    assert cum_err < 1e-5
    assert (c["n_cand"] > 0).mean() > 0.2  # the case exercises the packs
    # pk_step holds q40 codes of the step sizes the schedule reaches.
    live = np.arange(16)[:, None] < n_cand.numpy()[None]
    steps = pk_step.numpy()[live]
    assert np.array_equal(steps, np.round(steps)) and steps.min() >= 0.0
    assert np.array_equal(pk_step.numpy()[~live], np.zeros((~live).sum(), np.float32))


@pytest.mark.parametrize("case", MARCH_CASES)
def test_dual_ray_march_hiz_matches_jax(glass, dual_marches, case):
    c = dual_marches[case]
    x, s = c["x"], c["settings"]
    res = tpathtrace_hiz.ray_march_hiz(
        tconfig.PTConfig(), s, s.variants(), glass["tgb"], glass["tcam"], x["origin"], x["d"],
        x["inside"], torch.zeros(H, W), -x["view_dir"], x["scene_dist"], x["alive"],
        tiles=c["tiles"], n_rounds=10)
    ref = c["res"]
    hit, ref_hit = res.hit.numpy(), ref["hit"]
    both = hit & ref_hit
    back_same = (res.is_back_hit.numpy() == ref["is_back_hit"]).mean()
    dist_err = np.abs(res.distance.numpy() - ref["distance"])[both].max()
    uv_same = (np.abs(res.uv.numpy() - ref["uv"]).max(-1)[both] < 1e-6).mean()
    print(f"dual march {case}: hit agreement {(hit == ref_hit).mean():.6f}, is_back_hit "
          f"{back_same:.6f}, uv {uv_same:.6f}, distance max err {dist_err:.3e}, both hit "
          f"{both.mean():.4f}, back hits {ref['is_back_hit'].mean():.4f}")
    assert (hit == ref_hit).mean() >= 0.9995 and back_same >= 0.9995
    assert both.mean() > 0.1  # the case exercises the resolve
    assert dist_err < 1e-5
    assert uv_same >= 0.999


# ---------------------------------------------------------------- (7) frame and Renderer


@pytest.fixture(scope="module")
def dual_frames(glass):
    """Two JAX dual frames (3 bounces, refraction + DepthNormals) and
    what a 2-frame OFFLINE Renderer run shows after them."""
    probes = ProbeSet(probe0=constant_probe(PROBE))
    settings = _settings(True, True, maximum_depth=3, samples_per_pixel=1,
                         denoiser=DenoiserType.OFFLINE, maximum_samples=64)
    cfg = PTConfig()
    state = OfflineAccumState.create(H, W)
    traced = []
    for fi in (0, 33):
        traced.append(pathtrace_hiz.trace_frame_hiz(
            glass["gb"], glass["cam"], probes, settings, cfg, settings.variants(),
            jnp.uint32(fi), back_depth_enabled=2))
        state = offline_accumulate(state, traced[-1], 64)
    shown = add_convergence_cue(state.accum, state.sample, 64, H, W)
    return dict(traced=np.asarray(traced[0]), shown=np.asarray(shown),
                non_sky=np.asarray(glass["gb"].layer1_depth()) != 0.0,
                settings=convert.pt_settings(settings), cfg=convert.pt_config(cfg),
                probes=convert.probe_set(_np_tree(probes.probe0), device="cpu"))


def _assert_frame_close(port, ref, non_sky):
    assert np.isfinite(port).all()
    rel, within = frame_agreement(port, ref, non_sky)
    print(f"frame: pooled relative RMSE {rel:.3e}, non-sky pixels within 1e-3 {within:.6f}, "
          f"max abs diff {np.abs(port - ref).max():.3e}")
    assert rel < 0.01, f"pooled relative RMSE {rel:.5f}"
    assert within >= 0.99, f"non-sky pixels within 1e-3: {within:.5f}"


def test_dual_trace_frame_hiz_matches_jax(glass, dual_frames):
    c = dual_frames
    s = c["settings"]
    out = tpathtrace_hiz.trace_frame_hiz(glass["tgb"], glass["tcam"], c["probes"], s,
                                         c["cfg"], s.variants(), 0, back_depth_enabled=2)
    _assert_frame_close(out.numpy(), c["traced"], c["non_sky"])


def test_dual_renderer_offline_frames_match_jax(glass, dual_frames):
    c = dual_frames
    r = TRenderer(c["settings"], H, W, cfg=c["cfg"], probes=c["probes"], device="cpu")
    assert r.back_depth_enabled == 2
    for _ in range(2):
        out = r.render_frame(glass["tgb"], glass["tcam"])
    assert r.sample == 2 and r.frame_index == 66 and r._tiles.n_combos == 3
    _assert_frame_close(out.numpy(), c["shown"], c["non_sky"])


def test_dual_tiles_cache_keys_every_depth_image(glass):
    """The Renderer rebuilds the dual tiles when any depth image they read
    changes, not only the layer-1 depth."""
    s = convert.pt_settings(_settings(True, True, maximum_depth=1,
                                      denoiser=DenoiserType.OFFLINE, maximum_samples=4))
    r = TRenderer(s, H, W, device="cpu")
    gb = glass["tgb"]
    first = r._get_tiles(gb, glass["tcam"])
    assert r._get_tiles(gb, glass["tcam"]) is first
    gb2 = dataclasses.replace(gb, back_depth=gb.back_depth.clone())
    assert r._get_tiles(gb2, glass["tcam"]) is not first


# ---------------------------------------------------------------- (8) entry points default to the card


@pytest.mark.parametrize("entry", [
    "renderer", "box_scene_camera", "rasterize_gbuffers", "make_camera", "constant_probe",
    "offline_state", "convert_camera",
])
def test_entry_points_default_to_the_card(entry):
    """Called without ``device``, an entry point puts its tensors on the
    card; where torch has no CUDA device that raises, never falls back."""
    calls = {
        "renderer": lambda: TRenderer(tconfig.PTSettings(maximum_depth=1), 16, 16).device,
        "box_scene_camera": lambda: tfixtures.box_scene_camera(16, 16).view_proj.device,
        "rasterize_gbuffers": lambda: tfixtures.rasterize_gbuffers(
            tscene.build_box_scene(), tfixtures.box_scene_camera(16, 16, device="cpu"),
            16, 16).depth.device,
        "make_camera": lambda: tcamera.make_camera(
            [0, 1, 5], [0, 1, 0], [0, 1, 0], 0.8, 1.0, 0.1, 100.0).position.device,
        "constant_probe": lambda: tenv.constant_probe(PROBE).texture.device,
        "offline_state": lambda: taccum.OfflineAccumState.create(4, 4).accum.device,
        "convert_camera": lambda: convert.camera(_np_tree(fixtures.box_scene_camera(8, 8))
                                                 ).view.device,
    }
    if torch.cuda.is_available():
        assert calls[entry]().type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            calls[entry]()
