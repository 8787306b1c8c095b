"""Module-by-module checks of the PyTorch port against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.
Tolerances, and why:
  * bit-exact: the RNG stream, the depth tables, the packed G-buffer
    words, compaction maps, pixel grids (integer or exactly rounded math
    on identical inputs);
  * ulp-level (rtol/atol ~1e-6): camera matrices and projections, where
    XLA and torch may order a 3-term sum or a LAPACK inverse differently;
  * 2e-6 absolute: BRDF sampling and the HSV clamp, whose sin, cos, sqrt
    and pow come from different math libraries (a few ulps at values
    of order 1).
"""

import dataclasses
import inspect
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu import camera as jcamera
from unitysspathtracingurp_tpu import config as jconfig
from unitysspathtracingurp_tpu import gbuffer as jgbuffer
from unitysspathtracingurp_tpu import gbuffer_packed as jpacked
from unitysspathtracingurp_tpu.models import fixtures as jfixtures
from unitysspathtracingurp_tpu.models.renderer import Renderer as JRenderer
from unitysspathtracingurp_tpu.models import scene as jscene
from unitysspathtracingurp_tpu.ops import accumulate as jaccum
from unitysspathtracingurp_tpu.ops import brdf as jbrdf
from unitysspathtracingurp_tpu.ops import depth_tiles as jtiles
from unitysspathtracingurp_tpu.ops import envprobe as jenv
from unitysspathtracingurp_tpu.ops import blue_noise as jblue
from unitysspathtracingurp_tpu.ops import rng as jrng
from unitysspathtracingurp_tpu.ops.pathtrace import _compact_indices
from unitysspathtracingurp_tpu.utils import image as jimage

import unitysspathtracingurp_tpu_torch as port_pkg
from unitysspathtracingurp_tpu_torch import camera as tcamera
from unitysspathtracingurp_tpu_torch import config as tconfig
from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch import gbuffer as tgbuffer
from unitysspathtracingurp_tpu_torch import gbuffer_packed as tpacked
from unitysspathtracingurp_tpu_torch.models import fixtures as tfixtures
from unitysspathtracingurp_tpu_torch.models import scene as tscene
from unitysspathtracingurp_tpu_torch.models.renderer import Renderer
from unitysspathtracingurp_tpu_torch.ops import accumulate as taccum
from unitysspathtracingurp_tpu_torch.ops import blue_noise as tblue
from unitysspathtracingurp_tpu_torch.ops import brdf as tbrdf
from unitysspathtracingurp_tpu_torch.ops import depth_tiles as ttiles
from unitysspathtracingurp_tpu_torch.ops import envprobe as tenv
from unitysspathtracingurp_tpu_torch.ops import rng as trng
from unitysspathtracingurp_tpu_torch.ops.fused_schedule import schedule_pack, schedule_pack_dual
from unitysspathtracingurp_tpu_torch.ops.pathtrace import brdf_lanes, compact_indices
from unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz import _link, resolve_rounds, resolve_rounds_dual
from unitysspathtracingurp_tpu_torch.ops import temporal as ttemporal
from unitysspathtracingurp_tpu_torch.ops.atrous import atrous_filter
from unitysspathtracingurp_tpu_torch.ops.temporal import temporal_reproject
from unitysspathtracingurp_tpu_torch.utils import image as timage

torch.set_num_threads(1)
RS = np.random.default_rng(1234)


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def unit_vectors(n, rs):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


@pytest.fixture(scope="module")
def box():
    """BoxScene G-buffer + camera from the JAX fixtures, carried across."""
    cam = jfixtures.box_scene_camera(40, 96)
    gb = jfixtures.rasterize_gbuffers(jscene.build_box_scene(), cam, 40, 96)
    return (gb, cam, convert.gbuffers(np_tree(gb), device="cpu"),
            convert.camera(np_tree(cam), device="cpu"))


# ---------------------------------------------------------------- config


def test_config_fields_and_defaults_match():
    dropped = {"march_unroll", "packed_temporal", "fused_schedule"}
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.PTConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.PTConfig)}
    assert set(jf) - set(tf) == dropped and set(tf) <= set(jf)
    assert all(tf[k] == jf[k] for k in tf)
    for cls in ("PTSettings", "PTVariants"):
        jd = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, cls))}
        td = {f.name: f.default for f in dataclasses.fields(getattr(tconfig, cls))}
        assert list(jd) == list(td)
        assert all(getattr(td[k], "value", td[k]) == getattr(jd[k], "value", jd[k]) for k in jd)
    assert convert.pt_config(jconfig.PTConfig.boxscene_headline()) == (
        tconfig.PTConfig.boxscene_headline()
    )
    s = jconfig.PTSettings(maximum_depth=3, denoiser=jconfig.DenoiserType.OFFLINE)
    assert convert.pt_settings(s).variants() == convert.pt_variants(s.variants())
    assert (tconfig.FRAME_INDEX_STRIDE, tconfig.FRAME_INDEX_MOD) == (33, 64000)


@pytest.mark.parametrize("field,value", [
    ("maximum_samples", 3), ("maximum_depth", 17), ("samples_per_pixel", 0),
    ("maximum_steps", 65), ("step_size", 0.05), ("accum_factor", 0.4),
    ("maximum_intensity", 0.01),
])
def test_settings_validate_ranges(field, value):
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError):
            mod.PTSettings(**{field: value}).validate()


@pytest.mark.parametrize("cfg_kw,settings_kw", [
    ({"hiz_home_prefix": True}, {"noise_method": tconfig.NoiseMethod.SOBOL_OWEN}),
    ({"hiz_round_cap": 0.4}, {"denoiser": tconfig.DenoiserType.SPATIAL_TEMPORAL,
                              "noise_method": tconfig.NoiseMethod.SOBOL_OWEN}),
    ({}, {"gbuffer_normals_oct": True, "noise_method": tconfig.NoiseMethod.BLUE_NOISE}),
    ({}, {"noise_method": tconfig.NoiseMethod.BLUE_NOISE}),
    ({}, {"denoiser": tconfig.DenoiserType.TEMPORAL,
          "noise_method": tconfig.NoiseMethod.BLUE_NOISE}),
    ({}, {"ignore_forward_objects": True, "denoiser": tconfig.DenoiserType.TEMPORAL,
          "noise_method": tconfig.NoiseMethod.SOBOL_OWEN}),
])
def test_sampler_settings_build_like_jax(cfg_kw, settings_kw):
    """The samplers, beside the resolve knobs and the other variants
    (oct normals, forward-only objects, the real-time modes): the
    variants equal the JAX package's, and the Renderer builds, with its
    blue-noise tables in that mode."""
    settings = tconfig.PTSettings(**settings_kw)
    jsettings = jconfig.PTSettings(**{
        k: (getattr(jconfig, type(v).__name__)(v.value) if hasattr(v, "value") else v)
        for k, v in settings_kw.items()})
    assert dataclasses.asdict(settings.variants()) == dataclasses.asdict(jsettings.variants())
    r = Renderer(settings, 16, 16, cfg=tconfig.PTConfig(**cfg_kw), device="cpu")
    blue = settings.noise_method == tconfig.NoiseMethod.BLUE_NOISE
    assert (r.rng_tables is not None) == blue
    if blue:
        assert r.rng_tables.sobol.device.type == "cpu"


@pytest.mark.parametrize("kw,item", [({"display_size": (32, 32)}, "item 13"),
                                     ({"mesh": object()}, "item 14")])
def test_unported_knobs_raise(kw, item):
    """What is still unported raises, naming its ROADMAP item: render-scale
    upscaling and the sharded frame."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        Renderer(tconfig.PTSettings(), 16, 16, device="cpu", **kw)


@pytest.mark.parametrize("kw,raises,match", [
    ({}, None, None),
    ({"hdr_64bit": False}, None, None),
    ({"kernel": "xla"}, None, None),
    ({"kernel": "bogus"}, ValueError, "unknown kernel"),
])
def test_renderer_takes_the_jax_keywords(kw, raises, match):
    """The JAX Renderer's arguments in its order and with its defaults,
    then ``device``; ``hdr_64bit=False`` gives the bf16 accumulator,
    ``kernel="xla"`` the parity march, an unknown kernel raises."""
    jax_params = list(inspect.signature(JRenderer.__init__).parameters.values())
    port_params = list(inspect.signature(Renderer.__init__).parameters.values())
    assert [p.name for p in port_params] == [p.name for p in jax_params] + ["device"]
    for jp, tp in zip(jax_params[6:], port_params[6:]):
        assert tp.default == jp.default, tp.name
    s = tconfig.PTSettings(maximum_depth=1)
    if not kw:
        r = Renderer(s, 16, 16, tconfig.PTConfig(), None, np.radians(45.0), True, None, None,
                     "hiz", device="cpu")
        assert r.fov_y == np.radians(45.0)
        assert Renderer(s, 16, 16, device="cpu").fov_y == np.radians(60.0)
    if raises is None:
        r = Renderer(s, 16, 16, device="cpu", **kw)
        low = kw.get("hdr_64bit") is False
        assert r.offline_state.accum.dtype == (torch.bfloat16 if low else torch.float32)
        assert r.max_sample == (64 if low else s.maximum_samples)
        assert r.kernel == kw.get("kernel", "hiz")
    else:
        with pytest.raises(raises, match=match):
            Renderer(s, 16, 16, device="cpu", **kw)


# ---------------------------------------------------------------- camera


def test_make_camera_matches_jax():
    args = ([0.3, 1.8, 6.5], [0.0, 1.5, 0.0], [0.0, 1.0, 0.0], np.radians(50.0), 1.7, 0.1, 100.0)
    jc, tc = jcamera.make_camera(*args), tcamera.make_camera(*args, device="cpu")
    for name in ("position", "view", "proj", "view_proj", "inv_view_proj", "near", "far"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), rtol=2e-6, atol=2e-6
        )


def test_projections_match_jax(box):
    _, jc, _, tc = box
    p = RS.uniform(-3, 3, (500, 3)).astype(np.float32) + np.float32([0, 2, 0])
    np.testing.assert_allclose(
        tcamera.world_to_ndc(tc.view_proj, T(p)).numpy(),
        np.asarray(jcamera.world_to_ndc(jc.view_proj, J(p))), rtol=1e-6, atol=1e-7,
    )
    uv = RS.uniform(0, 1, (500, 2)).astype(np.float32)
    raw = RS.uniform(0.001, 1, 500).astype(np.float32)
    np.testing.assert_allclose(
        tcamera.world_from_uv_depth(tc.inv_view_proj, T(uv), T(raw)).numpy(),
        np.asarray(jcamera.world_from_uv_depth(jc.inv_view_proj, J(uv), J(raw))),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        tcamera.linear_eye_depth(T(raw), tc.near, tc.far).numpy(),
        np.asarray(jcamera.linear_eye_depth(J(raw), jc.near, jc.far)), rtol=1e-6,
    )
    assert np.array_equal(tcamera.pixel_uv(5, 7, device="cpu").numpy(), np.asarray(jcamera.pixel_uv(5, 7)))


# ---------------------------------------------------------------- rng


def test_rng_stream_bit_exact():
    x = RS.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    got = trng.jenkins_hash_u32(T(x.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), np.asarray(jrng.jenkins_hash_u32(J(x))))
    fi = 33 * 77
    jr, tr = jrng.make_rng(6, 10, fi), trng.make_rng(6, 10, fi, device="cpu")
    for _ in range(3):
        (jv, jr), (tv, tr) = jrng.draw(jr), trng.draw(tr)
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    (jv, jr), (tv, tr) = jrng.draw2(jr), trng.draw2(tr)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert trng.advance_frame_index(63990) == jrng.advance_frame_index(63990)


# ---------------------------------------------------------------- brdf / image


def test_brdf_matches_jax():
    n = 2000
    u = RS.uniform(0, 1, (n, 2)).astype(np.float32)
    nrm, view = unit_vectors(n, RS), unit_vectors(n, RS)
    rough = RS.uniform(0, 1, n).astype(np.float32)
    spec = RS.uniform(0, 1, (n, 3)).astype(np.float32)
    jf, tf = jbrdf.get_local_frame(J(nrm)), tbrdf.get_local_frame(T(nrm))
    ndotv = np.clip(np.sum(nrm * view, -1), 1e-4, None).astype(np.float32)
    pairs = [
        (jbrdf.importance_sample_ggx_pdf(J(u), J(view), jf, J(rough), J(ndotv)),
         tbrdf.importance_sample_ggx_pdf(T(u), T(view), tf, T(rough), T(ndotv))),
        (jbrdf.importance_sample_lambert(J(u), jf), tbrdf.importance_sample_lambert(T(u), tf)),
        ((jbrdf.f_schlick(J(spec), J(u[:, 0])),), (tbrdf.f_schlick(T(spec), T(u[:, 0])),)),
        ((jbrdf.disney_diffuse_no_pi(J(ndotv), J(u[:, 0]), J(u[:, 1]), J(rough)),),
         (tbrdf.disney_diffuse_no_pi(T(ndotv), T(u[:, 0]), T(u[:, 1]), T(rough)),)),
        ((jbrdf.reflect(J(view), J(nrm)),), (tbrdf.reflect(T(view), T(nrm)),)),
    ]
    for jout, tout in pairs:
        for a, b in zip(jout, tout):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6, atol=2e-6)


def test_hsv_clamp_matches_jax():
    rgb = (RS.uniform(0, 1, (3000, 3)) ** 3 * 40).astype(np.float32)
    rgb[:10] = 0.0
    np.testing.assert_allclose(
        timage.clamp_brightness_hsv(T(rgb), 10.0).numpy(),
        np.asarray(jimage.clamp_brightness_hsv(J(rgb), 10.0)), rtol=2e-6, atol=2e-6,
    )


# ---------------------------------------------------------------- G-buffer


def test_gbuffer_decode_matches_jax(box):
    jgb, _, tgb, _ = box
    jv, tv = jconfig.PTVariants(), tconfig.PTVariants()
    h, w = tgb.height, tgb.width
    uv = RS.uniform(0, 1, (h, w, 2)).astype(np.float32)
    inside = np.zeros((h, w), np.float32)
    for direct in (True, False):
        js = jgbuffer.hit_surface_from_gbuffer(jgb, J(uv), J(inside), jv, direct=direct)
        ts = tgbuffer.hit_surface_from_gbuffer(tgb, T(uv), T(inside), tv, direct=direct)
        for name in ("albedo", "specular", "normal", "emission", "smoothness", "ior"):
            np.testing.assert_allclose(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=0, atol=1e-7
            )


def test_packed_words_bit_exact_and_decode(box):
    jgb, _, tgb, _ = box
    h, w = tgb.height, tgb.width
    # Random normals and HDR emission on top of the fixture exercise
    # every oct-fold and exponent path.
    normal = unit_vectors(h * w, RS).reshape(h, w, 3)
    emis = (RS.uniform(0, 1, (h, w, 3)) ** 4 * 30).astype(np.float32)
    emis[0] = 0.0
    jgb2 = jgb.replace(normal=J(normal), emission=J(emis))
    tgb2 = dataclasses.replace(tgb, normal=T(normal), emission=T(emis))
    for jg, tg in ((jgb, tgb), (jgb2, tgb2)):
        jp, tp = jpacked.pack_gbuffers(jg), tpacked.pack_gbuffers(tg)
        assert np.array_equal(tp.packs.numpy(), np.asarray(jp.packs).astype(np.int64))
    uv = RS.uniform(0, 1, (h, w, 2)).astype(np.float32)
    inside = np.zeros((h, w), np.float32)
    js = jpacked.hit_surface_from_packed(jp, J(uv), J(inside), jconfig.PTVariants())
    ts = tpacked.hit_surface_from_packed(tp, T(uv), T(inside), tconfig.PTVariants())
    for name in ("albedo", "specular", "normal", "emission", "smoothness"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-6, atol=1e-6
        )


def test_envprobe_matches_jax():
    d = unit_vectors(1000, RS)
    np.testing.assert_allclose(tenv.oct_encode(T(d)).numpy(),
                               np.asarray(jenv.oct_encode(J(d))), atol=1e-7)
    uv = RS.uniform(0, 1, (1000, 2)).astype(np.float32)
    np.testing.assert_allclose(tenv.oct_decode(T(uv)).numpy(),
                               np.asarray(jenv.oct_decode(J(uv))), atol=2e-7)
    jp = jenv.ProbeSet(probe0=jenv.constant_probe([0.05, 0.06, 0.08]))
    tp = convert.probe_set(np_tree(jp.probe0), device="cpu")
    assert np.array_equal(
        tenv.sample_reflection_probes(tp, T(d), T(d)).numpy(),
        np.asarray(jenv.sample_reflection_probes(jp, J(d), J(d))),
    )
    # A resolution-4 probe: the oct lookup and its bilinear read.
    tex = RS.uniform(0.0, 2.0, (4, 4, 3)).astype(np.float32)
    jp4 = jenv.ProbeSet(probe0=jenv.constant_probe([1, 1, 1], resolution=4).replace(
        texture=J(tex)))
    tp4 = convert.probe_set(np_tree(jp4.probe0), device="cpu")
    np.testing.assert_allclose(tenv.sample_reflection_probes(tp4, T(d), T(d)).numpy(),
                               np.asarray(jenv.sample_reflection_probes(jp4, J(d), J(d))),
                               rtol=0, atol=2e-6)


# ---------------------------------------------------------------- depth tiles


@pytest.mark.parametrize("h,w", [(40, 96), (64, 64)])
def test_depth_tiles_bit_exact(h, w):
    cam = jfixtures.box_scene_camera(h, w)
    gb = jfixtures.rasterize_gbuffers(jscene.build_box_scene(), cam, h, w)
    jt = jtiles.build_depth_tiles(gb.depth, cam.near, cam.far)
    tt = ttiles.build_depth_tiles(T(gb.depth), T(cam.near), T(cam.far))
    assert np.array_equal(tt.pair_table.numpy(), np.asarray(jt.pair_table).view(np.int32))
    assert np.array_equal(tt.mini_table.numpy(), np.asarray(jt.mini_table).view(np.int32))
    assert (tt.tiles_x, tt.tiles_y, tt.pairs_x, tt.minis_x) == (
        jt.tiles_x, jt.tiles_y, jt.pairs_x, jt.minis_x)
    iy = RS.integers(0, h, 300)
    ix = RS.integers(0, w, 300)
    for got, ref in zip(ttiles.pair_of(T(ix), T(iy), tt.pairs_x), jtiles.pair_of(J(ix), J(iy), jt)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(ttiles.mini_of(T(ix), T(iy), tt.minis_x).numpy(),
                          np.asarray(jtiles.mini_of(J(ix), J(iy), jt)))
    words = tt.mini_table.reshape(-1)[: 8]
    for got, ref in zip(ttiles.unpack_minmax(words),
                        jtiles.unpack_minmax(jt.mini_table.reshape(-1)[:8])):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    pw, high = tt.pair_table.reshape(-1)[:256], T(np.arange(256) % 3 == 0)
    assert np.array_equal(
        ttiles.unpack_pair_half(pw, high).numpy(),
        np.asarray(jtiles.unpack_pair_half(jt.pair_table.reshape(-1)[:256], J(high.numpy()))),
    )


# ---------------------------------------------------------------- accumulate / compaction


def test_accumulate_and_cue_match_jax():
    h, w, mx = 20, 30, 16
    js, ts = jaccum.OfflineAccumState.create(h, w), taccum.OfflineAccumState.create(h, w, device="cpu")
    for i in range(5):
        frame = RS.uniform(0, 3, (h, w, 3)).astype(np.float32)
        paused = i == 3
        js = jaccum.offline_accumulate(js, J(frame), mx, paused)
        ts = taccum.offline_accumulate(ts, T(frame), mx, paused)
        assert np.array_equal(ts.accum.numpy(), np.asarray(js.accum))
        assert ts.sample == int(js.sample)
        assert np.array_equal(
            taccum.add_convergence_cue(ts.accum, ts.sample, mx, h, w).numpy(),
            np.asarray(jaccum.add_convergence_cue(js.accum, js.sample, mx, h, w)),
        )


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_compact_indices_match_jax(frac):
    alive = RS.uniform(size=4096) < frac
    for cap in (1024, 2048):
        for got, ref in zip(compact_indices(T(alive), cap), _compact_indices(J(alive), cap)):
            assert np.array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- boundaries


def test_port_never_imports_jax():
    root = Path(port_pkg.__file__).parent
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|unitysspathtracingurp_tpu)\b", re.M)
    sources = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(sources) > 15
    for src in sources:
        assert not pat.search(src.read_text()), f"{src} imports JAX"


def _meta(*shape, dt=torch.float32):
    return torch.empty(*shape, dtype=dt, device="meta")


_F, _I, _B = torch.float32, torch.int32, torch.bool
_KERNEL_CALLS = {
    "schedule_pack": lambda: schedule_pack(
        _meta(8, 3), _meta(8, 3), _meta(8), _meta(8), _meta(8, dt=_B), _meta(8, dt=_B),
        _meta(1, 128, dt=_I), _meta(18), k=16),
    "resolve_rounds": lambda: resolve_rounds(
        _meta(16, 8), _meta(16, 8), _meta(16, 8), _meta(8, dt=_I), _meta(8, 3), _meta(8, 3),
        _meta(8, dt=_B), _meta(4, 128, dt=_I), _meta(18)),
    "schedule_pack_dual": lambda: schedule_pack_dual(
        _meta(8, 3), _meta(8, 3), _meta(8), _meta(8), _meta(8, dt=_B), _meta(8, dt=_I),
        _meta(8, dt=_B), _meta(3, 128, dt=_I), _meta(3, 128, dt=_I), _meta(18),
        chunks_per_combo=1, k=16),
    "resolve_rounds_dual": lambda: resolve_rounds_dual(
        _meta(16, 8), _meta(16, 8), _meta(16, 8), _meta(16, 8), _meta(8, dt=_I),
        _meta(8, 3), _meta(8, 3), _meta(8, dt=_B), _meta(8, dt=_I), _meta(8, dt=_B),
        _meta(6, 128, dt=_I), _meta(18)),
    "atrous": lambda: atrous_filter(
        _meta(4, 4, 3), _meta_gbuffers(), _meta(4, 4, 3), _meta(4, 4), tconfig.PTConfig()),
    "brdf": lambda: brdf_lanes(
        True, True, _meta(4, 4, 3), _meta(4, 4, 3), _meta(4, 4, 3), _meta(4, 4, dt=_B),
        tgbuffer.SurfaceData(albedo=_meta(4, 4, 3), specular=_meta(4, 4, 3),
                             normal=_meta(4, 4, 3), emission=_meta(4, 4, 3),
                             smoothness=_meta(4, 4), ior=_meta(4, 4),
                             inside_object=_meta(4, 4)),
        _meta(4, 4, 3), _meta(4, 4), _meta(4, 4, 3), _meta(4, 4, 2), _meta(4, 4)),
    "sampler": lambda: trng.sampler_draws(
        _meta(8, dt=torch.int64), _meta(8, dt=torch.int64), 99, 1, 2, trng.SOBOL_OWEN),
    "temporal": lambda: temporal_reproject(
        _meta(4, 4, 3), _meta_gbuffers(), _meta_camera(),
        ttemporal.TemporalState.create(4, 4, _meta_camera(), device="meta"), _meta(4, 4, 3),
        tconfig.PTConfig(), 0.9, 0.001),
}


def _meta_gbuffers():
    return tgbuffer.GBuffers(
        albedo=_meta(4, 4, 3), material_flags=_meta(4, 4, dt=torch.int64),
        gbuffer1=_meta(4, 4, 3), normal=_meta(4, 4, 3), smoothness=_meta(4, 4),
        emission=_meta(4, 4, 3), depth=_meta(4, 4))


def _meta_camera():
    return tcamera.Camera(position=_meta(3), view=_meta(4, 4), proj=_meta(4, 4),
                          view_proj=_meta(4, 4), inv_view_proj=_meta(4, 4), near=_meta(1)[0],
                          far=_meta(1)[0])


@pytest.mark.parametrize("kernel", sorted(_KERNEL_CALLS))
def test_cuda_tensor_without_kernel_raises(monkeypatch, kernel):
    """A non-CPU tensor takes the kernel path: with no kernel available
    it raises, and never runs the plain version instead."""
    from unitysspathtracingurp_tpu_torch.kernels import build

    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", Path(os.devnull).parent / "no-such-dir")
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _KERNEL_CALLS[kernel]()
    finally:
        build.load_library.cache_clear()


_SASS_LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_114sampler_kernelILi1ELi2ELi1EEEvPKlS2_PKiS4_S4_Pfxjj
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.U32.AND P0, PT, R0, UR4, PT ;  /* 0x0000000000007919 */
        /*0030*/               @P0 EXIT ;                                  /* 0x0000000000007919 */
        /*0040*/                   IMAD.MOV.U32 R2, RZ, RZ, R0 ;           /* 0x0000000000007919 */
        /*0050*/                   ISETP.NE.AND P1, PT, R2, RZ, PT ;       /* 0x0000000000007919 */
        /*0060*/              @!P1 BRA 0xa0 ;                              /* 0x0000000000007919 */
        /*0070*/                   BREV R3, R2 ;                           /* 0x0000000000007919 */
        /*0080*/                   LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT ;    /* 0x0000000000007919 */
        /*0090*/                   IMAD R3, R3, 0x3, RZ ;                  /* 0x0000000000007919 */
        /*00a0*/                   I2F.U32 R4, R3 ;                        /* 0x0000000000007919 */
        /*00b0*/                   FMUL R4, R4, 5.9604644775390625e-08 ;   /* 0x0000000000007919 */
        /*00c0*/                   STG.E [R6.64], R4 ;                     /* 0x0000000000007919 */
        /*00d0*/                   EXIT ;                                  /* 0x0000000000007919 */
        /*00e0*/                   BRA 0xe0;                               /* 0x0000000000007919 */
        /*00f0*/                   NOP;                                    /* 0x0000000000007919 */
"""


def test_sass_must_run_counts_the_blocks_that_dominate_the_store():
    """S1's bound reads its SASS: the code a branch can skip (0x70-0x90)
    and the padding after the last EXIT are left out, predicated exits
    and branches fall through, and each instruction lands on its pipe."""
    from unitysspathtracingurp_tpu_torch.kernels.build import sass_lane_clocks, sass_must_run

    got = sass_must_run(_SASS_LISTING)
    assert list(got) == ["sampler_kernel<1,2,1>"]
    v = got["sampler_kernel<1,2,1>"]
    assert v["static"] == 16
    assert v["must_run"] == {"issue": 11, "alu": 2, "imad": 1, "xu": 1, "fp32": 1}
    assert sass_lane_clocks(v["must_run"]) == (11 / 128, "issue")
    assert sass_lane_clocks({"issue": 40, "alu": 30, "imad": 5}) == (30 / 64, "alu")
    assert sass_lane_clocks({"issue": 20, "xu": 8}) == (8 / 16, "xu")
    assert sass_lane_clocks({"issue": 90, "imad": 40, "fp32": 60}) == (100 / 128, "fma")


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.uint8])
def test_flag_bytes_views_bool_flags(dtype):
    """The K3 / K6 wrappers hand the kernels a flag tensor's own bytes
    when it is bool (a view: no copy), and a uint8 conversion of any
    other dtype; the values are the flags either way."""
    from unitysspathtracingurp_tpu_torch.kernels.build import flag_bytes

    flags = (torch.arange(24).reshape(4, 6) % 3 == 0).to(dtype)
    got = flag_bytes(flags)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert torch.equal(got, (flags != 0).to(torch.uint8))
    assert (got.data_ptr() == flags.data_ptr()) == (dtype in (torch.bool, torch.uint8))
    assert torch.equal(flag_bytes(flags.t()), (flags.t() != 0).to(torch.uint8))


def test_pack_budget_bytes_and_block_size():
    """K1 / K4's shared memory a block: the minitile table (K4: none),
    then 3 (K4: 4) x K = 16 staged f32 slots a thread, at the block size
    that keeps the most threads resident; K6's block of HOME_THREADS (256)
    holds its staging only (its table stays in device memory); a table
    too large for a block raises. Minitile words: 256^2 has 8 x 16 minitiles (one
    128-word chunk), 1080p 60 x 68 (32 chunks), 3840x2160 120 x 135 (127
    chunks)."""
    from unitysspathtracingurp_tpu_torch.ops.fused_schedule import HOME_THREADS, pack_budget

    for words, threads in ((128, 128), (4096, 512), (16256, 256)):
        assert pack_budget(words, 16, 3) == (threads, (words + 3 * 16 * threads) * 4)
    assert pack_budget(0, 16, 4) == (128, 4 * 16 * 128 * 4)
    assert HOME_THREADS == 256
    assert pack_budget(0, 16, 3, threads=HOME_THREADS) == (256, 3 * 16 * 256 * 4)
    assert pack_budget(0, 2, 3, threads=HOME_THREADS) == (256, 3 * 2 * 256 * 4)
    with pytest.raises(RuntimeError, match="shared memory"):
        pack_budget(58 * 1024, 16, 3)


# ---------------------------------------------------------------- renderer control flow


@pytest.fixture(scope="module")
def small_scene():
    cam = tfixtures.box_scene_camera(32, 32, device="cpu")
    gb = tfixtures.rasterize_gbuffers(tscene.build_box_scene(), cam, 32, 32, device="cpu")
    return gb, cam


def _renderer(**kw):
    s = tconfig.PTSettings(maximum_depth=1, dithering=False, maximum_samples=4,
                           denoiser=tconfig.DenoiserType.OFFLINE, progress_bar=False, **kw)
    return Renderer(s, 32, 32, cfg=tconfig.PTConfig(hiz_rounds=2),
                    probes=tenv.ProbeSet(probe0=tenv.constant_probe([0.05, 0.06, 0.08],
                                                                    device="cpu")),
                    device="cpu")


def test_renderer_invalidation_pause_and_converged_skip(small_scene):
    gb, cam = small_scene
    r = _renderer()
    for _ in range(2):
        r.render_frame(gb, cam)
    assert r.sample == 2 and r.frame_index == 66
    tiles = r._tiles
    r.render_frame(gb, cam, scene_key="a")  # scene-light change restarts
    assert r.sample == 1 and r._tiles is tiles  # same depth buffer: tiles reused
    cam2 = tfixtures.box_scene_camera(32, 32, jitter=0.1, device="cpu")
    gb2 = tfixtures.rasterize_gbuffers(tscene.build_box_scene(), cam2, 32, 32, device="cpu")
    r.render_frame(gb2, cam2, scene_key="a")  # camera move restarts
    assert r.sample == 1 and r._tiles is not tiles
    r.paused = True
    before = r.offline_state.accum.clone()
    r.render_frame(gb2, cam2, scene_key="a")
    assert r.sample == 1 and torch.equal(r.offline_state.accum, before)
    r.paused = False
    for _ in range(5):
        out = r.render_frame(gb2, cam2, scene_key="a")
    assert r.sample == 4  # the converged skip holds at maximum_samples
    assert torch.equal(out, r.offline_state.accum)


def test_renderer_checkpoint_roundtrip(small_scene, tmp_path):
    gb, cam = small_scene
    r = _renderer()
    for _ in range(2):
        r.render_frame(gb, cam)
    path = str(tmp_path / "ckpt.npz")
    r.save(path)
    r2 = _renderer()
    r2.load(path)
    assert (r2.sample, r2.frame_index) == (r.sample, r.frame_index)
    assert torch.equal(r.render_frame(gb, cam), r2.render_frame(gb, cam))


def test_trace_frame_hiz_tuple_rounds(small_scene):
    """A tuple n_rounds gives per-bounce budgets, last entry extending."""
    from unitysspathtracingurp_tpu_torch.ops.pathtrace_hiz import trace_frame_hiz

    gb, cam = small_scene
    s = tconfig.PTSettings(maximum_depth=2)
    probes = tenv.ProbeSet(probe0=tenv.constant_probe([0.05, 0.06, 0.08], device="cpu"))
    run = lambda r: trace_frame_hiz(  # noqa: E731
        gb, cam, probes, s, tconfig.PTConfig(), s.variants(), 33, n_rounds=r)
    assert torch.equal(run(3), run((3,)))
    assert not torch.equal(run(3), run((3, 0)))
    # Blue noise: the same, and the frame's first draws are the JAX
    # package's stream (the whole blue-noise hiz frame is held against
    # JAX in tests/test_torch_march.py, whose process has compiled the
    # JAX hiz march).
    blue = dataclasses.replace(s, noise_method=tconfig.NoiseMethod.BLUE_NOISE)
    tables = tblue.BlueNoiseTables(device="cpu")
    calls = []
    real = trng.sampler_draws

    def spy(*args):
        calls.append((args, real(*args)))
        return calls[-1][1]

    trng.sampler_draws = spy
    try:
        bn = trace_frame_hiz(gb, cam, probes, blue, tconfig.PTConfig(), blue.variants(),
                             33 * 300, n_rounds=(3,), rng_tables=tables)
    finally:
        trng.sampler_draws = real
    assert torch.equal(bn, trace_frame_hiz(gb, cam, probes, blue, tconfig.PTConfig(),
                                           blue.variants(), 33 * 300, n_rounds=3,
                                           rng_tables=tables))
    assert len(calls) == 2 + 3 * s.maximum_depth  # one launch a draw or draw2
    jr = jrng.make_rng(32, 32, 33 * 300, jblue.BlueNoiseTables())
    for args, got in calls[:2]:  # bounce 0's draw2 and roulette, on the pixel grid
        jv, jr = (jrng.draw2 if args[4] == 2 else jrng.draw)(jr)
        assert np.array_equal(got.numpy(), np.asarray(jv))


def test_convert_state_and_unported_layers(box):
    """The offline state and the motion layer carry over; a layer the
    port's GBuffers does not have raises rather than drops."""
    jgb, _, _, _ = box
    state = convert.offline_state(np.ones((2, 3, 3), np.float32), np.int32(5), device="cpu")
    assert state.sample == 5 and state.accum.shape == (2, 3, 3)
    leaves = np_tree(jgb)
    motion = RS.uniform(-0.1, 0.1, (40, 96, 2)).astype(np.float32)
    leaves["motion"] = motion
    np.testing.assert_array_equal(convert.gbuffers(leaves, device="cpu").motion.numpy(), motion)
    leaves["velocity"] = motion
    with pytest.raises(ValueError, match="velocity"):
        convert.gbuffers(leaves, device="cpu")


def test_renderer_none_mode_and_disabled(small_scene):
    gb, cam = small_scene
    s = tconfig.PTSettings(maximum_depth=1, dithering=False)
    out = Renderer(s, 32, 32, device="cpu").render_frame(gb, cam)
    assert out.shape == (32, 32, 3) and torch.isfinite(out).all()
    off = Renderer(tconfig.PTSettings(state=False), 32, 32, device="cpu")
    assert off.render_frame(gb, cam) is gb.emission


def test_resolve_integer_decode_matches_link():
    """R1's kernel decodes the slot codes with shifts, masks and % / by
    65. Over every code the packer can produce, that equals the f32
    floor / remainder decode of the plain version's ``_link``, bit for
    bit: scode = step + 65 (previous step + 1) + 8192 q, step and
    previous step + 1 in [0, 64], q up to 2046 (the JAX package asserts
    8192 (cap + 1) + 65 * 65 + 64 < 2^24, pathtrace_hiz.py:441), and
    hist = 4096 lcum + lhd, both codes in [0, 4095]."""
    m = [torch.tensor(float(i % 5 == 0)) for i in range(16)]
    one, ray = torch.tensor(1.0), torch.zeros(1, 3)  # one position: the decode is the test
    q = torch.arange(2047, dtype=torch.float32)[:, None]
    sbase = torch.arange(65 * 65)
    scode = q * 8192.0 + sbase.to(torch.float32)[None, :]
    hist = torch.arange(1 << 24, dtype=torch.float32).view(4096, 4096)
    lk = _link(m, one, one, ray, ray, torch.zeros(()), scode, hist, gh=8, gw=8, pairs_x=1,
               tiles_x=1, dual=False)
    # The kernel's integer decode: th = (sc >> 13) * 0.025, s_idx = (sc & 8191) % 65,
    # p_idx = (sc & 8191) / 65 - 1, lcum = (hc >> 12) * 0.025, lhd = (hc & 4095) * 0.025.
    codes = torch.arange(4096, dtype=torch.float32) * 0.025
    assert torch.equal(lk["th"], (q * 0.025).expand_as(scode))
    assert torch.equal(lk["s_idx"], (sbase % 65).expand_as(scode))
    assert torch.equal(lk["p_idx"], (sbase // 65 - 1).expand_as(scode))
    assert torch.equal(lk["lcum"], codes[:, None].expand(4096, 4096))
    assert torch.equal(lk["lhd"], codes[None, :].expand(4096, 4096))
