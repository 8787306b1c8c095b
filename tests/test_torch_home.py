"""The home-prefix resolve slice of the port against the JAX package, on the CPU.

Shapes and steps are the JAX package's own CI case for the home mode
(tests/test_home_prefix.py:39-43): BoxScene at 16x128 lanes, 8 steps of
max_small_step=2, max_medium_step=4, small_step_size=0.05,
medium_step_size=0.3, tilted bounce-0 reflection rays. The JAX state
(G-buffer, camera, depth tables) is carried across with
``unitysspathtracingurp_tpu_torch.convert``; the port runs its kernels'
plain PyTorch versions (CPU tensors). The JAX side runs as its own tests
run it off TPU: the home mode through the fused Pallas kernel in
interpret mode (~10 s a call on a CPU, so the one call is shared: the three
JAX home marches reuse its result), everything else unfused.

The gated values each test observed print with ``pytest -rP``.

Tolerances, and why:
  * bit-exact: the home strips, K2's and K3's plain versions against
    the JAX kernels, the diagnostic march's packs and counters against
    the JAX ``_debug_out`` ones;
  * K6's plain version against the JAX home-mode kernel in interpret
    mode: every decision and code exact (the packed scode / hist, n_cand,
    the prefix hits and the hit / failed-test metadata); pk_cum within 2
    ulp, hit_cum and hit_hitd within 1e-6 relative, hit_diff and
    prev_diff within 1e-5 absolute. XLA:CPU compiles the interpreted
    kernel body as one computation and contracts a * b + c into FMAs,
    where the port and its kernel (--fmad=false) round every operation
    (ROADMAP Queue 3);
  * marches: the gate of tests/test_home_prefix.py:96-109, hit
    agreement >= 0.999, 99.9% quantile of |distance difference| < 1e-4
    where both hit, uv agreement >= 0.999;
  * frames: pooled relative RMSE < 1% and >= 99% of non-sky pixels
    within 1e-3 relative (tests/test_torch_march.py's frame gate: a
    path whose roulette or window test sits on an ulp edge of the two
    math libraries takes another branch).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu.camera import linear_eye_depth, pixel_uv, world_from_uv_depth
from unitysspathtracingurp_tpu.config import PTConfig, PTSettings, ThicknessMode
from unitysspathtracingurp_tpu.models import fixtures, scene
from unitysspathtracingurp_tpu.ops import fused_schedule as jfused
from unitysspathtracingurp_tpu.ops import pallas_gather as jgather
from unitysspathtracingurp_tpu.ops import pathtrace_hiz
from unitysspathtracingurp_tpu.ops.depth_tiles import build_depth_tiles, build_home_strips
from unitysspathtracingurp_tpu.ops.envprobe import ProbeSet, constant_probe

from unitysspathtracingurp_tpu_torch import config as tconfig
from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch.ops import depth_tiles as ttiles
from unitysspathtracingurp_tpu_torch.ops import fused_schedule as tfused
from unitysspathtracingurp_tpu_torch.ops import pallas_gather as tgather
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as tpathtrace_hiz
from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

torch.set_num_threads(1)

H, W = 16, 128
CFG_KW = dict(max_small_step=2, max_medium_step=4, small_step_size=0.05,
              medium_step_size=0.3)
STEPS = 8
ROUNDS = 8
CAPS = (None, 1.0, 0.25)


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


def _t(a):
    return torch.as_tensor(np.array(a))


def _bits(a):
    """A JAX f32 bit-pattern array as the port's int32 bits."""
    return torch.from_numpy(np.array(a).view(np.int32))


def _port_tiles(tiles):
    return convert.depth_tiles(
        tiles.pair_table, tiles.mini_table, height=tiles.height, width=tiles.width,
        tiles_x=tiles.tiles_x, tiles_y=tiles.tiles_y, pairs_x=tiles.pairs_x,
        minis_x=tiles.minis_x, device="cpu",
    )


def _march_inputs(gb, cam, h, w):
    """Bounce-0 reflection rays tilted as tests/test_home_prefix.py:46-70."""
    uv = pixel_uv(h, w)
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
                scene_dist=linear_eye_depth(gb.depth, cam.near, cam.far))


def _jax_march(cfg, settings, variants, gb, cam, x, tiles, inside=None, **kw):
    zero = jnp.zeros(x["alive"].shape, jnp.float32)
    return pathtrace_hiz.ray_march_hiz(
        cfg, settings, variants, gb, cam, x["origin"], x["d"],
        zero if inside is None else inside, zero, -x["view_dir"], x["scene_dist"],
        x["alive"], tiles=tiles, n_rounds=ROUNDS, **kw)


def _port_march(c, cfg_kw, x=None, tiles=None, settings=None, inside=None, **kw):
    x = c["tx"] if x is None else x
    settings = c["tsettings"] if settings is None else settings
    zero = torch.zeros(x["alive"].shape)
    return tpathtrace_hiz.ray_march_hiz(
        tconfig.PTConfig(**CFG_KW, **cfg_kw), settings, settings.variants(), c["tgb"],
        c["tcam"], x["origin"], x["d"], zero if inside is None else inside, zero,
        -x["view_dir"], x["scene_dist"], x["alive"], tiles=c["ttiles"] if tiles is None
        else tiles, n_rounds=ROUNDS, **kw)


def _np_res(res):
    return {k: np.asarray(v) for k, v in res._asdict().items()}


@pytest.fixture(scope="module")
def home_case():
    """The JAX home marches at n_rounds=8 and caps None / 1.0 / 0.25 (one
    home-mode kernel call between them), the JAX non-home march, and
    their inputs in the port's types."""
    gb, cam, x, settings, variants, tiles = _case(H, W)

    calls = []
    real = jfused.fused_schedule_pack

    def shared(*args, **kw):
        if kw.get("home_strips") is None:
            return real(*args, **kw)
        if not calls:
            calls.append((args, kw, real(*args, **kw)))
        for a, b in zip(args, calls[0][0]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        return calls[0][2]

    jfused.fused_schedule_pack = shared
    try:
        home = {
            cap: _np_res(_jax_march(
                PTConfig(fused_schedule=True, hiz_home_prefix=True, hiz_home_round_cap=cap,
                         **CFG_KW), settings, variants, gb, cam, x, tiles, home_ok=True))
            for cap in CAPS
        }
    finally:
        jfused.fused_schedule_pack = real
    plain = _np_res(_jax_march(PTConfig(**CFG_KW), settings, variants, gb, cam, x, tiles))
    args, kw, outs = calls[0]
    return dict(
        home=home, plain=plain,
        k6_args=args, k6_kw=kw, k6_out=[np.asarray(o) for o in outs], **_port_case(gb, cam, x, tiles),
    )


def _case(h, w):
    cam = fixtures.box_scene_camera(h, w)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(), cam, h, w)
    settings = PTSettings(maximum_depth=1, maximum_steps=STEPS, dithering=False)
    tiles = build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)
    return gb, cam, _march_inputs(gb, cam, h, w), settings, settings.variants(), tiles


def _port_case(gb, cam, x, tiles):
    return dict(tgb=convert.gbuffers(_np_tree(gb), device="cpu"),
                tcam=convert.camera(_np_tree(cam), device="cpu"),
                ttiles=_port_tiles(tiles), tx={k: _t(v) for k, v in x.items()},
                tsettings=tconfig.PTSettings(maximum_depth=1, maximum_steps=STEPS,
                                             dithering=False))


@pytest.fixture(scope="module")
def capped_case():
    """The JAX diagnostic (unfused) march with hiz_round_cap=0.1 at 64x128
    lanes, where the compacted rounds' 1024 lanes drop some."""
    gb, cam, x, settings, variants, tiles = _case(64, 128)
    dbg = {"_full": True}
    ref = _np_res(_jax_march(PTConfig(hiz_round_cap=0.1, **CFG_KW), settings, variants, gb,
                             cam, x, tiles, _debug_out=dbg))
    dbg = {k: [np.asarray(a) for a in v] if isinstance(v, tuple) else np.asarray(v)
           for k, v in dbg.items()}
    return dict(ref=ref, dbg=dbg, **_port_case(gb, cam, x, tiles))


def _assert_march_equal(fast, slow, min_hits=50):
    """tests/test_home_prefix.py:96-109."""
    f_hit, s_hit = fast["hit"], slow["hit"]
    assert s_hit.sum() >= min_hits, f"only {s_hit.sum()} hits in fixture"
    agree = (f_hit == s_hit).mean()
    both = f_hit & s_hit
    dd = np.quantile(np.abs(fast["distance"] - slow["distance"])[both], 0.999)
    uv_same = (np.abs(fast["uv"] - slow["uv"]).max(-1)[both] < 1e-6).mean()
    print(f"hits {s_hit.sum()}: hit agreement {agree:.6f}, 99.9% |d distance| {dd:.3e}, "
          f"uv agreement {uv_same:.6f}")
    assert agree >= 0.999, f"hit agreement {agree:.5f}"
    assert dd < 1e-4, dd
    assert uv_same >= 0.999, f"uv agreement {uv_same:.5f}"


@pytest.mark.parametrize("h,w", [(16, 128), (24, 256)])
def test_build_home_strips_bit_exact(h, w):
    cam = fixtures.box_scene_camera(h, w)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(), cam, h, w)
    tiles = build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)
    got = ttiles.build_home_strips(_port_tiles(tiles), h, w)
    ref = _bits(build_home_strips(tiles, h, w))
    assert got.dtype == torch.int32 and got.shape == (h // 8, w // 128, 18, 128)
    assert torch.equal(got, ref)
    assert (ref != 0).any() and (ref == 0).any()  # image rows and sky padding


def test_schedule_pack_home_ref_matches_jax_kernel(home_case):
    """K6's plain version against the JAX home-mode kernel (interpret
    mode) on the inputs of the JAX home march: all 5 outputs bit-exact."""
    c = home_case
    a, kw = c["k6_args"], c["k6_kw"]
    params = {key: kw[key] for key in (
        "gh", "gw", "minis_x", "s_max", "k", "max_small_step", "max_medium_step",
        "small_step_size", "medium_step_size", "marching_thickness", "step_growth",
        "thickness_growth")}
    strips = ttiles.build_home_strips(c["ttiles"], H, W)
    assert torch.equal(strips, _bits(kw["home_strips"]))
    got = tfused.schedule_pack_home_ref(
        _t(a[0]), _t(a[1]), _t(a[2]), _t(a[3]), _t(a[4]), _t(a[5]), _bits(a[6]), strips,
        _t(a[7]).reshape(18), home_shape=(H, W), **params)
    ref = c["k6_out"]
    assert all(g.numpy().dtype == r.dtype and g.shape == r.shape for g, r in zip(got, ref))
    # Exact: every decision and code (which candidates pack, their step /
    # thickness / history codes, the counts, the prefix hits and the
    # metadata of hits and failed tests).
    for name, g, r in (("pk_scode", got[1], ref[1]), ("pk_hist", got[2], ref[2]),
                       ("n_cand", got[3], ref[3])):
        assert np.array_equal(g.numpy(), r), name
    exact_rows = [tpathtrace_hiz.RESOLVE_FIELDS.index(f) for f in (
        "hit", "hit_th", "hit_lcum", "hit_lhd", "hit_prev", "hit_ixy", "prev_sidx")]
    assert np.array_equal(got[4].numpy()[exact_rows], ref[4][exact_rows])
    # Ulps: distances and depths. XLA:CPU compiles the interpreted kernel
    # body as one computation and contracts a * b + c into FMAs (the step
    # growth, the re-derived position, the projection, 1 / (raw * zz +
    # zw)); the port and its kernel round each operation.
    ulps = np.abs(got[0].numpy().view(np.int32).astype(np.int64)
                  - ref[0].view(np.int32).astype(np.int64)).max()
    home, rhome = got[4].numpy(), ref[4]
    rel = {f: (np.abs(home[i] - rhome[i]) / np.maximum(np.abs(rhome[i]), 1e-30)).max()
           for i, f in enumerate(tpathtrace_hiz.RESOLVE_FIELDS)}
    diffs = max(np.abs(home[i] - rhome[i]).max() for i in (2, 9))
    hit = rhome[0] > 0.5
    print(f"pk_cum max {ulps} ulp; hit_cum / hit_hitd max rel {rel['hit_cum']:.2e} / "
          f"{rel['hit_hitd']:.2e}; hit_diff / prev_diff max abs {diffs:.2e}; prefix hits "
          f"{hit.sum()}, lanes with packed candidates {(ref[3] > 0).sum()}")
    assert ulps <= 2 and rel["hit_cum"] < 1e-6 and rel["hit_hitd"] < 1e-6 and diffs < 1e-5
    assert hit.sum() > 20 and (ref[3][hit] == 0).all()


@pytest.mark.parametrize("cap", CAPS)
def test_home_march_matches_jax(home_case, monkeypatch, cap):
    c = home_case
    lanes = []
    real = tpathtrace_hiz.resolve_rounds

    def counted(*args, **kw):
        lanes.append(args[0].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(tpathtrace_hiz, "resolve_rounds", counted)
    res = _np_res(_port_march(c, dict(hiz_home_prefix=True, hiz_home_round_cap=cap),
                              home_ok=True))
    _assert_march_equal(res, c["home"][cap])
    # Cap 0.25 runs every round on the 1024-lane floor of the 2048 lanes
    # (all 286 lanes the prefix leaves active fit; capped_case drops).
    assert lanes == {None: [H * W], 1.0: [H * W], 0.25: [1024]}[cap]


def test_home_march_equals_non_home_march(home_case):
    """Order-exactness at a budget that covers every candidate (8 rounds,
    K = 8): the port's home march against the JAX non-home march."""
    c = home_case
    res = _np_res(_port_march(c, dict(hiz_home_prefix=True), home_ok=True))
    _assert_march_equal(res, c["plain"])


def test_round_cap_march_and_diagnostic_counters_match_jax(capped_case):
    """hiz_round_cap=0.1 on the plain layout, dropping lanes: the port's
    main path (K1 + compacted R1) and its diagnostic march (K2 + K3, the
    rounds one at a time) against the JAX unfused march, and every
    diagnostic counter and pack equal to JAX's."""
    c = capped_case
    _assert_march_equal(_np_res(_port_march(c, dict(hiz_round_cap=0.1))), c["ref"])
    dbg = {"_full": True}
    _assert_march_equal(_np_res(_port_march(c, dict(hiz_round_cap=0.1), _debug_out=dbg)),
                        c["ref"])
    assert c["dbg"]["c0_round_compact_drop"] > 0
    _assert_counters_equal(dbg, c["dbg"], {"c0_first_in_home", "c0_active_r7", "c0_mmax_s"})


def _assert_counters_equal(dbg, ref, must_have):
    """The port's ``_debug_out`` against JAX's: the same keys, equal
    values; the (S, H, W) dumps compare as the port's (S, N)."""
    keys = sorted(k for k in ref if k.startswith("c0_") and k != "c0_pk")
    assert must_have <= set(keys)
    assert sorted(k for k in dbg if k.startswith("c0_") and k != "c0_pk") == keys
    for key in keys:
        got, want = np.asarray(dbg[key]), ref[key]
        print(f"{key}: {got.sum()} vs {want.sum()}")
        assert np.array_equal(got, want.reshape(got.shape)), key
    for g, r in zip(dbg["c0_pk"], ref["c0_pk"]):
        assert np.array_equal(g.numpy().view(np.int32), r.view(np.int32))


def test_round_cap_dual_march_matches_jax():
    """hiz_round_cap=0.25 on the dual layout (glass box, refraction +
    DepthNormals, insideObject 0 / 1 / 2 by column) against the JAX
    unfused dual march: the main path (K4 + compacted R1-dual) and the
    diagnostic march (K2 with bmax + K3 with pk_step) with its counters."""
    cam = fixtures.box_scene_camera(H, W)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(with_glass=True, with_mirror=False),
                                     cam, H, W, with_backface=True)
    kw = dict(maximum_depth=1, maximum_steps=STEPS, dithering=False,
              support_refraction=True, accurate_thickness=ThicknessMode.DEPTH_NORMALS)
    settings = PTSettings(**kw)
    tiles = pathtrace_hiz.build_tiles_for(gb, cam, settings.variants())
    x = _march_inputs(gb, cam, H, W)
    inside = jnp.broadcast_to((jnp.arange(W) % 3).astype(jnp.float32), (H, W))
    jdbg = {}
    ref = _np_res(_jax_march(PTConfig(hiz_round_cap=0.25, **CFG_KW), settings,
                             settings.variants(), gb, cam, x, tiles, inside=inside,
                             _debug_out=jdbg))
    tgb = convert.gbuffers(_np_tree(gb), device="cpu")
    tcam = convert.camera(_np_tree(cam), device="cpu")
    tsettings = tconfig.PTSettings(**kw)
    c = dict(tgb=tgb, tcam=tcam, ttiles=tpathtrace_hiz.build_tiles_for(
        tgb, tcam, tsettings.variants()), tx={k: _t(v) for k, v in x.items()},
        tsettings=tsettings)
    res = _np_res(_port_march(c, dict(hiz_round_cap=0.25), inside=_t(inside)))
    _assert_march_equal(res, ref, min_hits=20)
    assert (res["is_back_hit"] == ref["is_back_hit"]).mean() >= 0.999
    dbg = {}
    diag = _np_res(_port_march(c, dict(hiz_round_cap=0.25), inside=_t(inside), _debug_out=dbg))
    assert all(np.array_equal(diag[k], res[k]) for k in res)
    _assert_counters_equal(dbg, {k: [np.asarray(a) for a in v] if isinstance(v, tuple)
                                 else np.asarray(v) for k, v in jdbg.items()},
                           {"c0_n_cand_true", "c0_active_r7"})


@pytest.fixture(scope="module")
def frame_case():
    """The JAX non-home frame: 32x128, 2 bounces, 16 rounds of 16 steps.
    With s_max = K = 16 no lane has more candidates than slots, so the
    budget covers every candidate (at 24 steps the home march also
    reaches candidates the K-cap drops: up to HOME_SLOTS + K)."""
    h, w = 32, 128
    cam = fixtures.box_scene_camera(h, w)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(), cam, h, w)
    probes = ProbeSet(probe0=constant_probe([0.05, 0.06, 0.08]))
    settings = PTSettings(maximum_depth=2, maximum_steps=16, dithering=False)
    ref = pathtrace_hiz.trace_frame_hiz(gb, cam, probes, settings, PTConfig(),
                                        settings.variants(), jnp.uint32(33), n_rounds=16)
    return dict(ref=np.asarray(ref), non_sky=np.asarray(gb.depth) != 0.0,
                gb=convert.gbuffers(_np_tree(gb), device="cpu"),
                cam=convert.camera(_np_tree(cam), device="cpu"),
                probes=convert.probe_set(_np_tree(probes.probe0), device="cpu"),
                settings=convert.pt_settings(settings))


def _count_home_calls(monkeypatch):
    shapes = []
    real = tpathtrace_hiz.schedule_pack_home

    def counted(*args, **kw):
        shapes.append(kw["home_shape"])
        return real(*args, **kw)

    monkeypatch.setattr(tpathtrace_hiz, "schedule_pack_home", counted)
    return shapes


def test_home_frame_matches_jax_frame(frame_case, monkeypatch):
    """The port's home frame (K6 on bounce 0, cap 0.4 off) against the
    JAX non-home frame at an ample budget: equal by order-exactness up to
    the frame gate; K6 runs once, on bounce 0."""
    c = frame_case
    shapes = _count_home_calls(monkeypatch)
    s = c["settings"]
    out = tpathtrace_hiz.trace_frame_hiz(
        c["gb"], c["cam"], c["probes"], s, tconfig.PTConfig(hiz_home_prefix=True),
        s.variants(), 33, n_rounds=16)
    assert shapes == [(32, 128)]
    assert np.isfinite(out.numpy()).all()
    rel, within = frame_agreement(out.numpy(), c["ref"], c["non_sky"])
    print(f"home frame vs JAX non-home frame: pooled rel RMSE {rel:.3e}, within 1e-3 "
          f"{within:.6f}")
    assert rel < 0.01 and within >= 0.99


@pytest.mark.parametrize("caps,calls", [(None, 1), ((1.0, 0.5), 1), ((0.5,), 0)])
def test_home_path_only_on_the_pixel_grid(frame_case, monkeypatch, caps, calls):
    """trace_frame's home_ok: K6 runs on bounce 0 of the uncompacted
    pixel grid only, never on bounce 1 or on compacted lanes."""
    c = frame_case
    shapes = _count_home_calls(monkeypatch)
    s = c["settings"]
    tpathtrace_hiz.trace_frame_hiz(
        c["gb"], c["cam"], c["probes"], s,
        tconfig.PTConfig(hiz_home_prefix=True, compaction_caps=caps), s.variants(), 0,
        n_rounds=4)
    assert shapes == [(32, 128)] * calls


@pytest.mark.parametrize("n_chunks,n_idx", [(1, 700), (3, 2048)])
def test_broadcast_table_select_ref_matches_jax(n_chunks, n_idx):
    rng = np.random.default_rng(5 + n_chunks)
    table = rng.integers(-2**31, 2**31, size=(n_chunks, 128), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, n_chunks * 128, size=(n_idx // 64, 64)).astype(np.int32)
    ref = jgather.broadcast_table_select(jnp.asarray(table.view(np.float32)),
                                         jnp.asarray(idx), n_chunks)
    got = tgather.broadcast_table_select(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == idx.shape
    assert np.array_equal(got.numpy(), np.asarray(ref).view(np.int32))


@pytest.mark.parametrize("n_fields", [3, 4])
def test_pack_by_slot_ref_matches_jax(n_fields):
    """Counts above k clamp; -0.0 packs as +0.0, as the masked sums give."""
    rng = np.random.default_rng(n_fields)
    s, n, k = 24, 300, 8
    cand = rng.random((s, n)) < np.linspace(0.05, 0.6, n)[None]
    fields = [rng.standard_normal((s, n)).astype(np.float32) for _ in range(n_fields)]
    fields[0][rng.random((s, n)) < 0.2] = -0.0
    ref_f, ref_n = jgather.pack_by_slot(jnp.asarray(cand), [jnp.asarray(f) for f in fields], k)
    got_f, got_n = tgather.pack_by_slot(torch.from_numpy(cand),
                                        [torch.from_numpy(f) for f in fields], k)
    assert (np.asarray(ref_n) == k).any() and (cand.sum(0) > k).any()
    assert np.array_equal(got_n.numpy(), np.asarray(ref_n))
    for g, r in zip(got_f, ref_f):
        assert np.array_equal(g.numpy().view(np.int32), np.asarray(r).view(np.int32))
