"""The port's parity march (``ray_march_ref``, P1's plain version) and
the parity frame against the JAX package, on the CPU.

The same BoxScene state is carried across with
``unitysspathtracingurp_tpu_torch.convert``, so both sides compute from
identical inputs; the port runs P1's plain version (CPU tensors). The
JAX ``ray_march`` runs with ``march_unroll=1`` (the same loop, a
smaller program to compile). Each JAX reference is computed once per
module.

Tolerances, and why:
  * the march (64x128 lanes: BoxScene bounce-0 reflection rays in the
    plain layout with zero and with a random per-lane dither; the glass
    box in the refraction + backface layout with insideObject 0, 1 and
    2, and in the refraction-only and backface-only layouts). XLA:CPU
    contracts a * b + c into FMAs (ROADMAP Queue 3, the K6 note), so the
    JAX march's positions drift by ulps a step against the port's
    rounded chain: on the plain case every hit and back-hit decision
    agrees and, where both hit, uv agrees within 2.4e-7, distance within
    1.9e-6 relative and position within 1.7e-5. A lane counts as flipped
    when its hit or back-hit decision differs or, where both hit, its
    uv differs by more than 1e-6, its distance by more than 1e-5
    relative or its position by more than 1e-4: at most 0.1% of the
    alive lanes may flip. P1 itself
    is held bit for bit against the plain version on the card
    (tests/test_torch_cuda.py, chip_smoke.py).
  * frames (trace_frame with the parity march and a Renderer
    ``kernel="xla"`` offline frame, 64x64, 2 bounces, headline caps):
    pooled relative RMSE < 1% and >= 99% of non-sky pixels within 1e-3
    relative, the frame gate of tests/test_torch_march.py.

The slow-marked tests port tests/test_e2e.py:63-132 to the port: the
512-frame 256^2 golden regression and the ideal-SSPT oracle.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu.camera import linear_eye_depth, pixel_uv, world_from_uv_depth
from unitysspathtracingurp_tpu.config import DenoiserType, PTConfig, PTSettings, ThicknessMode
from unitysspathtracingurp_tpu.models import fixtures, scene
from unitysspathtracingurp_tpu.ops import pathtrace as jpathtrace
from unitysspathtracingurp_tpu.ops.accumulate import (
    OfflineAccumState, add_convergence_cue, offline_accumulate,
)
from unitysspathtracingurp_tpu.ops.envprobe import ProbeSet, constant_probe

from unitysspathtracingurp_tpu_torch import config as tconfig
from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch.models import fixtures as tfixtures
from unitysspathtracingurp_tpu_torch.models import groundtruth as tgroundtruth
from unitysspathtracingurp_tpu_torch.models import scene as tscene
from unitysspathtracingurp_tpu_torch.models.renderer import Renderer as TRenderer
from unitysspathtracingurp_tpu_torch.ops import envprobe as tenv
from unitysspathtracingurp_tpu_torch.ops import pathtrace as tpathtrace
from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement, relative_rmse

torch.set_num_threads(1)

MH, MW = 64, 128  # march lanes
FH = FW = 64  # frame
PROBE = [0.05, 0.06, 0.08]
FLIP_SHARE = 0.001
# The march cases: (scene, settings keywords, insideObject, dither).
MARCH_CASES = {
    "plain": ("box", {}, 0.0, False),
    "plain, dither": ("box", {}, 0.0, True),
    "refraction + backface, inside 0": (
        "glass", dict(support_refraction=True,
                      accurate_thickness=ThicknessMode.DEPTH_NORMALS), 0.0, False),
    "refraction + backface, inside 1": (
        "glass", dict(support_refraction=True,
                      accurate_thickness=ThicknessMode.DEPTH_NORMALS), 1.0, False),
    "refraction + backface, inside 2, dither": (
        "glass", dict(support_refraction=True,
                      accurate_thickness=ThicknessMode.DEPTH_NORMALS), 2.0, True),
    "refraction only, inside 1": ("glass", dict(support_refraction=True), 1.0, False),
    "backface only": ("glass", dict(accurate_thickness=ThicknessMode.DEPTH_ONLY), 0.0, False),
}


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene(kind, h, w):
    cam = fixtures.box_scene_camera(h, w)
    if kind == "glass":
        sc = scene.build_box_scene(with_glass=True, with_mirror=False)
        return fixtures.rasterize_gbuffers(sc, cam, h, w, with_backface=True), cam
    return fixtures.rasterize_gbuffers(scene.build_box_scene(), cam, h, w), cam


def _bounce0_rays(gb, cam):
    """BoxScene bounce-0 reflection rays with the tilt of
    tests/test_fused_schedule.py:36-61."""
    h, w = gb.height, gb.width
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


@pytest.fixture(scope="module")
def march_results():
    """Every MARCH_CASES case marched by the JAX package and by the port."""
    rng = np.random.default_rng(8)
    dither = (rng.uniform(0.0, 1.0, (MH, MW)).astype(np.float32) * 0.2 - 0.1)
    cfg = PTConfig(march_unroll=1)
    scenes = {kind: _scene(kind, MH, MW) for kind in ("box", "glass")}
    out = {}
    for name, (kind, skw, inside, dithered) in MARCH_CASES.items():
        gb, cam = scenes[kind]
        x = _bounce0_rays(gb, cam)
        s = PTSettings(maximum_steps=24, **skw)
        ins = jnp.full((MH, MW), inside, jnp.float32)
        dit = jnp.asarray(dither) if dithered else jnp.zeros((MH, MW), jnp.float32)
        args = (x["origin"], x["d"], ins, dit, -x["view_dir"], x["scene_dist"], x["alive"])
        ref = jpathtrace.ray_march(cfg, s, s.variants(), gb, cam, *args)
        ts = convert.pt_settings(s)
        got = tpathtrace.ray_march(
            convert.pt_config(cfg), ts, ts.variants(), convert.gbuffers(_np_tree(gb), "cpu"),
            convert.camera(_np_tree(cam), "cpu"), *[_t(a) for a in args])
        out[name] = (
            {k: np.asarray(v) for k, v in ref._asdict().items()},
            {k: v.numpy() for k, v in got._asdict().items()},
            np.asarray(x["alive"]),
        )
    return out


@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_ray_march_ref_matches_jax(march_results, case):
    ref, got, alive = march_results[case]
    both = ref["hit"] & got["hit"]
    flipped = (ref["hit"] != got["hit"]) | (ref["is_back_hit"] != got["is_back_hit"])
    uv_far = np.abs(ref["uv"] - got["uv"]).max(-1) > 1e-6
    dist_far = np.abs(ref["distance"] - got["distance"]) > 1e-5 * np.abs(ref["distance"])
    pos_far = np.abs(ref["position"] - got["position"]).max(-1) > 1e-4
    flipped |= both & (uv_far | dist_far | pos_far)
    share = flipped.sum() / alive.sum()
    exact = np.mean([np.array_equal(ref[k][both], got[k][both])
                     for k in ("uv", "distance", "position")])
    print(f"{case}: hits {ref['hit'].mean():.4f}, back hits {ref['is_back_hit'].mean():.4f}, "
          f"flipped lanes {flipped.sum()} ({share:.5f} of alive), exact fields {exact:.2f}")
    assert share <= FLIP_SHARE
    assert ref["hit"].mean() > 0.05  # the case exercises the hit rules
    assert not (got["hit"] & ~alive).any()
    # Misses keep the initial state.
    miss = ~got["hit"]
    assert (got["distance"][miss] == tpathtrace.REAL_EPS).all()
    assert not got["position"][miss].any() and not got["uv"][miss].any()


def test_back_hits_exercised(march_results):
    """The backface layouts reach the back-hit rule."""
    assert march_results["refraction + backface, inside 0"][0]["is_back_hit"].any()
    assert march_results["backface only"][0]["is_back_hit"].any()


@pytest.fixture(scope="module")
def frame_case():
    """One JAX parity frame at 64x64, 2 bounces, headline caps, frame 0."""
    sc = scene.build_box_scene()
    cam = fixtures.box_scene_camera(FH, FW)
    gb = fixtures.rasterize_gbuffers(sc, cam, FH, FW)
    probes = ProbeSet(probe0=constant_probe(PROBE))
    settings = PTSettings(maximum_depth=2, maximum_steps=24, dithering=False,
                          denoiser=DenoiserType.OFFLINE, maximum_samples=64)
    cfg = dataclasses.replace(PTConfig.boxscene_headline(), march_unroll=1)
    traced = jax.jit(lambda fi: jpathtrace.trace_frame(
        gb, cam, probes, settings, cfg, settings.variants(), fi))(jnp.uint32(0))
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
    print(f"pooled relative RMSE {rel:.3e}, non-sky pixels within 1e-3 {within:.6f}")
    assert rel < 0.01, f"pooled relative RMSE {rel:.5f}"
    assert within >= 0.99, f"non-sky pixels within 1e-3: {within:.5f}"


def test_parity_trace_frame_matches_jax(frame_case):
    c = frame_case
    s = c["settings"]
    out = tpathtrace.trace_frame(c["gb"], c["cam"], c["probes"], s, c["cfg"], s.variants(), 0,
                                 march_fn=tpathtrace.ray_march)
    _assert_frame_close(out.numpy(), c["traced"], c["non_sky"])


def test_parity_renderer_frame_matches_jax(frame_case):
    c = frame_case
    r = TRenderer(c["settings"], FH, FW, cfg=c["cfg"], probes=c["probes"], kernel="xla",
                  device="cpu")
    assert r.kernel == "xla"
    out = r.render_frame(c["gb"], c["cam"])
    assert r.sample == 1 and r.frame_index == 33 and r._tiles is None
    _assert_frame_close(out.numpy(), c["shown"], c["non_sky"])


def _port_box(h, w):
    cam = tfixtures.box_scene_camera(h, w, device="cpu")
    sc = tscene.build_box_scene(with_mirror=False)
    return sc, cam, tfixtures.rasterize_gbuffers(sc, cam, h, w, device="cpu")


def _converge(gb, cam, settings, cfg, n_frames):
    probes = tenv.ProbeSet(probe0=tenv.constant_probe([0.0, 0.0, 0.0], device="cpu"))
    acc = np.zeros((gb.height, gb.width, 3), np.float64)
    for i in range(n_frames):
        acc += tpathtrace.trace_frame(gb, cam, probes, settings, cfg, settings.variants(),
                                      (33 * i) % 64000, march_fn=tpathtrace.ray_march).numpy()
    return acc / n_frames


@pytest.mark.slow
def test_parity_golden_fixture_regression():
    """tests/test_e2e.py:63-104 on the port: 512 frames at 256^2, 1 bounce,
    against the committed CPU golden (4096 frames of the JAX package),
    pooled 4x4 relative RMSE < 0.035 (pooled noise at this budget is
    ~2.5%, so a systematic change trips it)."""
    path = os.path.join(os.path.dirname(__file__), "..", "fixtures", "box256_golden_cpu.npz")
    golden = np.load(path)["image"]
    r = 256
    _, cam, gb = _port_box(r, r)
    settings = tconfig.PTSettings(maximum_depth=1, samples_per_pixel=1, maximum_steps=24)
    acc = _converge(gb, cam, settings, tconfig.PTConfig(), 512)

    def pool(x):
        return x.reshape(r // 4, 4, r // 4, 4, 3).mean((1, 3))

    pmask = gb.depth.numpy().reshape(r // 4, 4, r // 4, 4).min((1, 3)) > 0
    assert relative_rmse(pool(acc), pool(golden), pmask) < 0.035


@pytest.mark.slow
def test_parity_matches_ideal_sspt_oracle():
    """tests/test_e2e.py:108-132 on the port: the converged parity render
    against the ideal-SSPT world-space oracle (``models/groundtruth.py``)."""
    h = w = 64
    sc, cam, gb = _port_box(h, w)
    settings = tconfig.PTSettings(maximum_depth=1, samples_per_pixel=1, maximum_steps=24)
    ss = _converge(gb, cam, settings, tconfig.PTConfig(use_packed_gbuffer=False), 192)
    gt = tgroundtruth.path_trace(sc, cam, h, w, bounces=1, spp=192, seed=7, visible_only=True)
    mask = gb.depth.numpy() > 0
    assert relative_rmse(ss, gt, mask) < 0.45
    assert abs(ss[mask].mean() - gt[mask].mean()) / gt[mask].mean() < 0.25
    left, right = ss[20:40, 2:10], ss[20:40, -10:-2]
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()
