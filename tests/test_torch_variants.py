"""The leftovers of the offline slice against the JAX package, on the CPU:
samples per pixel > 1, step dithering, oct-encoded G-buffer normals,
forward-only objects and the 11-bit HDR target (``hdr_64bit=False``).

Frames are 64x64 BoxScene frames through the parity march (the port's
``ray_march`` on CPU tensors runs P1's plain version; the JAX
``trace_frame`` is jitted with ``march_unroll=1``). The hiz march's
variants (spp 2 and 3 with per-bounce round budgets, dithering with
compaction caps) are held against the JAX hiz frame in
tests/test_torch_march.py, whose process has already compiled the JAX
hiz march's interpret-mode kernels.

Tolerances, and why:
  * frames: pooled relative RMSE < 1% and >= 99% of non-sky pixels
    within 1e-3 relative (the frame gate of tests/test_torch_march.py):
    transcendentals differ by ulps between XLA and torch, XLA:CPU
    contracts FMAs, and a path on a roulette or hit edge takes another
    branch; with spp 3 the JAX package sums its batched samples in its
    own reduction order;
  * the oct helpers: 1e-6 (oct encode and decode at order 1);
  * the bf16 Renderer: the same frame gate on the displayed bf16
    images, and the save / load round trip bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu import gbuffer as jgbuffer
from unitysspathtracingurp_tpu.config import DenoiserType, PTConfig, PTSettings
from unitysspathtracingurp_tpu.models import fixtures, scene
from unitysspathtracingurp_tpu.models.renderer import Renderer as JRenderer
from unitysspathtracingurp_tpu.ops import pathtrace as jpathtrace
from unitysspathtracingurp_tpu.ops.accumulate import add_convergence_cue, offline_accumulate
from unitysspathtracingurp_tpu.ops.envprobe import ProbeSet, constant_probe

from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch import gbuffer as tgbuffer
from unitysspathtracingurp_tpu_torch.models.renderer import Renderer as TRenderer
from unitysspathtracingurp_tpu_torch.ops import pathtrace as tpathtrace
from unitysspathtracingurp_tpu_torch.ops import rng as trng
from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

torch.set_num_threads(1)

H = W = 64
PROBE = [0.05, 0.06, 0.08]
FRAME = 7


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


@pytest.fixture(scope="module")
def box():
    sc = scene.build_box_scene()
    cam = fixtures.box_scene_camera(H, W)
    gb = fixtures.rasterize_gbuffers(sc, cam, H, W)
    probes = ProbeSet(probe0=constant_probe(PROBE))
    return dict(
        gb=gb, cam=cam, probes=probes, non_sky=np.asarray(gb.depth) != 0.0,
        tcam=convert.camera(_np_tree(cam), device="cpu"),
        tprobes=convert.probe_set(_np_tree(probes.probe0), device="cpu"),
    )


def _assert_frame_close(port, ref, non_sky):
    assert np.isfinite(port).all()
    rel, within = frame_agreement(port, ref, non_sky)
    print(f"pooled relative RMSE {rel:.3e}, non-sky pixels within 1e-3 {within:.6f}")
    assert rel < 0.01, f"pooled relative RMSE {rel:.5f}"
    assert within >= 0.99, f"non-sky pixels within 1e-3: {within:.5f}"


def _parity_frames(box, settings, cfg, gb=None):
    """(JAX frame, port frame) of the parity march at frame FRAME."""
    gb = box["gb"] if gb is None else gb
    cfg = dataclasses.replace(cfg, march_unroll=1)
    ref = jax.jit(lambda fi: jpathtrace.trace_frame(
        gb, box["cam"], box["probes"], settings, cfg, settings.variants(), fi))(
            jnp.uint32(FRAME))
    ts = convert.pt_settings(settings)
    got = tpathtrace.trace_frame(
        convert.gbuffers(_np_tree(gb), device="cpu"), box["tcam"], box["tprobes"], ts,
        convert.pt_config(cfg), ts.variants(), FRAME, march_fn=tpathtrace.ray_march,
        back_depth_enabled=int(ts.accurate_thickness.value))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("spp", [2, 3])
def test_parity_samples_per_pixel_match_jax(box, spp):
    s = PTSettings(maximum_depth=2, maximum_steps=24, samples_per_pixel=spp)
    ref, got = _parity_frames(box, s, PTConfig.boxscene_headline())
    _assert_frame_close(got, ref, box["non_sky"])


def test_sample_streams_follow_the_jax_offsets():
    """Sample s draws the stream seed + s * (3 + 4 * maximum_depth)."""
    rng = trng.make_rng(2, 3, 5, device="cpu")
    assert trng.draws_per_sample(4) == 19
    assert trng.sample_rng(rng, 2, 4).seed == 38
    v, _ = trng.draw(trng.sample_rng(rng, 1, 2))
    w, _ = trng.draw(trng.make_rng(2, 3, 5 + 11, device="cpu"))
    assert torch.equal(v, w)


def test_parity_dithering_with_caps_matches_jax(box):
    """Step dithering through compaction caps: the per-lane dither is
    gathered with the lanes (JAX pathtrace.py:816-838)."""
    s = PTSettings(maximum_depth=2, maximum_steps=24, dithering=True, dither_intensity=0.8)
    ref, got = _parity_frames(box, s, PTConfig.boxscene_headline())
    plain, _ = _parity_frames(box, PTSettings(maximum_depth=2, maximum_steps=24),
                              PTConfig.boxscene_headline())
    assert np.abs(ref - plain).max() > 0.0  # the dither changes the frame
    _assert_frame_close(got, ref, box["non_sky"])


def test_oct_quad_helpers_match_jax():
    n = np.random.default_rng(3).normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    j = np.asarray(jgbuffer.pack_normal_oct_quad(jnp.asarray(n)))
    t = tgbuffer.pack_normal_oct_quad(torch.as_tensor(n)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)
    np.testing.assert_allclose(tgbuffer.unpack_normal_oct_quad(torch.as_tensor(j)).numpy(),
                               np.asarray(jgbuffer.unpack_normal_oct_quad(jnp.asarray(j))),
                               atol=1e-6)
    np.testing.assert_allclose(tgbuffer.unpack_normal_oct_quad(torch.as_tensor(t)).numpy(), n,
                               atol=1e-5)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_oct_normals_frame_matches_jax(box, packed):
    """GBuffer2 holds the oct-encoded normal. The packed decode packs that
    rgb as a unit normal, as the JAX package does (ROADMAP Queue 3)."""
    gb = box["gb"].replace(normal=jgbuffer.pack_normal_oct_quad(box["gb"].normal))
    s = PTSettings(maximum_depth=1, maximum_steps=24, gbuffer_normals_oct=True)
    ref, got = _parity_frames(box, s, PTConfig(use_packed_gbuffer=packed), gb=gb)
    _assert_frame_close(got, ref, box["non_sky"])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_forward_only_frame_matches_jax(box, packed):
    """Smoothness-0 texels are forward-only: shown with their emission,
    untraced, and decoded with zero albedo and specular on bounce hits."""
    # BoxScene has no smoothness-0 surface: make a block of the left wall
    # and floor one.
    smooth = np.asarray(box["gb"].smoothness).copy()
    smooth[4:28, 2:24] = 0.0
    gb = box["gb"].replace(smoothness=jnp.asarray(smooth))
    forward = (smooth == 0.0) & box["non_sky"]
    assert 0.0 < forward.mean() < 0.5
    s = PTSettings(maximum_depth=1, maximum_steps=24, ignore_forward_objects=True)
    ref, got = _parity_frames(box, s, PTConfig(use_packed_gbuffer=packed), gb=gb)
    np.testing.assert_array_equal(got[forward], np.asarray(box["gb"].emission)[forward])
    _assert_frame_close(got, ref, box["non_sky"])


def test_renderer_low_precision_target_matches_jax(box, tmp_path):
    """hdr_64bit=False: a bf16 accumulator, a 64-sample budget, three
    frames against the JAX Renderer's, and a save / load round trip. The
    JAX frames are its ``_offline_step`` spelled out and run eagerly
    (trace, accumulate into the bf16 state, progress cue): a jitted frame
    after this file's other jitted JAX frames trips JAX's dispatch cache
    (INVALID_ARGUMENT, "supplied 1 buffers but compiled program expected
    17")."""
    s = PTSettings(maximum_depth=2, maximum_steps=24, denoiser=DenoiserType.OFFLINE,
                   maximum_samples=128)
    cfg = PTConfig(march_unroll=1)
    jr = JRenderer(s, H, W, cfg=cfg, probes=box["probes"], hdr_64bit=False, kernel="xla")
    ts, tcfg = convert.pt_settings(s), convert.pt_config(cfg)
    tr = TRenderer(ts, H, W, cfg=tcfg, probes=box["tprobes"], hdr_64bit=False, kernel="xla",
                   device="cpu")
    assert tr.max_sample == jr.max_sample == 64
    assert jr.offline_state.accum.dtype == jnp.bfloat16
    def trace(fi):
        return jpathtrace.trace_frame(box["gb"], box["cam"], box["probes"], s, cfg,
                                      s.variants(), fi)

    state = jr.offline_state
    tgb = convert.gbuffers(_np_tree(box["gb"]), device="cpu")
    for frame in range(3):
        state = offline_accumulate(state, trace(jnp.uint32(33 * frame)), jr.max_sample)
        ref = add_convergence_cue(state.accum, state.sample, jr.max_sample, H, W)
        got = tr.render_frame(tgb, box["tcam"])
        assert ref.dtype == jnp.bfloat16
        assert got.dtype == tr.offline_state.accum.dtype == torch.bfloat16
        _assert_frame_close(got.float().numpy(), np.asarray(ref, np.float32), box["non_sky"])
    assert tr.sample == int(state.sample) == 3
    path = str(tmp_path / "state.npz")
    tr.save(path)
    back = TRenderer(ts, H, W, cfg=tcfg, probes=box["tprobes"], hdr_64bit=False,
                     kernel="xla", device="cpu")
    back.load(path)
    assert back.offline_state.accum.dtype == torch.bfloat16
    assert torch.equal(back.offline_state.accum, tr.offline_state.accum)
    assert (back.sample, back.frame_index) == (tr.sample, tr.frame_index)
    assert torch.equal(back.render_frame(tgb, box["tcam"]), tr.render_frame(tgb, box["tcam"]))
