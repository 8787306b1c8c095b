"""The frozen reference (``sspt_plain``) held against the JAX package, the
implementation the port was written from and that shares none of the
reference's code, on the CPU at 64x64:

- the inputs: the scene, cameras and G-buffers of every cell's poses
  (with the glass layers: transparent, layer-1 depth, back depth and
  normals) and the baked probes equal the JAX fixtures';
- the frames: from the same inputs, ``sspt_plain``'s ``Renderer`` and the
  JAX ``Renderer`` render the first frames of every cell (the offline
  accumulation with and without probes, the real-time history through
  adaptive spp, À-Trous and reprojection) and agree to rounding: pooled
  relative RMSE under 1e-5 (the bound the port's real-time frames are
  held to against JAX; ~1e-7 is read) and 99.9% of the non-sky pixels
  within 1e-3.

Only this test imports JAX; no run of the benchmark does.
"""

import dataclasses
import enum
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from unitysspathtracingurp_tpu import camera as jcamera  # noqa: E402
from unitysspathtracingurp_tpu import config as jconfig  # noqa: E402
from unitysspathtracingurp_tpu import gbuffer as jgbuffer  # noqa: E402
from unitysspathtracingurp_tpu.models import fixtures as jfixtures  # noqa: E402
from unitysspathtracingurp_tpu.models import probes as jprobes  # noqa: E402
from unitysspathtracingurp_tpu.models import scene as jscene  # noqa: E402
from unitysspathtracingurp_tpu.models.renderer import Renderer as JRenderer  # noqa: E402
from unitysspathtracingurp_tpu.ops import envprobe as jenv  # noqa: E402

from bench_core.inputs import fov_y, make_inputs  # noqa: E402
from bench_core.sides import REFERENCE, Side  # noqa: E402
from bench_core.traffic import Traffic  # noqa: E402

SIZE = (64, 64)
CELLS = [  # (cell, frames)
    ("boxscene_offline_1080p.still", 3),
    ("boxscene_offline_1080p.probe_lit", 2),
    ("classroom_spatial_temporal_1080p.moving", 5),
    ("classroom_spatial_temporal_1080p.still", 4),
    ("boxscene_glass_spatial_temporal_1080p.moving", 3),
]


def _inputs(cell, tmp_path):
    return cell, make_inputs(cell.config, cell.traffic, *SIZE, cache_dir=tmp_path)


def _jax_settings(config: dict):
    defaults = jconfig.PTSettings()
    kw = {}
    for k, v in config["settings"].items():
        d = getattr(defaults, k)
        kw[k] = type(d)[v] if isinstance(d, enum.Enum) else v
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in config["cfg"].items()}
    return jconfig.PTSettings(**kw), jconfig.PTConfig(march_unroll=1, **cfg)


def _jax_tree(cls, arrays: dict):
    return cls(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _jax_renderer(config: dict, inputs):
    settings, cfg = _jax_settings(config)
    probes = None
    if inputs.probes["kind"] == "constant":
        probes = jenv.ProbeSet(probe0=jenv.constant_probe(inputs.probes["color"]))
    r = JRenderer(settings, inputs.height, inputs.width, cfg=cfg, probes=probes,
                  fov_y=fov_y(config), hdr_64bit=config["renderer"]["hdr_64bit"],
                  kernel=config["renderer"]["kernel"])
    if inputs.probes["kind"] == "baked":
        baked = []
        for raw in inputs.probes["probes"]:
            t = {k: jnp.asarray(v) for k, v in raw.items()}
            baked.append(jenv.EnvProbe(**t, mips=jenv.build_probe_mips(t["texture"])))
        r.bind_probes(baked, inputs.probes["positions"],
                      _jax_tree(jcamera.Camera, inputs.poses[0].camera))
    return r


def _jax_camera(config: dict, offset: float):
    c = config["scene"]["camera"]
    eye = list(c["eye"])
    eye[0] += offset
    return jcamera.make_camera(eye=eye, target=c["target"], up=c["up"],
                               fov_y=np.radians(c["fov_y_deg"]), aspect=SIZE[1] / SIZE[0],
                               near=c["near"], far=c["far"])


@pytest.mark.parametrize("cell_name", [c for c, _ in CELLS])
def test_inputs_match_the_jax_fixtures(cell_name, tmp_path, pair_cell):
    cell, inputs = _inputs(pair_cell(cell_name), tmp_path)
    scene_cfg = cell.config["scene"]
    sc = getattr(jscene, f"build_{scene_cfg['name']}_scene")(**scene_cfg.get("build", {}))
    offsets = cell.traffic["poses"]
    cams = [_jax_camera(cell.config, o) for o in offsets]
    realtime = cell.config["settings"]["denoiser"] in ("TEMPORAL", "SPATIAL_TEMPORAL")
    same = [_jax_tree(jcamera.Camera, p.camera) for p in inputs.poses]
    for i, (pose, cam) in enumerate(zip(inputs.poses, cams)):
        for k, v in pose.camera.items():
            np.testing.assert_allclose(v, np.asarray(getattr(cam, k)), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        backface = scene_cfg.get("backface", False)
        gb = jfixtures.rasterize_gbuffers(sc, cam, *SIZE, with_backface=backface,
                                          prev_cam=cams[i - 1] if realtime else None)
        got = pose.gbuffers
        assert set(got) == {f.name for f in dataclasses.fields(gb)
                            if getattr(gb, f.name) is not None}
        # The glass layers (transparent layer, layer-1 depth, back depth
        # and normals) are there exactly when the configuration has them.
        assert ("t_surface_type" in got) == scene_cfg["build"].get("with_glass", False)
        assert ("back_depth" in got) == backface
        # From the copy's own camera, the JAX fixture's layers are the
        # copy's bit for bit, every one of them.
        gb_same = jfixtures.rasterize_gbuffers(sc, same[i], *SIZE, with_backface=backface,
                                               prev_cam=same[i - 1] if realtime else None)
        for k, v in got.items():
            assert np.array_equal(v, np.asarray(getattr(gb_same, k))), k
        assert np.abs(got["depth"] - np.asarray(gb.depth)).max() < 1e-6
        # From the JAX package's own camera, which differs from the copy's
        # by an ulp or two (below), a few sphere pixels' normals differ by
        # ~1e-4 at this size.
        dn = np.abs(got["normal"] - np.asarray(gb.normal)).max(-1)
        assert dn.max() < 1e-3 and (dn > 1e-5).mean() < 0.005
        for k in ("albedo", "gbuffer1", "smoothness", "emission", "material_flags"):
            assert np.array_equal(got[k], np.asarray(getattr(gb, k))), k
        if realtime:
            # uv units; the JAX cameras differ from the copy's by an ulp or two.
            assert np.abs(got["motion"] - np.asarray(gb.motion)).max() < 1e-5
            assert (np.abs(got["motion"]).max() > 0) == (len(set(offsets)) > 1)
    if inputs.probes["kind"] == "baked":
        box = scene_cfg["probes"]
        res = cell.traffic["probes"]["resolution"]
        for i, (pos, raw) in enumerate(zip(box["positions"], inputs.probes["probes"])):
            ref = jprobes.bake_probe(sc, pos, resolution=res, seed=i, box_min=box["box_min"],
                                     box_max=box["box_max"])
            for k, v in raw.items():
                np.testing.assert_allclose(v, np.asarray(getattr(ref, k)), rtol=1e-6,
                                           atol=1e-6, err_msg=k)


def _agreement(got, ref, non_sky):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.sqrt(((got - ref) ** 2)[non_sky].mean()) / max(ref[non_sky].mean(), 1e-12)
    close = np.abs(got - ref) <= 1e-3 * np.maximum(np.abs(ref), 1e-6)
    return float(rel), float(close.all(-1)[non_sky].mean())


@pytest.mark.parametrize("cell_name, frames", CELLS)
def test_reference_frames_match_the_jax_renderer(cell_name, frames, tmp_path, pair_cell):
    cell, inputs = _inputs(pair_cell(cell_name), tmp_path)
    traffic = Traffic(cell.traffic)
    side = Side(REFERENCE)
    ref = side.make_renderer(cell.config, inputs, "cpu")
    jr = _jax_renderer(cell.config, inputs)
    ref.frame_index = jr.frame_index = 4321
    gbs = [side.gbuffers(p, "cpu") for p in inputs.poses]
    cams = [side.cam(p, "cpu") for p in inputs.poses]
    jgbs = [_jax_tree(jgbuffer.GBuffers, p.gbuffers) for p in inputs.poses]
    jcams = [_jax_tree(jcamera.Camera, p.camera) for p in inputs.poses]
    for i in range(frames):
        p = traffic.pose(i)
        got = ref.render_frame(gbs[p], cams[p]).numpy()
        # Op by op, as the port's own tests run the JAX package: the
        # jitted frame with its interpreted hiz kernels compiles for
        # minutes into tens of GiB.
        with jax.disable_jit():
            want = np.asarray(jr.render_frame(jgbs[p], jcams[p]))
        non_sky = inputs.poses[p].gbuffers["depth"] != 0.0
        rel, within = _agreement(got, want, non_sky)
        print(f"{cell_name} frame {i}: pooled relative RMSE {rel:.3e}, within 1e-3 {within:.5f}")
        assert np.isfinite(got).all()
        assert rel < 1e-5 and within >= 0.999
        assert float(np.abs(want).sum()) > 0.0
    assert ref.frame_index == jr.frame_index and ref.sample == jr.sample
