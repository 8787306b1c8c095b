"""The blue-noise and Sobol-Owen samplers and the reflection probes of the
port against the JAX package, on the CPU.

The port's draws run S1's plain version (``ops.rng.sampler_draws_ref``)
on CPU tensors; probe sampling is plain PyTorch on both sides.

Tolerances, and why:
  * bit-exact: the uint32 primitives (bit reversal, Laine-Karras,
    nested uniform scrambling, both Sobol components), every draw of
    both samplers, the tables and their generator's pieces, the baked
    probe textures and the probe selection (integer or exactly rounded
    math on identical inputs; the texture is the same numpy code);
  * 1 ulp: the probe mips (the port sums each 2x2 box in the order
    eager XLA:CPU takes, where it gives equal bits; a jitted mean may
    contract or reorder);
  * 2e-6 absolute: probe sampling (oct_encode's division and the
    bilinear weights may round differently under XLA:CPU's contraction);
  * frames: pooled relative RMSE < 1% and >= 99% of non-sky pixels
    within 1e-3 relative, the frame gate of tests/test_torch_variants.py
    (transcendentals differ by ulps between XLA and torch, and a path on
    a roulette or hit edge takes another branch).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu.config import NoiseMethod, PTConfig, PTSettings
from unitysspathtracingurp_tpu.models import fixtures as jfixtures
from unitysspathtracingurp_tpu.models import native_raster
from unitysspathtracingurp_tpu.models import probes as jprobes
from unitysspathtracingurp_tpu.models import scene as jscene
from unitysspathtracingurp_tpu.ops import blue_noise as jblue
from unitysspathtracingurp_tpu.ops import envprobe as jenv
from unitysspathtracingurp_tpu.ops import pathtrace as jpathtrace
from unitysspathtracingurp_tpu.ops import rng as jrng

from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch import config as tconfig
from unitysspathtracingurp_tpu_torch.models import fixtures as tfixtures
from unitysspathtracingurp_tpu_torch.models import probes as tprobes
from unitysspathtracingurp_tpu_torch.models import scene as tscene
from unitysspathtracingurp_tpu_torch.models.renderer import Renderer
from unitysspathtracingurp_tpu_torch.ops import blue_noise as tblue
from unitysspathtracingurp_tpu_torch.ops import envprobe as tenv
from unitysspathtracingurp_tpu_torch.ops import pathtrace as tpathtrace
from unitysspathtracingurp_tpu_torch.ops import rng as trng
from unitysspathtracingurp_tpu_torch.utils.metrics import frame_agreement

torch.set_num_threads(1)
RS = np.random.default_rng(2024)
JAX_TABLES = Path(jblue.__file__).parent / "_blue_noise_tables.npz"


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


def _probe_leaves(p):
    """An EnvProbe's leaves, its mip chain as a list of arrays."""
    return {f.name: ([np.asarray(m) for m in p.mips] if f.name == "mips"
                     else np.asarray(getattr(p, f.name))) for f in dataclasses.fields(p)}


@pytest.fixture(scope="module")
def tables():
    """The JAX tables (its committed file) and the port's, carried across."""
    jt = jblue.BlueNoiseTables()
    return jt, convert.blue_noise_tables(
        {k: np.asarray(getattr(jt, k)) for k in ("sobol", "ranking", "scrambling")}, device="cpu")


# ---------------------------------------------------------------- uint32 primitives

_U32 = np.concatenate([RS.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32),
                       np.array([0, 0xFFFFFFFF, 0x80000000, 1], np.uint32)])
_SEEDS = np.concatenate([RS.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32),
                         np.array([0xFFFFFFFF, 0xFFFFFFFF, 0, 0x80000000], np.uint32)])


@pytest.mark.parametrize("name,jax_fn,port_fn", [
    ("reverse_bits_u32", lambda x, s: jrng.reverse_bits_u32(x),
     lambda x, s: trng.reverse_bits_u32(x)),
    ("laine_karras", jrng._laine_karras, trng._laine_karras),
    ("nested_uniform_scramble", jrng.nested_uniform_scramble, trng.nested_uniform_scramble),
    ("sobol_pair_0", lambda x, s: jrng._sobol_pair(x, jnp.zeros_like(x)),
     lambda x, s: trng._sobol_pair(x, 0)),
    ("sobol_pair_1", lambda x, s: jrng._sobol_pair(x, jnp.ones_like(x)),
     lambda x, s: trng._sobol_pair(x, 1)),
])
def test_sampler_primitives_bit_exact(name, jax_fn, port_fn):
    """On numpy-seeded uint32 and 0, 0xFFFFFFFF, 0x80000000 (the products
    of Laine-Karras at their largest)."""
    want = np.asarray(jax_fn(jnp.asarray(_U32), jnp.asarray(_SEEDS))).astype(np.int64)
    got = port_fn(torch.as_tensor(_U32.astype(np.int64)), torch.as_tensor(_SEEDS.astype(np.int64)))
    assert np.array_equal(got.numpy(), want), name


# ---------------------------------------------------------------- draw streams


def _gather(jr, tr, idx, shape):
    """Compaction: both RNGs re-domained onto the lanes ``idx``."""
    jidx = jnp.asarray(idx)
    jr = jr.replace(pix_x=jr.pix_x.reshape(-1)[jidx].reshape(shape),
                    pix_y=jr.pix_y.reshape(-1)[jidx].reshape(shape),
                    seed=jr.seed.reshape(-1)[: idx.size].reshape(shape))
    tidx = torch.as_tensor(idx)
    tr = dataclasses.replace(tr, pix_x=tr.pix_x.reshape(-1)[tidx].reshape(shape),
                             pix_y=tr.pix_y.reshape(-1)[tidx].reshape(shape))
    return jr, tr


@pytest.mark.parametrize("mode", ["blue_noise", "sobol_owen"])
@pytest.mark.parametrize("frame_index", [33 * 77, 33 * 300])  # epoch 0, epoch 1
def test_draw_streams_bit_exact(tables, mode, frame_index):
    """24 draws on an 8x8 grid, ``draw`` and ``draw2`` mixed so that the
    counter is odd and even before a draw2, the last 10 on a gathered
    subset of 24 lanes."""
    jt, tt = tables
    blue = mode == "blue_noise"
    jr = jrng.make_rng(8, 8, frame_index, jt if blue else None, sobol_owen=not blue)
    tr = trng.make_rng(8, 8, frame_index, "cpu", tt if blue else None, sobol_owen=not blue)
    draws = 0
    for i, kind in enumerate([1, 2, 1, 1, 2, 2, 1, 2, 1, 1, 2, 1, 2, 1]):
        if i == 8:
            idx = RS.permutation(64)[:24]
            jr, tr = _gather(jr, tr, idx, (3, 8))
        (jv, jr), (tv, tr) = (jrng.draw(jr), trng.draw(tr)) if kind == 1 else (
            jrng.draw2(jr), trng.draw2(tr))
        assert np.array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32)), i
        assert tr.seed == int(np.asarray(jr.seed).reshape(-1)[0])
        draws += kind
    assert draws >= 20
    if frame_index == 33 * 300 and blue:
        assert trng.blue_noise_rotation(frame_index, 1) != 0.0


# ---------------------------------------------------------------- tables


def test_committed_tables_equal_jax():
    """The port's committed tables (the default of BlueNoiseTables) are
    the JAX package's, bit for bit."""
    ours = np.load(tblue.DEFAULT_CACHE)
    theirs = np.load(JAX_TABLES)
    assert int(ours["version"]) == int(theirs["version"]) == 2
    loaded = tblue.BlueNoiseTables(device="cpu")
    for k, shape in (("sobol", (256, 256)), ("ranking", (131072,)), ("scrambling", (131072,))):
        assert ours[k].dtype == np.uint32 and ours[k].shape == shape
        assert np.array_equal(ours[k], theirs[k]), k
        got = getattr(loaded, k)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), theirs[k].astype(np.int32))


def test_table_generator_pieces_match_jax():
    assert np.array_equal(tblue.sequence_table(), np.load(JAX_TABLES)["sobol"])
    for seed in (0, 101):
        assert np.array_equal(tblue._void_and_cluster(32, seed), jblue._void_and_cluster(32, seed))


@pytest.mark.slow
def test_generator_regenerates_committed_tables(tmp_path):
    """The full generator (16 masks of 128x128, about a minute and a half)."""
    got = tblue.generate_tables(cache_path=str(tmp_path / "tables.npz"))
    theirs = np.load(JAX_TABLES)
    for k in ("sobol", "ranking", "scrambling"):
        assert np.array_equal(got[k], theirs[k]), k
    assert np.array_equal(np.load(tmp_path / "tables.npz")["ranking"], theirs["ranking"])


# ---------------------------------------------------------------- probes


def _random_probe(rs, res, box, position):
    tex = rs.uniform(0.0, 2.0, (res, res, 3)).astype(np.float32)
    jp = jenv.EnvProbe(
        texture=jnp.asarray(tex), hdr_mult=jnp.asarray(1.5, jnp.float32),
        box_min=jnp.asarray([-3.0, 0.0, -3.0], jnp.float32),
        box_max=jnp.asarray([3.0, 4.0, 3.0], jnp.float32),
        position=jnp.asarray(position, jnp.float32),
        box_projection=jnp.asarray(1.0 if box else 0.0, jnp.float32),
        mips=jenv.build_probe_mips(jnp.asarray(tex)))
    return jp


@pytest.mark.parametrize("probe_set,weight,camera", [(1.0, 0.3, 0.0), (1.0, 0.0, 1.0),
                                                     (0.0, 0.3, 1.0), (0.0, 0.0, 0.0)])
def test_sample_reflection_probes_matches_jax(probe_set, weight, camera):
    """Two 16x16 probes with mips, one box-projected, directions with
    exact zero components among them, positions inside the box; the
    blend (probe_set 0 turns off probe 0 alone), the probe camera's
    damping."""
    rs = np.random.default_rng(5)
    d = rs.normal(size=(600, 3)).astype(np.float32)
    d[:40, 0] = 0.0
    d[40:60, 1:] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = rs.uniform([-2.5, 0.2, -2.5], [2.5, 3.8, 2.5], (600, 3)).astype(np.float32)
    p0 = _random_probe(rs, 16, True, (-1.5, 2.2, 0.0))
    p1 = _random_probe(rs, 16, False, (1.5, 2.2, 0.0))
    jset = jenv.ProbeSet(probe0=p0, probe1=p1, blend_weight=jnp.asarray(weight, jnp.float32),
                         probe_set=jnp.asarray(probe_set, jnp.float32),
                         is_probe_camera=jnp.asarray(camera, jnp.float32))
    tset = convert.probe_set(_probe_leaves(p0), _probe_leaves(p1), weight, probe_set, camera,
                             device="cpu")
    for mip in (1.0, 0.5):
        want = np.asarray(jenv.sample_reflection_probes(jset, jnp.asarray(d), jnp.asarray(pos),
                                                        mip_level=mip))
        got = tenv.sample_reflection_probes(tset, torch.as_tensor(d), torch.as_tensor(pos),
                                            mip_level=mip).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        if probe_set == 0.0 and weight == 0.0:  # probe 0 off, nothing blended in
            assert not got.any()
    jp4 = jenv.ProbeSet(probe0=_random_probe(rs, 4, True, (0.0, 2.0, 1.8)))
    tp4 = convert.probe_set(_probe_leaves(jp4.probe0), device="cpu")
    np.testing.assert_allclose(
        tenv.sample_reflection_probes(tp4, torch.as_tensor(d), torch.as_tensor(pos)).numpy(),
        np.asarray(jenv.sample_reflection_probes(jp4, jnp.asarray(d), jnp.asarray(pos))),
        rtol=0, atol=2e-6)


def _numpy_intersections(monkeypatch):
    """The JAX package's numpy intersections (its native rasterizer off)."""
    monkeypatch.setattr(native_raster, "intersect_scene_native", lambda *a, **k: None)


def test_bake_probe_matches_jax(monkeypatch):
    _numpy_intersections(monkeypatch)
    sc_j, sc_t = jscene.build_box_scene(), tscene.build_box_scene()
    for kw in ({}, {"box_min": (-3.0, 0.0, -3.0), "box_max": (3.0, 4.0, 3.0)}):
        jp = jprobes.bake_probe(sc_j, (0.5, 2.0, 0.3), resolution=8, bounce_samples=4, seed=3, **kw)
        tp = tprobes.bake_probe(sc_t, (0.5, 2.0, 0.3), resolution=8, bounce_samples=4, seed=3,
                                device="cpu", **kw)
        assert np.array_equal(tp.texture.numpy(), np.asarray(jp.texture))
        for name in ("hdr_mult", "box_min", "box_max", "position", "box_projection"):
            assert np.array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name))), name
        assert len(tp.mips) == len(jp.mips) == 4
        for got, want in zip(tp.mips, jp.mips):
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


def test_closest_probes_and_box_scene_probes_match_jax(monkeypatch):
    _numpy_intersections(monkeypatch)
    jset = jfixtures.box_scene_probes(resolution=8)
    tset = tfixtures.box_scene_probes(resolution=8, device="cpu")
    assert tfixtures.BOX_PROBE_POSITIONS == jfixtures.BOX_PROBE_POSITIONS
    assert np.array_equal(tset.blend_weight.numpy(), np.asarray(jset.blend_weight))
    assert float(tset.probe_set) == float(jset.probe_set) == 1.0
    for a, b in ((tset.probe0, jset.probe0), (tset.probe1, jset.probe1)):
        assert np.array_equal(a.position.numpy(), np.asarray(b.position))
        assert np.array_equal(a.texture.numpy(), np.asarray(b.texture))
    one = tprobes.closest_probes([tset.probe0], [(0.0, 0.0, 0.0)], (1.0, 1.0, 1.0), device="cpu")
    assert one.probe1 is None and float(one.probe_set) == 1.0
    # The Renderer binds the same two probes the binder picks.
    cam = tfixtures.box_scene_camera(8, 8, device="cpu")
    r = Renderer(tconfig.PTSettings(), 8, 8, device="cpu")
    r.bind_probes(tfixtures.bake_box_scene_probes(resolution=8, device="cpu"),
                  tfixtures.BOX_PROBE_POSITIONS, cam)
    assert np.array_equal(r.probes.blend_weight.numpy(), np.asarray(jset.blend_weight))
    assert np.array_equal(r.probes.probe1.texture.numpy(), np.asarray(jset.probe1.texture))


# ---------------------------------------------------------------- frames

FH = FW = 32


@pytest.fixture(scope="module")
def box32():
    sc = jscene.build_box_scene()
    cam = jfixtures.box_scene_camera(FH, FW)
    gb = jfixtures.rasterize_gbuffers(sc, cam, FH, FW)
    return dict(gb=gb, cam=cam, non_sky=np.asarray(gb.depth) != 0.0,
                tgb=convert.gbuffers(_np_tree(gb), device="cpu"),
                tcam=convert.camera(_np_tree(cam), device="cpu"))


def _assert_frame_close(port, ref, non_sky):
    assert np.isfinite(port).all()
    rel, within = frame_agreement(port, ref, non_sky)
    print(f"pooled relative RMSE {rel:.3e}, non-sky pixels within 1e-3 {within:.6f}")
    assert rel < 0.01, f"pooled relative RMSE {rel:.5f}"
    assert within >= 0.99, f"non-sky pixels within 1e-3: {within:.5f}"


def _parity_pair(box32, settings, jprobe_set, tprobe_set, jt=None, tt=None, frame=33 * 300):
    cfg = PTConfig(march_unroll=1)
    ref = jax.jit(lambda fi: jpathtrace.trace_frame(
        box32["gb"], box32["cam"], jprobe_set, settings, cfg, settings.variants(), fi,
        rng_tables=jt))(jnp.uint32(frame))
    ts = convert.pt_settings(settings)
    got = tpathtrace.trace_frame(box32["tgb"], box32["tcam"], tprobe_set, ts,
                                 convert.pt_config(cfg), ts.variants(), frame,
                                 march_fn=tpathtrace.ray_march, rng_tables=tt)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("method,lit", [(NoiseMethod.BLUE_NOISE, False),
                                         (NoiseMethod.SOBOL_OWEN, True)])
def test_parity_frame_matches_jax(box32, tables, monkeypatch, method, lit):
    """One parity frame (P1's plain version), 1 bounce, with step
    dithering, in epoch 1: blue noise under the constant probe, and
    Sobol-Owen lit by the BoxScene probes (resolution 8) on its misses."""
    jt, tt = tables if method == NoiseMethod.BLUE_NOISE else (None, None)
    s = PTSettings(maximum_depth=1, maximum_steps=24, dithering=True, noise_method=method)
    if lit:
        _numpy_intersections(monkeypatch)
        jp = jfixtures.box_scene_probes(resolution=8)
        tp = convert.probe_set(_probe_leaves(jp.probe0), _probe_leaves(jp.probe1),
                               np.asarray(jp.blend_weight), np.asarray(jp.probe_set),
                               device="cpu")
    else:
        jp = jenv.ProbeSet(probe0=jenv.constant_probe([0.05, 0.06, 0.08]))
        tp = convert.probe_set(_np_tree(jp.probe0), device="cpu")
    got, want = _parity_pair(box32, s, jp, tp, jt, tt)
    _assert_frame_close(got, want, box32["non_sky"])


@pytest.mark.parametrize("kernel", ["hiz", "xla"])
@pytest.mark.parametrize("denoiser", [tconfig.DenoiserType.OFFLINE, tconfig.DenoiserType.TEMPORAL])
def test_renderer_runs_both_samplers(box32, kernel, denoiser):
    """The Renderer in both sampler modes, on both marches, offline and
    temporal: its pass 0 is ``trace_frame`` with its tables (blue noise:
    built once, on its device)."""
    for method in (tconfig.NoiseMethod.BLUE_NOISE, tconfig.NoiseMethod.SOBOL_OWEN):
        s = tconfig.PTSettings(maximum_depth=1, maximum_samples=4, denoiser=denoiser,
                               progress_bar=False, noise_method=method)
        r = Renderer(s, FH, FW, kernel=kernel, device="cpu")
        assert (r.rng_tables is not None) == (method == tconfig.NoiseMethod.BLUE_NOISE)
        out = r.render_frame(box32["tgb"], box32["tcam"])
        assert out.shape == (FH, FW, 3) and torch.isfinite(out).all() and out.sum() > 0
