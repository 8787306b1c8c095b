"""The unfused resolve rounds (``PTConfig.pallas_extract``) of the port, on the CPU.

K5 (``extract_chain``) and K7 (``rowwise_select``) run their plain
PyTorch versions here (CPU tensors). They are held against the JAX
kernels in interpret mode on the JAX package's own cases
(tests/test_hiz.py:42-63, :268-289); the unfused rounds against the
port's plain R1 (``resolve_rounds_ref``) in every mode the march dispatches;
one JAX march with ``pallas_extract=True`` against the port's; and a
port frame with the unfused rounds against the default frame.

Tolerances, and why:
  * bit-exact: K5 and K7 against the JAX kernels (one selected value per
    output; -0.0 comes back +0.0 from K5's masked sums), and the unfused
    rounds, marches and frame against the R1 form. The two forms share
    the link math and the hit rule, and a valid link's slot lies inside
    the round's window (ptr <= r * chain in global round r), so every
    row is the same;
  * the JAX march: hit agreement >= 0.9995 and uv agreement >= 0.999,
    the gate of tests/test_torch_march.py:20-22 (two f32 op chains of
    the same math may differ by an ulp at a window edge).

The gated values each test observed print with ``pytest -rP``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitysspathtracingurp_tpu.camera import linear_eye_depth, pixel_uv, world_from_uv_depth
from unitysspathtracingurp_tpu.config import PTConfig, PTSettings
from unitysspathtracingurp_tpu.models import fixtures, scene
from unitysspathtracingurp_tpu.ops import pallas_gather as jgather
from unitysspathtracingurp_tpu.ops import pathtrace_hiz
from unitysspathtracingurp_tpu.ops.depth_tiles import build_depth_tiles

from unitysspathtracingurp_tpu_torch import config as tconfig
from unitysspathtracingurp_tpu_torch import convert
from unitysspathtracingurp_tpu_torch.camera import linear_eye_depth as t_linear_eye_depth
from unitysspathtracingurp_tpu_torch.camera import pixel_uv as t_pixel_uv
from unitysspathtracingurp_tpu_torch.camera import world_from_uv_depth as t_world_from_uv_depth
from unitysspathtracingurp_tpu_torch.models import fixtures as tfixtures
from unitysspathtracingurp_tpu_torch.models import scene as tscene
from unitysspathtracingurp_tpu_torch.ops import fused_schedule as tfused
from unitysspathtracingurp_tpu_torch.ops import pallas_gather as tgather
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as tph
from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_home_strips
from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe

torch.set_num_threads(1)

STEPS = 24
ROUNDS = 4


def _bits(t):
    """A tensor's bits, for bit-exact comparison (floats as int32)."""
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a, b):
    return torch.equal(_bits(a), _bits(b))


# ------------------------------------------------------- K5 and K7 plain


@pytest.mark.parametrize("n_fields", [3, 4])
def test_extract_chain_ref_matches_jax(n_fields):
    """tests/test_hiz.py:268-289's case: K 16, N 700, chain 4, slot_hi 12,
    ptr in [0, K + 2); plus -0.0 entries."""
    rng = np.random.default_rng(5 + n_fields)
    k, n, chain, slot_hi = 16, 700, 4, 12
    fields = [rng.uniform(size=(k, n)).astype(np.float32) * 1e4 for _ in range(n_fields)]
    fields[0][rng.random((k, n)) < 0.2] = -0.0
    ptr = rng.integers(0, k + 2, size=(n,)).astype(np.int32)
    ref = jgather.extract_chain([jnp.asarray(f) for f in fields], jnp.asarray(ptr), chain,
                                slot_hi)
    got = tgather.extract_chain([torch.from_numpy(f) for f in fields], torch.from_numpy(ptr),
                                chain, slot_hi)
    assert len(got) == n_fields
    for g, r in zip(got, ref):
        assert g.shape == (chain, n) and g.dtype == torch.float32
        assert np.array_equal(g.numpy().view(np.int32), np.asarray(r).view(np.int32))
    zeros = (got[0] == 0).sum().item()
    print(f"{n_fields} fields: {zeros} zero entries (window and -0.0) of {chain * n}")
    assert zeros > 0 and not np.signbit(got[0].numpy()).any()


@pytest.mark.parametrize("kind,k", [("f32", 24), ("u32", 4), ("u32", 128)])
def test_rowwise_select_ref_matches_jax(kind, k):
    """tests/test_hiz.py:42-63's cases, with indices up to 255 (masked
    with & 127); u32 blocks hold NaN-payload f16 pairs and move as int32."""
    rng = np.random.default_rng(k)
    if kind == "f32":
        blocks = rng.uniform(size=(512, 128)).astype(np.float32)
    else:
        blocks = rng.integers(0, 2**32, size=(512, 128), dtype=np.uint64).astype(np.uint32)
        blocks[::7, ::5] = 0x7E017C01
    idx = rng.integers(0, 256, size=(512, k)).astype(np.int32)
    ref = np.asarray(jgather.rowwise_select(jnp.asarray(blocks), jnp.asarray(idx)))
    tb = torch.from_numpy(blocks if kind == "f32" else blocks.view(np.int32))
    got = tgather.rowwise_select(tb, torch.from_numpy(idx))
    assert got.dtype == tb.dtype and got.shape == (512, k)
    assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    assert (idx >= 128).any()


# ----------------------------------------- the unfused rounds against R1's


def _march_inputs(gb, cam):
    """Bounce-0 reflection rays tilted as tests/test_fused_schedule.py:36-61."""
    h, w = gb.height, gb.width
    uv = t_pixel_uv(h, w, device="cpu")
    pos = t_world_from_uv_depth(cam.inv_view_proj, uv, gb.depth)
    view = pos - cam.position
    view = view / view.norm(dim=-1, keepdim=True)
    nrm = gb.normal
    d = view - 2.0 * (view * nrm).sum(-1, keepdim=True) * nrm + 0.3 * torch.stack(
        [torch.cos(uv[..., 0] * 7.0), torch.sin(uv[..., 1] * 5.0), torch.cos(uv[..., 0] * 3.0)],
        -1)
    d = d / d.norm(dim=-1, keepdim=True)
    return dict(origin=pos + nrm * 1e-4, d=d, alive=gb.depth != 0.0, view_dir=view,
                scene_dist=t_linear_eye_depth(gb.depth, cam.near, cam.far))


@pytest.fixture(scope="module")
def port_box():
    """BoxScene at 64x128 lanes and the glass box at 32x64, built by the port."""
    out = {}
    for name, (h, w, glass) in {"plain": (64, 128, False), "glass": (32, 64, True)}.items():
        cam = tfixtures.box_scene_camera(h, w, device="cpu")
        sc = (tscene.build_box_scene(with_glass=True, with_mirror=False) if glass
              else tscene.build_box_scene())
        gb = tfixtures.rasterize_gbuffers(sc, cam, h, w, device="cpu", with_backface=glass)
        settings = tconfig.PTSettings(
            maximum_steps=STEPS, dithering=False, support_refraction=glass,
            accurate_thickness=tconfig.ThicknessMode.DEPTH_NORMALS if glass
            else tconfig.ThicknessMode.CONSTANT)
        out[name] = dict(gb=gb, cam=cam, settings=settings, x=_march_inputs(gb, cam),
                         tiles=tph.build_tiles_for(gb, cam, settings.variants()))
    return out


def _lane_args(c):
    x = c["x"]
    h, w = x["alive"].shape
    n = h * w
    large = c["settings"].step_size + (20.0 - c["settings"].step_size) * x["scene_dist"] * 0.001
    is_back = ((x["d"] * -x["view_dir"]).sum(-1) > 0.0).reshape(n)
    return (x["origin"].reshape(n, 3), x["d"].reshape(n, 3), torch.zeros(n), large.reshape(n),
            x["alive"].reshape(n)), is_back


@pytest.mark.parametrize("mode", ["zero start", "K6 state", "dual 0", "dual 1", "dual 2"])
def test_unfused_rounds_equal_r1_rows(port_box, monkeypatch, mode):
    """resolve_rounds_unfused / _dual_unfused against the R1 form, every
    row bit for bit, all 4 rounds in one call and one round at a time
    from the state in between (round_base 0..3: slot windows 4..16)."""
    dual = mode.startswith("dual")
    c = port_box["glass" if dual else "plain"]
    tiles, cam = c["tiles"], c["cam"]
    lanes, is_back = _lane_args(c)
    n = is_back.shape[0]
    scalars = tfused.schedule_scalars(cam)
    kw = tfused.march_kwargs(tconfig.PTConfig(), tiles, STEPS)
    r_kw = dict(gh=tiles.height, gw=tiles.width, n_rounds=ROUNDS, chain=4, s_max=STEPS)
    windows = []
    real = tph.extract_chain

    def spy(fields, ptr, chain, slot_hi):
        windows.append((len(fields), slot_hi))
        return real(fields, ptr, chain, slot_hi)

    monkeypatch.setattr(tph, "extract_chain", spy)
    state = None
    if dual:
        inside = int(mode[-1])
        combo = torch.full((n,), inside, dtype=torch.int32)
        search = is_back | (inside == 2)
        packs = tfused.schedule_pack_dual_ref(*lanes, combo, search, tiles.mini_table,
                                              tiles.bmax_table, scalars,
                                              chunks_per_combo=tiles.chunks_per_combo, **kw)
        args = (*packs, lanes[0], lanes[1], is_back, combo, search, tiles.tile_table, scalars)
        r_kw.update(tiles_x=tiles.tiles_x, tiles_per_combo=tiles.tiles_per_combo, has_back=True)
        ref_fn, fn = tph.resolve_rounds_dual_ref, tph.resolve_rounds_dual_unfused
    else:
        if mode == "K6 state":
            h, w = c["x"]["alive"].shape
            *packs, home = tfused.schedule_pack_home_ref(
                *lanes, is_back, tiles.mini_table, build_home_strips(tiles, h, w), scalars,
                home_shape=(h, w), **kw)
            state = torch.cat([torch.zeros_like(home[:1]), home])
        else:
            packs = tfused.schedule_pack_ref(*lanes, is_back, tiles.mini_table, scalars, **kw)
        args = (*packs, lanes[0], lanes[1], is_back, tiles.pair_table, scalars)
        r_kw.update(pairs_x=tiles.pairs_x)
        ref_fn, fn = tph.resolve_rounds_ref, tph.resolve_rounds_unfused
    ref = ref_fn(*args, state=state, **r_kw)
    got = fn(*args, state=state, **r_kw)
    step = tph.zero_state(n, dual, "cpu") if state is None else state
    for r in range(ROUNDS):
        step = fn(*args, state=step, round_base=r, **dict(r_kw, n_rounds=1))
    nf = 4 if dual else 3
    assert windows == [(nf, 4), (nf, 8), (nf, 12), (nf, 16)] * 2
    rows = ref if state is None else ref[1:]
    hit = rows[0] > 0.5
    print(f"{mode}: {ref.shape[0]} rows, hits {int(hit.sum())} of {n}, lanes with candidates "
          f"{int((packs[-1] > 0).sum())}")
    assert got.shape == ref.shape and _same_bits(got, ref)
    assert _same_bits(step[1:] if state is None else step, ref)
    assert hit.sum() > 50 and (state is None or (rows[0] > state[1]).any())


def _march(c, cfg, **kw):
    x = c["x"]
    zero = torch.zeros(x["alive"].shape)
    s = c["settings"]
    return tph.ray_march_hiz(cfg, s, s.variants(), c["gb"], c["cam"], x["origin"], x["d"],
                             zero, zero, -x["view_dir"], x["scene_dist"], x["alive"],
                             tiles=c["tiles"], n_rounds=ROUNDS, **kw)


def _assert_march_same(a, b):
    for name, va, vb in zip(a._fields, a, b):
        assert _same_bits(va, vb), name


def test_round_cap_and_diagnostic_marches_equal(port_box, monkeypatch):
    """hiz_round_cap=0.1 at 64x128 lanes (lanes dropped), as the main
    path and as the diagnostic march: the unfused rounds equal R1's, the
    compacted rounds continue the slot window past the dense round, and
    every diagnostic counter is the same."""
    c = port_box["plain"]
    cfg = tconfig.PTConfig(hiz_round_cap=0.1)
    cfg_x = dataclasses.replace(cfg, pallas_extract=True)
    windows = []
    real = tph.extract_chain

    def spy(fields, ptr, chain, slot_hi):
        windows.append((ptr.shape[0], slot_hi))
        return real(fields, ptr, chain, slot_hi)

    monkeypatch.setattr(tph, "extract_chain", spy)
    n = c["x"]["alive"].numel()
    _assert_march_same(_march(c, cfg_x), _march(c, cfg))
    assert windows == [(n, 4), (1024, 8), (1024, 12), (1024, 16)]
    dbg, dbg_x = {}, {}
    _assert_march_same(_march(c, cfg_x, _debug_out=dbg_x), _march(c, cfg, _debug_out=dbg))
    assert dbg["c0_round_compact_drop"] > 0
    assert sorted(dbg_x) == sorted(dbg)
    for key in dbg:
        if key.startswith("c0_") and key != "c0_pk":
            assert torch.equal(torch.as_tensor(dbg_x[key]), torch.as_tensor(dbg[key])), key
    print(f"lanes dropped {int(dbg['c0_round_compact_drop'])}, active "
          + ", ".join(str(int(dbg[f"c0_active_r{r}"])) for r in range(ROUNDS)))


def test_home_march_equal(port_box):
    """The home prefix (K6's state) with hiz_home_round_cap: the march
    with the unfused rounds equals the R1 march."""
    c = port_box["plain"]
    cfg = tconfig.PTConfig(hiz_home_prefix=True, hiz_home_round_cap=0.25)
    a = _march(c, dataclasses.replace(cfg, pallas_extract=True), home_ok=True)
    _assert_march_same(a, _march(c, cfg, home_ok=True))
    assert a.hit.sum() > 50


# ------------------------------------------------------ against the JAX march


def _np_tree(obj):
    return {
        f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, bool))
    }


def test_ray_march_matches_jax_pallas_extract():
    """JAX ray_march_hiz with PTConfig(pallas_extract=True) (its extract
    kernel in interpret mode) against the port's, 32x128 lanes, 4 rounds."""
    h, w = 32, 128
    cam = fixtures.box_scene_camera(h, w)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(), cam, h, w)
    uv = pixel_uv(h, w)
    pos = world_from_uv_depth(cam.inv_view_proj, uv, gb.depth)
    view = pos - cam.position
    view = view / jnp.linalg.norm(view, axis=-1, keepdims=True)
    nrm = gb.normal
    d = view - 2.0 * jnp.sum(view * nrm, -1, keepdims=True) * nrm + 0.3 * jnp.stack(
        [jnp.cos(uv[..., 0] * 7.0), jnp.sin(uv[..., 1] * 5.0), jnp.cos(uv[..., 0] * 3.0)], -1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    x = dict(origin=pos + nrm * 1e-4, d=d, alive=gb.depth != 0.0, view_dir=view,
             scene_dist=linear_eye_depth(gb.depth, cam.near, cam.far))
    settings = PTSettings(maximum_steps=STEPS, dithering=False)
    tiles = build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)
    zero = jnp.zeros((h, w), jnp.float32)
    ref = pathtrace_hiz.ray_march_hiz(
        PTConfig(pallas_extract=True), settings, settings.variants(), gb, cam, x["origin"],
        x["d"], zero, zero, -x["view_dir"], x["scene_dist"], x["alive"], tiles=tiles,
        n_rounds=ROUNDS)
    tx = {k: torch.as_tensor(np.array(v)) for k, v in x.items()}
    ttiles = convert.depth_tiles(
        tiles.pair_table, tiles.mini_table, height=tiles.height, width=tiles.width,
        tiles_x=tiles.tiles_x, tiles_y=tiles.tiles_y, pairs_x=tiles.pairs_x,
        minis_x=tiles.minis_x, device="cpu")
    tcfg = convert.pt_config(PTConfig(pallas_extract=True))
    assert tcfg.pallas_extract is True
    tzero = torch.zeros(h, w)
    res = tph.ray_march_hiz(
        tcfg, convert.pt_settings(settings), convert.pt_variants(settings.variants()),
        convert.gbuffers(_np_tree(gb), device="cpu"), convert.camera(_np_tree(cam), device="cpu"),
        tx["origin"], tx["d"], tzero, tzero, -tx["view_dir"], tx["scene_dist"], tx["alive"],
        tiles=ttiles, n_rounds=ROUNDS)
    f_hit, s_hit = res.hit.numpy(), np.asarray(ref.hit)
    agree = (f_hit == s_hit).mean()
    both = f_hit & s_hit
    uv_same = (np.abs(res.uv.numpy() - np.asarray(ref.uv)).max(-1)[both] < 1e-6).mean()
    print(f"hits {s_hit.sum()}: hit agreement {agree:.6f}, uv agreement {uv_same:.6f}")
    assert both.mean() > 0.2
    assert agree >= 0.9995 and uv_same >= 0.999


# ------------------------------------------------------------------ frame


def test_frame_with_unfused_rounds_equals_default_frame():
    """A port frame (40x96, 2 bounces, headline config) with
    pallas_extract=True is bit-equal to the default frame."""
    h, w = 40, 96
    cam = tfixtures.box_scene_camera(h, w, device="cpu")
    gb = tfixtures.rasterize_gbuffers(tscene.build_box_scene(), cam, h, w, device="cpu")
    probes = ProbeSet(probe0=constant_probe([0.05, 0.06, 0.08], device="cpu"))
    s = tconfig.PTSettings(maximum_depth=2, maximum_steps=STEPS, dithering=False)
    cfg = tconfig.PTConfig.boxscene_headline()
    frames = [tph.trace_frame_hiz(gb, cam, probes, s, c, s.variants(), 7)
              for c in (cfg, dataclasses.replace(cfg, pallas_extract=True))]
    assert torch.isfinite(frames[0]).all() and frames[0].abs().sum() > 0
    assert _same_bits(frames[1], frames[0])
