"""The CUDA kernels (K1, R1, K4, R1's dual mode, K6, K2, K3 and R1's
state-in form) against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device. On a
machine with an NVIDIA GPU (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: bit-exact. Kernel and plain version run the same f32
operation chain (the kernels build with --fmad=false, divides are IEEE)
on the same device.
"""

import pytest
import torch

from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings, ThicknessMode
from unitysspathtracingurp_tpu_torch.kernels.build import LAUNCHES
from unitysspathtracingurp_tpu_torch.models import fixtures, scene
from unitysspathtracingurp_tpu_torch.camera import linear_eye_depth, pixel_uv, world_from_uv_depth
from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
from unitysspathtracingurp_tpu_torch.ops import pallas_gather as pg
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_depth_tiles, build_home_strips

pytestmark = pytest.mark.cuda
H, W = 96, 160


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cam = fixtures.box_scene_camera(H, W, device=dev)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(), cam, H, W, device=dev)
    tiles = build_depth_tiles(gb.depth, cam.near, cam.far)
    g = torch.Generator().manual_seed(7)
    n = H * W
    d = torch.randn(n, 3, generator=g)
    d = (d / d.norm(dim=-1, keepdim=True)).to(dev)
    origin = (torch.rand(n, 3, generator=g) * torch.tensor([5.0, 3.5, 5.0])
              - torch.tensor([2.5, 0.0, 2.5])).to(dev)
    k1_args = (origin, d, torch.zeros(n, device=dev), torch.full((n,), 0.5, device=dev),
               torch.ones(n, dtype=torch.bool, device=dev), d[:, 2] > 0.3,
               tiles.mini_table, fs.schedule_scalars(cam))
    return tiles, k1_args, fs.march_kwargs(PTConfig(), tiles, 24)


def test_schedule_pack_kernel_bit_exact(case):
    _, args, kw = case
    before = LAUNCHES["schedule_pack"]
    got = fs.schedule_pack(*args, **kw)
    ref = fs.schedule_pack_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_pack"] == before + 1
    assert (ref[3] > 0).float().mean() > 0.2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_resolve_rounds_kernel_bit_exact(case):
    tiles, args, kw = case
    packs = fs.schedule_pack_ref(*args, **kw)
    r_args = (*packs, args[0], args[1], args[5], tiles.pair_table, args[7])
    r_kw = dict(gh=H, gw=W, pairs_x=tiles.pairs_x, n_rounds=4, chain=4, s_max=24)
    before = LAUNCHES["resolve_rounds"]
    got = ph.resolve_rounds(*r_args, **r_kw)
    ref = ph.resolve_rounds_ref(*r_args, **r_kw)
    torch.cuda.synchronize()
    assert LAUNCHES["resolve_rounds"] == before + 1
    assert got[0].mean() > 0.1
    assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def dual_case():
    """Random rays in the glass box at 256^2 lanes, with the refraction +
    backface (3-combo) tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    h = w = 256
    cam = fixtures.box_scene_camera(h, w, device=dev)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(with_glass=True, with_mirror=False),
                                     cam, h, w, device=dev, with_backface=True)
    variants = PTSettings(support_refraction=True,
                          accurate_thickness=ThicknessMode.DEPTH_NORMALS).variants()
    tiles = ph.build_tiles_for(gb, cam, variants)
    g = torch.Generator().manual_seed(11)
    n = h * w
    d = torch.randn(n, 3, generator=g)
    d = (d / d.norm(dim=-1, keepdim=True)).to(dev)
    origin = (torch.rand(n, 3, generator=g) * torch.tensor([5.0, 3.5, 5.0])
              - torch.tensor([2.5, 0.0, 2.5])).to(dev)
    return dev, n, h, w, cam, tiles, origin, d, fs.march_kwargs(PTConfig(), tiles, 24)


def _dual_args(dual_case, inside):
    dev, n, h, w, cam, tiles, origin, d, kw = dual_case
    back = d[:, 2] > 0.3
    combo = torch.full((n,), inside, dtype=torch.int32, device=dev)
    search = back | (inside == 2)
    k4_args = (origin, d, torch.zeros(n, device=dev), torch.full((n,), 0.5, device=dev),
               torch.ones(n, dtype=torch.bool, device=dev), combo, search,
               tiles.mini_table, tiles.bmax_table, fs.schedule_scalars(cam))
    k4_kw = dict(kw, chunks_per_combo=tiles.chunks_per_combo)
    r_kw = dict(gh=h, gw=w, tiles_x=tiles.tiles_x, tiles_per_combo=tiles.tiles_per_combo,
                n_rounds=4, chain=4, s_max=24, has_back=True)
    return k4_args, k4_kw, back, r_kw


@pytest.mark.parametrize("inside", [0, 1, 2])
def test_schedule_pack_dual_kernel_bit_exact(dual_case, inside):
    args, kw, _, _ = _dual_args(dual_case, inside)
    before = LAUNCHES["schedule_pack_dual"]
    got = fs.schedule_pack_dual(*args, **kw)
    ref = fs.schedule_pack_dual_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_pack_dual"] == before + 1
    assert (ref[4] > 0).float().mean() > 0.1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inside", [0, 1, 2])
def test_resolve_rounds_dual_kernel_bit_exact(dual_case, inside):
    args, kw, back, r_kw = _dual_args(dual_case, inside)
    packs = fs.schedule_pack_dual_ref(*args, **kw)
    r_args = (*packs, args[0], args[1], back, args[5], args[6], dual_case[5].tile_table,
              args[9])
    before = LAUNCHES["resolve_rounds_dual"]
    got = ph.resolve_rounds_dual(*r_args, **r_kw)
    ref = ph.resolve_rounds_dual_ref(*r_args, **r_kw)
    torch.cuda.synchronize()
    assert LAUNCHES["resolve_rounds_dual"] == before + 1
    assert got.shape == (15, dual_case[1]) and got[0].mean() > 0.02
    assert torch.equal(got, ref)


def test_kernel_rejects_cpu_inputs_on_cuda_call(case, dual_case):
    """Each kernel's wrapper, handed a CPU tensor beside CUDA ones, raises."""
    tiles, args, kw = case
    mixed = list(args)
    mixed[6] = mixed[6].cpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.schedule_pack(*mixed, **kw)
    packs = fs.schedule_pack_ref(*args, **kw)
    r_args = [*packs, args[0], args[1], args[5], tiles.pair_table.cpu(), args[7]]
    with pytest.raises(RuntimeError, match="CUDA"):
        ph.resolve_rounds(*r_args, gh=H, gw=W, pairs_x=tiles.pairs_x, n_rounds=4, chain=4,
                          s_max=24)
    d_args, d_kw, back, r_kw = _dual_args(dual_case, 1)
    mixed = list(d_args)
    mixed[8] = mixed[8].cpu()
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.schedule_pack_dual(*mixed, **d_kw)
    dpacks = fs.schedule_pack_dual_ref(*d_args, **d_kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        ph.resolve_rounds_dual(*dpacks, d_args[0], d_args[1], back, d_args[5], d_args[6],
                               dual_case[5].tile_table.cpu(), d_args[9], **r_kw)


@pytest.fixture(scope="module")
def home_case():
    """BoxScene bounce-0 reflection rays on the screen-ordered 256x256
    grid (tilted as tests/test_fused_schedule.py:36-61), for K6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    h = w = 256
    cam = fixtures.box_scene_camera(h, w, device=dev)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(), cam, h, w, device=dev)
    tiles = build_depth_tiles(gb.depth, cam.near, cam.far)
    uv = pixel_uv(h, w, device=dev)
    pos = world_from_uv_depth(cam.inv_view_proj, uv, gb.depth)
    view = pos - cam.position
    view = view / view.norm(dim=-1, keepdim=True)
    nrm = gb.normal
    d = view - 2.0 * (view * nrm).sum(-1, keepdim=True) * nrm + 0.3 * torch.stack(
        [torch.cos(uv[..., 0] * 7.0), torch.sin(uv[..., 1] * 5.0), torch.cos(uv[..., 0] * 3.0)],
        -1)
    d = (d / d.norm(dim=-1, keepdim=True)).reshape(-1, 3)
    n = h * w
    large = 0.4 + 19.6 * linear_eye_depth(gb.depth, cam.near, cam.far).reshape(n) * 0.001
    args = ((pos + nrm * 1e-4).reshape(n, 3), d, torch.zeros(n, device=dev), large,
            (gb.depth != 0.0).reshape(n), (d * -view.reshape(n, 3)).sum(-1) > 0.0,
            tiles.mini_table, build_home_strips(tiles, h, w), fs.schedule_scalars(cam))
    kw = dict(fs.march_kwargs(PTConfig(), tiles, 24), home_shape=(h, w))
    r_kw = dict(gh=h, gw=w, pairs_x=tiles.pairs_x, n_rounds=4, chain=4, s_max=24)
    return tiles, args, kw, r_kw


def test_schedule_pack_home_kernel_bit_exact(home_case):
    _, args, kw, _ = home_case
    before = LAUNCHES["schedule_pack_home"]
    got = fs.schedule_pack_home(*args, **kw)
    ref = fs.schedule_pack_home_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_pack_home"] == before + 1
    assert ref[4][0].mean() > 0.05 and (ref[3] > 0).float().mean() > 0.05
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_resolve_rounds_state_in_bit_exact(home_case):
    """R1 started from K6's resolve state, and one round at a time."""
    tiles, args, kw, r_kw = home_case
    *packs, home = fs.schedule_pack_home_ref(*args, **kw)
    state = torch.cat([torch.zeros_like(home[:1]), home])
    r_args = (*packs, args[0], args[1], args[5], tiles.pair_table, args[8])
    got = ph.resolve_rounds(*r_args, state=state, **r_kw)
    ref = ph.resolve_rounds_ref(*r_args, state=state, **r_kw)
    step = state
    for _ in range(r_kw["n_rounds"]):
        step = ph.resolve_rounds(*r_args, state=step, **dict(r_kw, n_rounds=1))
    torch.cuda.synchronize()
    assert got.shape == (12, state.shape[1]) and got[1].mean() > home[0].mean()
    assert torch.equal(got, ref) and torch.equal(step, ref)


def test_resolve_rounds_dual_state_in_bit_exact(dual_case):
    """R1's dual mode, 2 rounds then 2 more from the state in between."""
    args, kw, back, r_kw = _dual_args(dual_case, 2)
    packs = fs.schedule_pack_dual_ref(*args, **kw)
    r_args = (*packs, args[0], args[1], back, args[5], args[6], dual_case[5].tile_table,
              args[9])
    whole = ph.resolve_rounds_dual_ref(*r_args, **r_kw)
    half = dict(r_kw, n_rounds=2)
    mid = ph.resolve_rounds_dual(*r_args, state=ph.zero_state(dual_case[1], True, args[0].device),
                                 **half)
    got = ph.resolve_rounds_dual(*r_args, state=mid, **half)
    torch.cuda.synchronize()
    assert got.shape == (16, dual_case[1])
    assert torch.equal(got[1:], whole)


@pytest.mark.parametrize("n_chunks", [1, 32, 96])
def test_broadcast_table_select_kernel_bit_exact(n_chunks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(n_chunks)
    table = torch.randint(-2**31, 2**31 - 1, (n_chunks, 128), generator=g,
                          dtype=torch.int64).to(torch.int32).cuda()
    idx = torch.randint(-3, n_chunks * 128 + 3, (24, 70001), generator=g).cuda()
    before = LAUNCHES["broadcast_table_select"]
    got = pg.broadcast_table_select(table, idx)
    ref = pg.broadcast_table_select_ref(table, idx)
    torch.cuda.synchronize()
    assert LAUNCHES["broadcast_table_select"] == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n_fields", [3, 4])
def test_pack_by_slot_kernel_bit_exact(n_fields):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(n_fields)
    s, n, k = 24, 50001, 16
    cand = (torch.rand(s, n, generator=g) < torch.linspace(0.0, 0.9, n)).cuda()
    fields = [torch.randn(s, n, generator=g).cuda() for _ in range(n_fields)]
    fields[0][torch.rand(s, n, generator=g).cuda() < 0.1] = -0.0
    before = LAUNCHES["pack_by_slot"]
    got = pg.pack_by_slot(cand, fields, k)
    ref = pg.pack_by_slot_ref(cand, fields, k)
    torch.cuda.synchronize()
    assert LAUNCHES["pack_by_slot"] == before + 1
    assert (ref[1] == k).any() and torch.equal(got[1], ref[1])
    for a, b in zip(got[0], ref[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
