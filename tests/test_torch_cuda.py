"""The CUDA kernels (K1, R1, K4, R1's dual mode, K6, K2, K3, R1's
state-in form, K5 and K7) against their plain PyTorch versions, and the
unfused resolve rounds (K5 + K7) against R1, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device. On a
machine with an NVIDIA GPU (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: bit-exact. Kernel and plain version run the same f32
operation chain (the kernels build with --fmad=false, divides are IEEE)
on the same device.
"""

import dataclasses

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


def _k1_inputs(dev):
    """Incoherent random rays in BoxScene at 96x160 lanes, plain tiles."""
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


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _k1_inputs(torch.device("cuda", 0))


# The cases of K1 / K4 against their plain versions, for the kernels'
# early exit and row-wise slot writes: the fixture's incoherent random
# rays at s_max 24; s_max 8 (K = 8) and 40 (K = 16); N not a multiple of
# any block size; every lane dead; and many lanes past K candidates
# (every lane a back ray / search lane, 0.1 steps, 40 steps: on the plain
# versions 54% of K1's lanes, 33% / 9% / 28% of K4's with insideObject
# 0 / 1 / 2, against 0-8% for the random case), so the full-pack exit
# runs. K1 adds "block 512": its table padded to 1080p's 4,096 words
# (the padding is never indexed), so the budget picks the 512-thread
# block of 112 KB that the 1080p main path launches, above the 48 KB
# that needs cudaFuncSetAttribute. K4 stages 32 KB in 128-thread blocks
# at every size.
PACK_CASES = ("random", "s_max 8", "s_max 40", "ragged", "dead", "full")


def pack_case(args, kw, tiles, case: str, flag: int):
    """One PACK_CASES case of K1's or K4's inputs. ``flag`` is the index
    of the lane mask that makes every processed step deep enough a
    candidate (K1: is_back, K4: search); the lane arguments precede it."""
    args, kw = list(args), dict(kw)
    n = args[0].shape[0]
    if case.startswith("s_max"):
        kw.update(fs.march_kwargs(PTConfig(), tiles, int(case.split()[1])))
    elif case == "ragged":
        args[:flag + 1] = [a[:n - 77] for a in args[:flag + 1]]
    elif case == "dead":
        args[4] = torch.zeros_like(args[4])
    elif case == "full":
        args[flag] = torch.ones_like(args[flag])
        args[3] = torch.full_like(args[3], 0.1)
        cfg = dataclasses.replace(PTConfig(), small_step_size=0.1, medium_step_size=0.1)
        kw.update(fs.march_kwargs(cfg, tiles, 40))
    elif case == "block 512":
        table = args[flag + 1]  # (chunks, 128) words
        args[flag + 1] = torch.cat([table, table.new_zeros(32 - table.shape[0], 128)])
        assert fs.pack_budget(4096, kw["k"], 3) == (512, 114688)
    return args, kw


def check_pack_case(ref, case: str, k: int, with_candidates: float):
    """The case exercises what it is for (on the plain version's outputs):
    at least ``with_candidates`` of the lanes hold a candidate, unless
    every lane is dead."""
    count = ref[-1]
    if case == "dead":
        assert not count.any() and not any(r.any() for r in ref[:-1])
    elif case == "full":
        assert (count == k).float().mean() > 0.05
    else:
        assert (count > 0).float().mean() > with_candidates


@pytest.mark.parametrize("pcase", PACK_CASES + ("block 512",))
def test_schedule_pack_kernel_bit_exact(case, pcase):
    tiles, args, kw = case
    args, kw = pack_case(args, kw, tiles, pcase, 5)
    before = LAUNCHES["schedule_pack"]
    got = fs.schedule_pack(*args, **kw)
    ref = fs.schedule_pack_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_pack"] == before + 1
    check_pack_case(ref, pcase, kw["k"], 0.2 if pcase in ("random", "block 512") else 0.1)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)


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


def _dual_inputs(dev):
    """Random rays in the glass box at 256^2 lanes, with the refraction +
    backface (3-combo) tiles."""
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


@pytest.fixture(scope="module")
def dual_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _dual_inputs(torch.device("cuda", 0))


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


@pytest.mark.parametrize("pcase", PACK_CASES)
@pytest.mark.parametrize("inside", [0, 1, 2])
def test_schedule_pack_dual_kernel_bit_exact(dual_case, inside, pcase):
    args, kw, _, _ = _dual_args(dual_case, inside)
    args, kw = pack_case(args, kw, dual_case[5], pcase, 6)
    before = LAUNCHES["schedule_pack_dual"]
    got = fs.schedule_pack_dual(*args, **kw)
    ref = fs.schedule_pack_dual_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_pack_dual"] == before + 1
    check_pack_case(ref, pcase, kw["k"], 0.1)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)


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


@pytest.mark.parametrize("n_fields", [3, 4])
def test_extract_chain_kernel_bit_exact(n_fields):
    """K5 at the window edges: ptr from -2 to K + 2, slot_hi below, at
    and above K; -0.0 comes back +0.0 from both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(20 + n_fields)
    k, n, chain = 16, 70001, 4
    fields = [torch.randn(k, n, generator=g) for _ in range(n_fields)]
    fields[0][torch.rand(k, n, generator=g) < 0.1] = -0.0
    fields = [f.cuda() for f in fields]
    ptr = torch.randint(-2, k + 2, (n,), generator=g, dtype=torch.int32).cuda()
    for slot_hi in (12, 16, 40):
        before = LAUNCHES["extract_chain"]
        got = pg.extract_chain(fields, ptr, chain, slot_hi)
        ref = pg.extract_chain_ref(fields, ptr, chain, slot_hi)
        torch.cuda.synchronize()
        assert LAUNCHES["extract_chain"] == before + 1
        for a, b in zip(got, ref):
            assert a.shape == (chain, n) and torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.extract_chain([fields[0].cpu()] + fields[1:], ptr, chain, 12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_rowwise_select_kernel_bit_exact(dtype):
    """K7 moves 32-bit words bit for bit (NaN-payload f16 pairs too),
    indices masked with & 127, at K = 4 and K = 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(30)
    n = 50001
    words = torch.randint(-2**31, 2**31 - 1, (n, 128), generator=g,
                          dtype=torch.int64).to(torch.int32)
    words[::7, ::5] = 0x7E017C01
    blocks = words.view(dtype).cuda()
    for k in (4, 128):
        idx = torch.randint(0, 256, (n, k), generator=g, dtype=torch.int32).cuda()
        before = LAUNCHES["rowwise_select"]
        got = pg.rowwise_select(blocks, idx)
        ref = pg.rowwise_select_ref(blocks, idx)
        torch.cuda.synchronize()
        assert LAUNCHES["rowwise_select"] == before + 1
        assert got.dtype == dtype and got.shape == (n, k)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.rowwise_select(blocks, idx.cpu())


def test_unfused_rounds_equal_r1_kernel(case, dual_case):
    """The unfused rounds (K5 + row gather + K7) against R1's kernel,
    plain and dual (insideObject 2), every row bit for bit."""
    tiles, args, kw = case
    packs = fs.schedule_pack_ref(*args, **kw)
    r_args = (*packs, args[0], args[1], args[5], tiles.pair_table, args[7])
    r_kw = dict(gh=H, gw=W, pairs_x=tiles.pairs_x, n_rounds=4, chain=4, s_max=24)
    before = LAUNCHES["extract_chain"], LAUNCHES["rowwise_select"]
    got = ph.resolve_rounds_unfused(*r_args, **r_kw)
    ref = ph.resolve_rounds(*r_args, **r_kw)
    d_args, d_kw, back, d_r_kw = _dual_args(dual_case, 2)
    dpacks = fs.schedule_pack_dual_ref(*d_args, **d_kw)
    dr_args = (*dpacks, d_args[0], d_args[1], back, d_args[5], d_args[6],
               dual_case[5].tile_table, d_args[9])
    dgot = ph.resolve_rounds_dual_unfused(*dr_args, **d_r_kw)
    dref = ph.resolve_rounds_dual(*dr_args, **d_r_kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["extract_chain"], LAUNCHES["rowwise_select"]) == (before[0] + 8,
                                                                       before[1] + 8)
    assert got[0].mean() > 0.1 and dgot[0].mean() > 0.02
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(dgot.view(torch.int32), dref.view(torch.int32))
