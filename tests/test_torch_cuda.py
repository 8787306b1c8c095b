"""The CUDA kernels (K1, R1, K4, R1's dual mode, K6, K2, K3, R1's
state-in form, K5, K7, P1 (the parity march), A1 (À-Trous), T1
(temporal reprojection), S1 (the RNG's hashed, blue-noise and
Sobol-Owen draws) and B1 (a bounce's BRDF)) against their plain PyTorch versions, the unfused resolve rounds (K5 +
K7) against R1, and probe sampling against the CPU, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device. On a
machine with an NVIDIA GPU (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: bit-exact. Kernel and plain version run the same f32
operation chain (the kernels build with --fmad=false, divides are IEEE)
on the same device. Probe sampling on the card against the CPU: 1 ulp
(torch's elementwise kernels on two devices).
"""

import dataclasses
import functools

import pytest
import torch

from unitysspathtracingurp_tpu_torch.config import PTConfig, PTSettings, ThicknessMode
from unitysspathtracingurp_tpu_torch.kernels.build import LAUNCHES
from unitysspathtracingurp_tpu_torch.models import fixtures, scene
from unitysspathtracingurp_tpu_torch.camera import linear_eye_depth, pixel_uv, world_from_uv_depth
from unitysspathtracingurp_tpu_torch.ops import fused_schedule as fs
from unitysspathtracingurp_tpu_torch.ops import pallas_gather as pg
from unitysspathtracingurp_tpu_torch.ops import pathtrace as pt
from unitysspathtracingurp_tpu_torch.ops import pathtrace_hiz as ph
from unitysspathtracingurp_tpu_torch.ops.depth_tiles import build_depth_tiles, build_home_strips
from unitysspathtracingurp_tpu_torch.ops.rng import (
    BLUE_NOISE, HASHED, SOBOL_OWEN, advance_frame_index,
)

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
# at every size. "dither": a random per-lane step dither in [-0.1, 0.1],
# as step dithering gives (intensity 1).
PACK_CASES = ("random", "s_max 8", "s_max 40", "ragged", "dead", "full", "dither")


def random_dither(n, dev, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g) * 0.2 - 0.1).to(dev)


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
    elif case == "dither":
        args[2] = random_dither(n, args[2].device)
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



def _window_leaves(r_args, r_kw, dual=False):
    """Share of the lanes with two or more candidates whose slot-1 link
    lies outside slot 0's window (pair != pair0): the links that end a
    round early."""
    pk = r_args[:4] if dual else r_args[:3]
    pos, d, scalars = r_args[5 if dual else 4], r_args[6 if dual else 5], r_args[-1]
    m, zz, zw = [scalars[i] for i in range(16)], scalars[16], scalars[17]
    pairs = [ph._link(m, zz, zw, pos, d, *[f[slot] for f in pk], gh=r_kw["gh"], gw=r_kw["gw"],
                      pairs_x=r_kw.get("pairs_x", 0), tiles_x=r_kw.get("tiles_x", 0),
                      dual=dual)["pair"] for slot in (0, 1)]
    two = r_args[4 if dual else 3] >= 2
    return float((pairs[0] != pairs[1])[two].float().mean())


def check_resolve_branches(fn, ref_fn, r_args, r_kw, k, dual, case):
    """R1 (or R1-dual) against its plain version, bit for bit, from the
    zero state and from the state one round in (lanes at mixed ptr), on
    inputs that reach the kernel's branches: the search budget, links
    that leave link 0's window, and (``case`` "full") lanes that run to
    ptr = n_cand = K."""
    n = r_args[0].shape[1]
    got, ref = fn(*r_args, **r_kw), ref_fn(*r_args, **r_kw)
    zero = ph.zero_state(n, dual, r_args[0].device)
    mid = ref_fn(*r_args, state=zero, **dict(r_kw, n_rounds=1))
    got_mid = fn(*r_args, state=mid, **r_kw)
    ref_mid = ref_fn(*r_args, state=mid, **r_kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got_mid.view(torch.int32), ref_mid.view(torch.int32))
    n_cand = r_args[4 if dual else 3]
    assert mid[0].unique().numel() >= 3  # mixed ptr
    hit, diff, th = ref[0] > 0.5, ref[2], ref[3]
    budget = hit & (ref[14] > 0.5) if dual else hit & (diff < -th)
    assert budget.any()  # hits only the search budget allows
    assert _window_leaves(r_args, r_kw, dual) > 0.05
    if case == "full":
        assert ((ref_mid[0] == k) & (n_cand == k) & (ref_mid[1] < 0.5)).any()


@pytest.mark.parametrize("rounds", [4, 10])
@pytest.mark.parametrize("pcase", ["random", "full"])
def test_resolve_rounds_branches_bit_exact(case, pcase, rounds):
    tiles, args, kw = case
    args, kw = pack_case(args, kw, tiles, pcase, 5)
    packs = fs.schedule_pack_ref(*args, **kw)
    r_args = (*packs, args[0], args[1], args[5], tiles.pair_table, args[7])
    r_kw = dict(gh=H, gw=W, pairs_x=tiles.pairs_x, n_rounds=rounds, chain=4, s_max=kw["s_max"])
    check_resolve_branches(ph.resolve_rounds, ph.resolve_rounds_ref, r_args, r_kw, kw["k"],
                           False, pcase)


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



@pytest.mark.parametrize("pcase", ["random", "full"])
@pytest.mark.parametrize("inside", [0, 1, 2])
def test_resolve_rounds_dual_branches_bit_exact(dual_case, inside, pcase):
    args, kw, back, r_kw = _dual_args(dual_case, inside)
    args, kw = pack_case(args, kw, dual_case[5], pcase, 6)
    packs = fs.schedule_pack_dual_ref(*args, **kw)
    r_args = (*packs, args[0], args[1], back, args[5], args[6], dual_case[5].tile_table, args[9])
    r_kw = dict(r_kw, n_rounds=10 if pcase == "full" else 4, s_max=kw["s_max"])
    check_resolve_branches(ph.resolve_rounds_dual, ph.resolve_rounds_dual_ref, r_args, r_kw,
                           kw["k"], True, pcase)


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


def _home_inputs(h, w, dev, full=False):
    """BoxScene bounce-0 reflection rays on the screen-ordered h x w grid
    (tilted as tests/test_fused_schedule.py:36-61), for K6; ``full``:
    every lane a back ray, 0.1 steps, 40 steps, so most packs fill
    after a routed prefix."""
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
    back = (d * -view.reshape(n, 3)).sum(-1) > 0.0
    cfg, s_max = PTConfig(), 24
    if full:
        back, large = torch.ones_like(back), torch.full_like(large, 0.1)
        cfg = dataclasses.replace(cfg, small_step_size=0.1, medium_step_size=0.1)
        s_max = 40
    args = ((pos + nrm * 1e-4).reshape(n, 3), d, torch.zeros(n, device=dev), large,
            (gb.depth != 0.0).reshape(n), back, tiles.mini_table, build_home_strips(tiles, h, w),
            fs.schedule_scalars(cam))
    kw = dict(fs.march_kwargs(cfg, tiles, s_max), home_shape=(h, w))
    r_kw = dict(gh=h, gw=w, pairs_x=tiles.pairs_x, n_rounds=4, chain=4, s_max=s_max)
    return tiles, args, kw, r_kw


@pytest.fixture(scope="module")
def home_case():
    """The 256x256 K6 inputs of ``_home_inputs``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _home_inputs(256, 256, torch.device("cuda", 0))


# K6's cases: (h, w, k, full). 256x256 at K = 16 is the frame of
# ``home_case``; one 8x128 lane block clamps its strip on every side;
# 136x384 has 17 x 3 lane blocks (its rows are not a multiple of 16, so
# its minitile rows end mid-tile); K = 2 holds fewer slots than the 4
# home slots; "full" fills most packs after a routed prefix.
HOME_CASES = [(256, 256, 16, False), (8, 128, 16, False), (8, 128, 2, False),
              (136, 384, 16, False), (136, 384, 2, False), (256, 256, 2, True),
              (136, 384, 16, True)]


@pytest.mark.parametrize("hcase", HOME_CASES, ids=lambda c: f"{c[0]}x{c[1]}-k{c[2]}"
                         + ("-full" if c[3] else ""))
def test_schedule_pack_home_kernel_bit_exact(hcase):
    """K6 against its plain version on all 5 outputs, then R1 from its
    state against R1's plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w, k, full = hcase
    tiles, args, kw, r_kw = _home_inputs(h, w, torch.device("cuda", 0), full)
    kw["k"] = k
    before = LAUNCHES["schedule_pack_home"]
    got = fs.schedule_pack_home(*args, **kw)
    ref = fs.schedule_pack_home_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_pack_home"] == before + 1
    home = ref[4]
    routed = (home[0] > 0.5) | (home[10] >= 0.0)
    assert routed.float().mean() > 0.02 and (ref[3] > 0).float().mean() > 0.02
    if full:  # packs that filled after a routed prefix
        assert (routed & (ref[3] == k)).float().mean() > 0.05
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)
    state = torch.cat([torch.zeros_like(home[:1]), home])
    r_args = (*ref[:4], args[0], args[1], args[5], tiles.pair_table, args[8])
    res = ph.resolve_rounds(*r_args, state=state, **r_kw)
    res_ref = ph.resolve_rounds_ref(*r_args, state=state, **r_kw)
    torch.cuda.synchronize()
    assert torch.equal(res, res_ref)


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


@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("s,n", [(7, 50001), (24, 50000), (24, 50001), (64, 50001)])
@pytest.mark.parametrize("n_fields", [3, 4])
def test_pack_by_slot_kernel_bit_exact(n_fields, s, n, k):
    """K3 at S = 7 (not a multiple of the 4 rows loaded together), 24 and
    64, N a multiple of 4 (16-byte row stores) and not, K = 4 and 16:
    lanes 0-99 hold no flag and lanes 100-199 every flag; -0.0 fields
    pack as +0.0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(n_fields * 1000 + s + k)
    cand = torch.rand(s, n, generator=g) < torch.linspace(0.0, 0.9, n)
    cand[:, :100], cand[:, 100:200] = False, True
    cand = cand.cuda()
    fields = [torch.randn(s, n, generator=g).cuda() for _ in range(n_fields)]
    for f in fields:
        f[torch.rand(s, n, generator=g).cuda() < 0.1] = -0.0
    before = LAUNCHES["pack_by_slot"]
    got = pg.pack_by_slot(cand, fields, k)
    ref = pg.pack_by_slot_ref(cand, fields, k)
    torch.cuda.synchronize()
    assert LAUNCHES["pack_by_slot"] == before + 1
    assert (ref[1][100:200] == min(s, k)).all() and (ref[1][:100] == 0).all()
    assert torch.equal(got[1], ref[1])
    for a, b in zip(got[0], ref[0]):
        assert a.shape == (k, n) and torch.equal(a.view(torch.int32), b.view(torch.int32))


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


def test_schedule_pack_home_kernel_dither_bit_exact(home_case):
    """K6 with a random per-lane step dither, then R1 from its state."""
    tiles, args, kw, r_kw = home_case
    args = list(args)
    args[2] = random_dither(args[0].shape[0], args[0].device)
    got = fs.schedule_pack_home(*args, **kw)
    ref = fs.schedule_pack_home_ref(*args, **kw)
    plain = fs.schedule_pack_home_ref(*home_case[1], **kw)
    torch.cuda.synchronize()
    assert not torch.equal(ref[0], plain[0])  # the dither moves the candidates
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    state = torch.cat([torch.zeros_like(ref[4][:1]), ref[4]])
    r_args = (*ref[:4], args[0], args[1], args[5], tiles.pair_table, args[8])
    assert torch.equal(ph.resolve_rounds(*r_args, state=state, **r_kw),
                       ph.resolve_rounds_ref(*r_args, state=state, **r_kw))


# P1, the parity march: random rays in the glass box (every layout has
# its depth images there) against ray_march_ref, in each layout with
# insideObject 0, 1 and 2 and a random per-lane dither; and in the plain
# layout the cases of the loop's exits: s_max 16 and 40, N not a
# multiple of the block, every lane dead, the dither alone, and a quarter
# of the lanes alive (most blocks move their alive lanes together).
P1_LAYOUTS = {
    "plain": {},
    "refraction": dict(support_refraction=True),
    "backface": dict(accurate_thickness=ThicknessMode.DEPTH_ONLY),
    "refraction + backface": dict(support_refraction=True,
                                  accurate_thickness=ThicknessMode.DEPTH_NORMALS),
}
P1_CASES = ("random", "s_max 16", "s_max 40", "ragged", "dead", "dither", "sparse")


@pytest.fixture(scope="module")
def march_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    h, w = 96, 160
    cam = fixtures.box_scene_camera(h, w, device=dev)
    gb = fixtures.rasterize_gbuffers(scene.build_box_scene(with_glass=True, with_mirror=False),
                                     cam, h, w, device=dev, with_backface=True)
    g = torch.Generator().manual_seed(13)
    n = h * w
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    view = torch.randn(n, 3, generator=g)
    view = view / view.norm(dim=-1, keepdim=True)
    origin = torch.rand(n, 3, generator=g) * torch.tensor([5.0, 3.5, 5.0]) - torch.tensor(
        [2.5, 0.0, 2.5])
    lanes = dict(pos=origin, dir=d, view=view, alive=torch.rand(n, generator=g) < 0.9,
                 scene_dist=torch.rand(n, generator=g) * 20.0 + 1.0)
    return gb, cam, {k: v.reshape(h, w, -1).squeeze(-1).to(dev) for k, v in lanes.items()}


def p1_args(march_case, layout, inside, pcase):
    """(cfg, settings, variants, gb, cam, lanes...) of one P1 call."""
    gb, cam, x = march_case
    s = PTSettings(maximum_steps=int(pcase.split()[1]) if pcase.startswith("s_max") else 24,
                   **P1_LAYOUTS[layout])
    lanes = [x["pos"], x["dir"], torch.full_like(x["scene_dist"], float(inside)),
             torch.zeros_like(x["scene_dist"]), x["view"], x["scene_dist"], x["alive"]]
    if pcase == "ragged":
        lanes = [a.reshape((-1,) + a.shape[2:])[:-77] for a in lanes]  # flat lanes
    if pcase == "dead":
        lanes[6] = torch.zeros_like(lanes[6])
    if pcase == "sparse":
        g = torch.Generator().manual_seed(17)
        lanes[6] = lanes[6] & (torch.rand(lanes[6].shape, generator=g) < 0.25).to(lanes[6].device)
    if pcase in ("dither", "layout"):
        lanes[3] = random_dither(lanes[3].numel(), lanes[3].device).reshape(lanes[3].shape)
    return (PTConfig(), s, s.variants(), gb, cam, *lanes)


def check_p1(args, hits: float):
    before = LAUNCHES["ray_march"]
    got = pt.ray_march(*args)
    ref = pt.ray_march_ref(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["ray_march"] == before + 1
    assert ref.hit.float().mean() >= hits
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
        else:
            assert torch.equal(a, b)
    return ref


@pytest.mark.parametrize("pcase", P1_CASES)
def test_ray_march_kernel_bit_exact(march_case, pcase):
    args = p1_args(march_case, "plain", 0, pcase)
    check_p1(args, {"dead": 0.0, "sparse": 0.05}.get(pcase, 0.2))


@pytest.mark.parametrize("inside", [0, 1, 2])
@pytest.mark.parametrize("layout", list(P1_LAYOUTS))
def test_ray_march_layouts_bit_exact(march_case, layout, inside):
    ref = check_p1(p1_args(march_case, layout, inside, "layout"), 0.05)
    if "backface" in layout and inside == 0:
        assert ref.is_back_hit.any()


# P1's blocks move their alive lanes to their first threads where that
# frees a warp: the cases of that control flow, each bit for bit against
# ray_march_ref. Lanes are the glass box's random rays, flat and indexed
# (an index may repeat), in the plain layout.
def p1_lanes(march_case, idx, alive=None, s_max=24):
    gb, cam, x = march_case
    s = PTSettings(maximum_steps=s_max)
    flat = {k: v.reshape((-1,) + v.shape[2:])[idx] for k, v in x.items()}
    return (PTConfig(), s, s.variants(), gb, cam, flat["pos"], flat["dir"],
            torch.zeros_like(flat["scene_dist"]), random_dither(idx.numel(), idx.device),
            flat["view"], flat["scene_dist"], flat["alive"] if alive is None else alive)


def p1_span() -> int:
    from unitysspathtracingurp_tpu_torch.kernels.build import load_library

    return load_library().sspt_ray_march_span()


def long_lanes(march_case, s_max=40, least=30):
    """Indices of the fixture's lanes that march at least ``least`` of
    ``s_max`` steps when alive."""
    _, _, x = march_case
    n = x["alive"].numel()
    idx = torch.arange(n, device=x["alive"].device)
    steps = []
    pt.ray_march_ref(*p1_lanes(march_case, idx, torch.ones_like(x["alive"].reshape(n)), s_max),
                     steps_out=steps)
    return idx[steps[0] >= least]


@pytest.mark.parametrize("n", [1, 31])
def test_ray_march_few_lanes_bit_exact(march_case, n):
    check_p1(p1_lanes(march_case, torch.arange(n, device=march_case[2]["pos"].device)), 0.0)


def test_ray_march_no_lanes(march_case):
    args = p1_lanes(march_case, torch.arange(0, device=march_case[2]["pos"].device))
    got = pt.ray_march(*args)
    torch.cuda.synchronize()
    assert got.hit.shape == (0,) and got.position.shape == (0, 3) and got.uv.shape == (0, 2)


@pytest.mark.parametrize("times", ["one more", "3.5 x"])
def test_ray_march_past_a_span_bit_exact(march_case, times):
    span = p1_span()
    assert span > 0 and span % 128 == 0
    n = span + 1 if times == "one more" else 3 * span + span // 2 + 7
    x = march_case[2]["pos"]
    check_p1(p1_lanes(march_case, torch.arange(n, device=x.device) % x[..., 0].numel()), 0.2)


def test_ray_march_lone_long_lane_bit_exact(march_case):
    """One alive lane of 40 steps in a warp of dead lanes; then long and
    dead lanes alternating."""
    long = long_lanes(march_case)
    assert long.numel() >= 64
    idx = long[:1].repeat(32)
    alive = torch.zeros(32, dtype=torch.bool, device=idx.device)
    alive[17] = True
    check_p1(p1_lanes(march_case, idx, alive, s_max=40), 0.0)
    idx = long.repeat_interleave(2)
    alive = (torch.arange(idx.numel(), device=idx.device) % 2) == 0
    check_p1(p1_lanes(march_case, idx, alive, s_max=40), 0.0)


def test_ray_march_back_to_back_calls_bit_exact(march_case):
    dev = march_case[2]["pos"].device
    n = march_case[2]["pos"][..., 0].numel()
    a = p1_lanes(march_case, torch.arange(n, device=dev))
    b = p1_lanes(march_case, torch.arange(n // 3, device=dev).flip(0))
    for args in (a, a, b, a):
        check_p1(args, 0.2)


def test_ray_march_two_streams_bit_exact(march_case):
    dev = march_case[2]["pos"].device
    n = march_case[2]["pos"][..., 0].numel()
    calls = [p1_lanes(march_case, torch.arange(n, device=dev)),
             p1_lanes(march_case, torch.arange(n - 1, -1, -1, device=dev)[: n // 2], s_max=40)]
    refs = [pt.ray_march_ref(*c) for c in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for s, c in zip(streams, calls):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            got.append(pt.ray_march(*c))
    torch.cuda.synchronize()
    for g, r in zip(got, refs):
        for a, b in zip(g, r):
            assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)) \
                if a.dtype == torch.float32 else torch.equal(a, b)


# ---------------------------------------------------------------- A1 and T1

RT_SIZES = ((1, 1), (37, 53), (256, 256))


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _rt_case(h, w, glass=False, hist_dtype=torch.float32, prev_jitter=0.05, seed=3):
    """A real-time frame's inputs on the card: the classroom (or the glass
    box) G-buffer with motion to a moved camera, a noisy color, counts
    0 / 1 / 3 / 5 / 8 / 9 and a history from the moved camera."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from unitysspathtracingurp_tpu_torch.ops.temporal import TemporalState

    dev = torch.device("cuda", 0)
    sc = (scene.build_box_scene(with_glass=True, with_mirror=False) if glass
          else scene.build_classroom_scene())
    make = fixtures.box_scene_camera if glass else fixtures.classroom_camera
    cam, prev = make(h, w, device=dev), make(h, w, jitter=prev_jitter, device=dev)
    gb = fixtures.rasterize_gbuffers(sc, cam, h, w, device=dev, prev_cam=prev,
                                     with_backface=glass)
    pgb = fixtures.rasterize_gbuffers(sc, prev, h, w, device=dev)
    g = torch.Generator().manual_seed(seed)
    color = (torch.rand(h, w, 3, generator=g) * 2.0).to(dev)
    counts = torch.tensor([0.0, 1.0, 3.0, 5.0, 8.0, 9.0])[
        torch.randint(0, 6, (h, w), generator=g)].to(dev)
    state = TemporalState(
        history_color=(torch.rand(h, w, 3, generator=g) * 2.0).to(dev, hist_dtype),
        history_sample=counts, history_depth=pgb.layer1_depth(),
        history_emission=pgb.emission.to(hist_dtype), prev_inv_view_proj=prev.inv_view_proj,
        prev_view_proj=prev.view_proj, prev_camera_position=prev.position)
    return gb, cam, color, state


def check_atrous(gb, color, counts, refr=False, row_offset=0):
    from unitysspathtracingurp_tpu_torch.ops import atrous

    before = LAUNCHES["atrous"]
    got = atrous.atrous_filter(color, gb, gb.emission, counts, PTConfig(), refr, row_offset)
    ref = atrous.atrous_filter_ref(color, gb, gb.emission, counts, PTConfig(), refr, row_offset)
    torch.cuda.synchronize()
    assert LAUNCHES["atrous"] == before + 1
    assert torch.equal(_bits(got), _bits(ref))
    return got


@pytest.mark.parametrize("acase", ["plain", "row offset 17", "refraction", "all sky"])
@pytest.mark.parametrize("size", RT_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_atrous_kernel_bit_exact(size, acase):
    gb, _, color, state = _rt_case(*size, glass=acase == "refraction")
    if acase == "all sky":
        gb = dataclasses.replace(gb, depth=torch.zeros_like(gb.depth))
    check_atrous(gb, color, state.history_sample, refr=acase == "refraction",
                 row_offset=17 if acase == "row offset 17" else 0)


# A1 at its edges: images smaller than the taps' 9-px reach, exact
# multiples of its 32x8 block (and of the 32x16, 64x16 and 32x64 blocks of
# the shared-memory designs scripts/atrous_ablation.py measures), one more
# than a multiple in each axis, several blocks down, and refraction and
# row_offset 17 on an odd shape.
ATROUS_EDGE_CASES = (((5, 300), "plain"), ((300, 5), "plain"), ((9, 9), "plain"),
                     ((64, 128), "plain"), ((65, 129), "plain"), ((200, 96), "plain"),
                     ((33, 129), "refraction"), ((33, 129), "row offset 17"))


@pytest.mark.parametrize("size,acase", ATROUS_EDGE_CASES,
                         ids=[f"{h}x{w}-{c}" for (h, w), c in ATROUS_EDGE_CASES])
def test_atrous_edges_bit_exact(size, acase):
    gb, _, color, state = _rt_case(*size, glass=acase == "refraction")
    check_atrous(gb, color, state.history_sample, refr=acase == "refraction",
                 row_offset=17 if acase == "row offset 17" else 0)


def test_atrous_blocks_that_pass_through_beside_ones_that_filter():
    """The left 64 columns at blur 0, a 32x64 block of sky and 8 sky rows
    pass through, whole blocks of every shape the ablation measures beside
    blocks that filter; the rest filters."""
    gb, _, color, state = _rt_case(128, 128)
    counts = state.history_sample.clone()
    counts[:, :64] = 9.0  # 9 / 8 - 1 / 8 = 1: blur 0
    depth = gb.depth.clone()
    depth[64:, 64:96] = 0.0
    depth[8:16, 96:] = 0.0
    gb = dataclasses.replace(gb, depth=depth)
    got = check_atrous(gb, color, counts)
    assert torch.equal(_bits(got[:, :64]), _bits(color[:, :64]))
    assert torch.equal(_bits(got[64:, 64:96]), _bits(color[64:, 64:96]))
    assert torch.equal(_bits(got[8:16, 96:]), _bits(color[8:16, 96:]))
    assert not torch.equal(got[16:, 96:], color[16:, 96:])


def test_atrous_nan_and_inf_in_color_bit_exact():
    """NaN and +-inf in the color, and NaN and -inf in the albedo, reach
    the clamps as centers and as taps."""
    gb, _, color, state = _rt_case(37, 53)
    color = color.clone()
    color[3, 5, 0] = float("nan")
    color[10, 20] = float("inf")
    color[20, 30, 2] = -float("inf")
    color[30, 40] = float("nan")
    color[36, 52, 1] = float("inf")
    albedo = gb.albedo.clone()
    albedo[12, 8, 1] = float("nan")
    albedo[25, 44] = -float("inf")
    check_atrous(dataclasses.replace(gb, albedo=albedo), color, state.history_sample)


def test_atrous_two_streams_bit_exact():
    """A1 on two streams at once with different inputs and row offsets."""
    from unitysspathtracingurp_tpu_torch.ops import atrous

    calls = []
    for seed, row_offset in ((3, 0), (4, 17)):
        gb, _, color, state = _rt_case(256, 256, seed=seed)
        calls.append((color, gb, gb.emission, state.history_sample, PTConfig(), False,
                      row_offset))
    refs = [atrous.atrous_filter_ref(*c) for c in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for s, c in zip(streams, calls):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            got.append(atrous.atrous_filter(*c))
    torch.cuda.synchronize()
    for g, r in zip(got, refs):
        assert torch.equal(_bits(g), _bits(r))


def check_temporal(gb, cam, color, state, refr=False):
    from unitysspathtracingurp_tpu_torch.ops import temporal

    before = LAUNCHES["temporal"]
    args = (color, gb, cam, state, gb.emission, PTConfig(), 0.97, 0.0012, refr)
    got = temporal.temporal_reproject(*args)
    ref = temporal.temporal_reproject_ref(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["temporal"] == before + 1
    assert torch.equal(_bits(got.color), _bits(ref.color))
    assert torch.equal(_bits(got.sample_count), _bits(ref.sample_count))
    return got


TEMPORAL_CASES = ("f32", "bf16", "refraction", "static", "no motion", "off screen", "all sky")


@pytest.mark.parametrize("tcase", TEMPORAL_CASES)
@pytest.mark.parametrize("size", RT_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_temporal_kernel_bit_exact(size, tcase):
    gb, cam, color, state = _rt_case(
        *size, glass=tcase == "refraction",
        hist_dtype=torch.bfloat16 if tcase == "bf16" else torch.float32,
        prev_jitter=0.0 if tcase == "static" else 0.05)
    if tcase == "no motion":
        gb = dataclasses.replace(gb, motion=None)
    if tcase == "off screen":
        gb = dataclasses.replace(gb, motion=gb.motion + torch.tensor([1.5, -2.0], device=color.device))
    if tcase == "all sky":
        gb = dataclasses.replace(gb, depth=torch.zeros_like(gb.depth))
    check_temporal(gb, cam, color, state, refr=tcase == "refraction")


def test_realtime_kernels_back_to_back_bit_exact():
    """A1 three times on its own output, then T1 twice, on one stream."""
    gb, cam, color, state = _rt_case(256, 256)
    for _ in range(3):
        color = check_atrous(gb, color, state.history_sample)
    first = check_temporal(gb, cam, color, state)
    check_temporal(gb, cam, first.color, state)


def test_temporal_two_streams_bit_exact():
    """T1 on two streams at once with different cameras and histories:
    the camera array is per call, so neither sees the other's."""
    from unitysspathtracingurp_tpu_torch.ops import temporal

    calls = []
    for jitter, seed in ((0.05, 3), (-0.2, 4)):
        gb, cam, color, state = _rt_case(256, 256, prev_jitter=jitter, seed=seed)
        calls.append((color, gb, cam, state, gb.emission, PTConfig(), 0.97, 0.0012))
    refs = [temporal.temporal_reproject_ref(*c) for c in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for s, c in zip(streams, calls):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            got.append(temporal.temporal_reproject(*c))
    torch.cuda.synchronize()
    for g, r in zip(got, refs):
        assert torch.equal(_bits(g.color), _bits(r.color))
        assert torch.equal(_bits(g.sample_count), _bits(r.sample_count))


# ---------------------------------------------------------------- S1 (sampler)


@pytest.fixture(scope="module")
def sampler_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from unitysspathtracingurp_tpu_torch.ops.blue_noise import BlueNoiseTables

    return torch.device("cuda", 0), BlueNoiseTables(device=torch.device("cuda", 0))


def _sampler_lanes(dev, lanes: str):
    """Pixel coordinates: a 200x300 grid, a compacted gather of 40% of it
    in a random order ((ch, 128) lanes), one lane, a lane count that is
    no multiple of the 256-thread block, and no lane."""
    from unitysspathtracingurp_tpu_torch.ops.rng import make_rng

    rng = make_rng(200, 300, 0, dev)
    if lanes == "grid":
        return rng.pix_x, rng.pix_y
    if lanes == "compacted":
        g = torch.Generator().manual_seed(11)
        idx = torch.randperm(200 * 300, generator=g)[:24064].to(dev)
        return (rng.pix_x.reshape(-1)[idx].reshape(188, 128),
                rng.pix_y.reshape(-1)[idx].reshape(188, 128))
    start = 200 * 300 - {"one": 1, "ragged": 256 * 7 + 93, "none": 0}[lanes]
    return rng.pix_x.reshape(-1)[start:], rng.pix_y.reshape(-1)[start:]


# Frame indices: the first frame; epoch 0 and epoch 1 of the blue-noise
# rotation; frame index + draw past 2^32 (the hashed z wraps); the
# Renderer's counter after it wraps at FRAME_INDEX_MOD.
SAMPLER_FRAMES = [0, 33 * 77, 33 * 300, 33 * 400, 2**32 - 3, advance_frame_index(63990)]
SAMPLER_MODES = {"hashed": HASHED, "blue_noise": BLUE_NOISE, "sobol_owen": SOBOL_OWEN}


@pytest.mark.parametrize("lanes", ["grid", "compacted", "one", "ragged", "none"])
@pytest.mark.parametrize("frame_index", SAMPLER_FRAMES)
@pytest.mark.parametrize("first,count", [(1, 1), (4, 1), (3, 2), (6, 2), (1, 2)])
@pytest.mark.parametrize("mode", sorted(SAMPLER_MODES))
def test_sampler_kernel_bit_exact(sampler_case, mode, first, count, frame_index, lanes):
    """S1 against its plain version on the same lanes: draw and draw2,
    the counter odd and even ahead of the first draw (a Sobol draw2 is
    one pair from an odd ``first``; an even one straddles two pairs).
    No lane launches nothing."""
    from unitysspathtracingurp_tpu_torch.ops import rng

    dev, tables = sampler_case
    m = SAMPLER_MODES[mode]
    px, py = _sampler_lanes(dev, lanes)
    before = LAUNCHES["sampler"]
    got = rng.sampler_draws(px, py, frame_index, first, count, m, tables)
    assert LAUNCHES["sampler"] == before + (px.numel() > 0)
    want = rng.sampler_draws_ref(px, py, frame_index, first, count, m, tables)
    torch.cuda.synchronize()
    assert got.shape == want.shape == px.shape + ((2,) if count == 2 else ())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(((got >= 0.0) & (got < 1.0)).all())


@pytest.mark.parametrize("frame_index", [33 * 400, 0, 2**32 - 3, advance_frame_index(63990)])
@pytest.mark.parametrize("mode", sorted(SAMPLER_MODES))
def test_sampler_draw_stream_through_the_rng(sampler_case, mode, frame_index):
    """draw / draw2 through the RNG in each mode on the card equal the
    same stream on the CPU (the plain version), 12 draws with the counter
    odd and even before each draw2."""
    from unitysspathtracingurp_tpu_torch.ops import rng

    dev, tables = sampler_case
    if mode == "blue_noise":
        kw, cpu_kw = {"tables": tables}, {"tables": type(tables)(device="cpu")}
    else:
        kw = cpu_kw = {"sobol_owen": True} if mode == "sobol_owen" else {}
    a = rng.make_rng(37, 53, frame_index, dev, **kw)
    b = rng.make_rng(37, 53, frame_index, "cpu", **cpu_kw)
    assert a.mode == b.mode == SAMPLER_MODES[mode]
    for step in (1, 2, 1, 1, 2, 2, 1, 2):
        fn = rng.draw if step == 1 else rng.draw2
        (va, a), (vb, b) = fn(a), fn(b)
        assert torch.equal(va.cpu().view(torch.int32), vb.view(torch.int32))
        assert a.seed == b.seed


# Per real-time scene: the scene, its camera, whether it rasterizes back
# faces, its settings beyond the shared ones, and the kernel launches of
# one frame (adaptive spp: 4 samples x bounces marches, 4 x (2 + 3 x
# bounces) draws, 4 x (1 + bounces) BRDF evaluations).
REALTIME_SCENES = {
    "classroom": dict(
        scene=scene.build_classroom_scene, camera=fixtures.classroom_camera,
        backface=False, settings=dict(maximum_depth=2),
        launches={"schedule_pack": 8, "resolve_rounds": 8, "atrous": 3, "temporal": 1,
                  "sampler": 32, "brdf": 12}),
    "glass": dict(
        scene=functools.partial(scene.build_box_scene, with_glass=True, with_mirror=True),
        camera=fixtures.box_scene_camera, backface=True,
        settings=dict(maximum_depth=4, support_refraction=True,
                      accurate_thickness=ThicknessMode.DEPTH_NORMALS),
        launches={"schedule_pack_dual": 16, "resolve_rounds_dual": 16, "atrous": 3,
                  "temporal": 1, "sampler": 56, "brdf": 20}),
}


@pytest.mark.parametrize("scene_name", sorted(REALTIME_SCENES))
def test_hashed_realtime_frames_through_s1_bit_exact(scene_name):
    """Three frames of a 64x96 SPATIAL_TEMPORAL renderer (spp 1 adaptive
    to 4, hashed noise, the camera alternating between two poses) draw
    through S1 and evaluate the BRDF through B1, and equal bit for bit
    (image and history counts) the same frames with the plain versions
    drawing and evaluating. The classroom runs 2 bounces
    on the plain hiz path (K1 / R1); the glass box, with its glass and
    mirror spheres, 4 bounces with refraction and DepthNormals back faces
    on the dual-layer path (K4 / R1-dual, A1 and T1 with refraction).
    Each frame's launches of every kernel are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from unitysspathtracingurp_tpu_torch.config import DenoiserType, NoiseMethod
    from unitysspathtracingurp_tpu_torch.models.renderer import Renderer
    from unitysspathtracingurp_tpu_torch.ops import rng
    from unitysspathtracingurp_tpu_torch.ops.envprobe import ProbeSet, constant_probe

    case = REALTIME_SCENES[scene_name]
    dev, h, w = torch.device("cuda", 0), 64, 96
    cams = [case["camera"](h, w, jitter=j, device=dev) for j in (0.0, 0.05)]
    sc = case["scene"]()
    frames = [(fixtures.rasterize_gbuffers(sc, cams[i], h, w, device=dev,
                                           with_backface=case["backface"],
                                           prev_cam=cams[1 - i]), cams[i]) for i in (0, 1)]
    s = PTSettings(samples_per_pixel=1, maximum_steps=24, dithering=False,
                   denoiser=DenoiserType.SPATIAL_TEMPORAL,
                   noise_method=NoiseMethod.HASHED_RANDOM, **case["settings"])
    fast, plain = (Renderer(s, h, w, probes=ProbeSet(probe0=constant_probe(
        [0.05, 0.06, 0.08], device=dev)), kernel="hiz", device=dev) for _ in range(2))
    kernel, brdf_kernel = rng.sampler_draws, pt.brdf_lanes
    for i in range(3):
        gb, cam = frames[i % 2]
        before = LAUNCHES.copy()
        a = fast.render_frame(gb, cam)
        torch.cuda.synchronize()
        assert dict(LAUNCHES - before) == case["launches"]
        rng.sampler_draws, pt.brdf_lanes = rng.sampler_draws_ref, pt.brdf_lanes_ref
        try:
            b = plain.render_frame(gb, cam)
        finally:
            rng.sampler_draws, pt.brdf_lanes = kernel, brdf_kernel
        torch.cuda.synchronize()
        for name in ("sampler", "brdf"):
            assert LAUNCHES[name] == before[name] + case["launches"][name]
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(fast.temporal_state.history_sample),
                           _bits(plain.temporal_state.history_sample))


def test_probe_sampling_on_the_card_within_an_ulp(sampler_case):
    """The full probe path (box projection, mips, the blend, damping) on
    the card against the CPU plain path, within 1 ulp."""
    from unitysspathtracingurp_tpu_torch.ops import envprobe

    dev, _ = sampler_case
    probes = fixtures.box_scene_probes(resolution=16, device="cpu")
    probes.is_probe_camera = torch.tensor(1.0)
    g = torch.Generator().manual_seed(3)
    d = torch.randn(20000, 3, generator=g)
    d[:500, 0] = 0.0
    d = d / d.norm(dim=-1, keepdim=True)
    pos = torch.rand(20000, 3, generator=g) * torch.tensor([5.0, 3.6, 5.0]) - torch.tensor(
        [2.5, -0.2, 2.5])
    for mip in (1.0, 0.5):
        want = envprobe.sample_reflection_probes(probes, d, pos, mip_level=mip)
        got = envprobe.sample_reflection_probes(probes.to(dev), d.to(dev), pos.to(dev),
                                                mip_level=mip).cpu()
        ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 1
    mips = envprobe.build_probe_mips(probes.probe0.texture.to(dev))
    for a, b in zip(mips, probes.probe0.mips):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------- B1 (BRDF)

BRDF_LAYOUTS = ("grid", "compacted", "bounce 0", "strided", "flat")


def _brdf_args(layout: str, dev):
    """``brdf_lanes``' inputs after the draws, every case mixed into one
    set of lanes: hits and misses, insideObject 0 / 1 / 2, opaque and
    refractive surfaces (ior 1-2, so eta > 1 and total internal
    reflection on the lanes past the critical angle), smoothness 1 and
    around roughness 0.001, albedo 0 (refract_p 0) and a channel of 1
    (spec_p 0 under refraction), specular below the 0.04 clamp, normals
    facing away, z = +0 / -0 normals, draws of 0, and NaN in a normal, an
    energy and an albedo. Layouts: "grid" (61, 97) contiguous lanes;
    "compacted" (47, 128) lanes gathered in a random order; "bounce 0"
    the ray origin, hit flag and probe radiance lane-constant (zero
    strides); "strided" component planes, a slice of a wider tensor,
    columns of a stacked tensor and every other bool; "flat" one lane
    axis."""
    from unitysspathtracingurp_tpu_torch.gbuffer import SurfaceData

    rows, cols = (47, 128) if layout == "compacted" else (61, 97)
    n = rows * cols
    g = torch.Generator().manual_seed(31)

    def unit(m):
        v = torch.randn(m, 3, generator=g)
        return v / v.norm(dim=-1, keepdim=True)

    def rand(*shape):
        return torch.rand(*shape, generator=g)

    ray_dir = unit(n)
    normal = unit(n)
    away = (normal * -ray_dir).sum(-1) < 0.0
    normal = torch.where((away & (rand(n) < 0.85))[:, None], -normal, normal)
    normal[3] = torch.tensor([1.0, 0.0, 0.0])
    normal[4] = torch.tensor([0.6, 0.8, -0.0])
    normal[5] = torch.tensor([0.0, -0.0, -1.0])
    albedo = rand(n, 3)
    albedo = torch.where((rand(n) < 0.1)[:, None], 0.0, albedo)
    albedo[:, 1] = torch.where(rand(n) < 0.1, 1.0, albedo[:, 1])
    smooth = rand(n)
    near = torch.tensor([1.0, 0.96837723, 0.9683772, 0.9683773, 0.968377])
    pick = rand(n) < 0.1
    smooth = torch.where(pick, near[torch.randint(0, 5, (n,), generator=g)], smooth)
    ior = torch.where(rand(n) < 0.35, -1.0, 1.0 + rand(n))
    inside = torch.randint(0, 3, (n,), generator=g).float()
    energy = rand(n, 3)
    random = rand(n, 2)
    random[6:8] = 0.0
    normal[0, 1] = float("nan")
    energy[1, 2] = float("nan")
    albedo[2, 0] = float("nan")
    hit = rand(n) > 0.2
    hit[:8] = True
    f = dict(
        ray_dir=ray_dir, ray_pos=torch.randn(n, 3, generator=g), energy=energy, hit=hit,
        normal=normal, albedo=albedo, specular=rand(n, 3) * 0.3, smoothness=smooth, ior=ior,
        inside=inside, emission=rand(n, 3) * (rand(n, 1) < 0.1), hit_pos=torch.randn(n, 3, generator=g),
        hit_dist=rand(n) * 6.0, env=rand(n, 3), random=random, roulette=rand(n))
    cos_i = -(f["ray_dir"] * normal).sum(-1)
    tir = hit & (ior != -1.0) & (inside != 1.0) & (1.0 - ior * ior * (1.0 - cos_i * cos_i) < 0.0)
    assert int(tir.sum()) > 50 and bool((hit & (inside == 2.0)).any())
    assert bool(((1.0 - smooth) ** 2 <= 0.001).any()) and bool((~hit).any())
    if layout == "compacted":
        idx = torch.randperm(n, generator=g)
        f = {k: v[idx] for k, v in f.items()}
    lanes = (n,) if layout == "flat" else (rows, cols)
    f = {k: v.reshape(lanes + v.shape[1:]).to(dev) for k, v in f.items()}
    if layout == "bounce 0":
        f["ray_pos"] = f["ray_pos"][0, 0].expand(rows, cols, 3)
        f["hit"] = torch.ones((), dtype=torch.bool, device=dev).expand(rows, cols)
        f["env"] = f["env"][0, 0].expand(rows, cols, 3)
    elif layout == "strided":
        for k in ("normal", "albedo", "specular", "emission", "hit_pos", "random"):
            f[k] = f[k].permute(2, 0, 1).contiguous().permute(1, 2, 0)
        wide = torch.zeros(rows, cols, 5, device=dev)
        wide[..., 1:4] = f["ray_dir"]
        f["ray_dir"] = wide[..., 1:4]
        cols5 = torch.stack([f[k] for k in ("smoothness", "ior", "inside", "hit_dist",
                                            "roulette")], dim=-1)
        for i, k in enumerate(("smoothness", "ior", "inside", "hit_dist", "roulette")):
            f[k] = cols5[..., i]
        twice = torch.zeros(rows, cols * 2, dtype=torch.bool, device=dev)
        twice[:, ::2] = f["hit"]
        f["hit"] = twice[:, ::2]
        assert not any(f[k].is_contiguous() for k in ("normal", "ray_dir", "ior", "hit"))
    surf = SurfaceData(albedo=f["albedo"], specular=f["specular"], normal=f["normal"],
                       emission=f["emission"], smoothness=f["smoothness"], ior=f["ior"],
                       inside_object=f["inside"])
    return (f["ray_dir"], f["ray_pos"], f["energy"], f["hit"], surf, f["hit_pos"],
            f["hit_dist"], f["env"], f["random"], f["roulette"])


@pytest.mark.parametrize("layout", BRDF_LAYOUTS)
@pytest.mark.parametrize("disney", [False, True], ids=["lambert", "disney"])
@pytest.mark.parametrize("refr", [False, True], ids=["opaque", "refraction"])
def test_brdf_kernel_bit_exact(refr, disney, layout):
    """B1 against its plain version on the same lanes, all four outputs
    bit for bit, in each of its four instances and layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _brdf_args(layout, torch.device("cuda", 0))
    before = LAUNCHES["brdf"]
    got = pt.brdf_lanes(refr, disney, *args)
    assert LAUNCHES["brdf"] == before + 1
    want = pt.brdf_lanes_ref(refr, disney, *args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape == args[0].shape
        assert torch.equal(_bits(a), _bits(b))
