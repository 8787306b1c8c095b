"""The hiz march: wavefront schedule + hierarchical depth, plain layout.

The counterpart of ``unitysspathtracingurp_tpu.ops.pathtrace_hiz`` for
the no-refraction / no-backface variant set on plain ``DepthTiles``:

  1-3. ``fused_schedule.schedule_pack`` (kernel K1) builds every lane's
       step schedule, filters steps against the minitile depth
       intervals and packs the first K candidates.
  4.   ``resolve_rounds`` (kernel R1) exact-tests candidates in
       ``n_rounds`` rounds of up to ``hiz_chain`` links against the f16
       pair depth table.
  5.   The finalize (hit interpolation) stays as torch ops.

The quality-gated deviations from the parity march are the JAX
package's (its module docstring lists them); this port adds none.
"""

from __future__ import annotations

from functools import partial

import torch

from ..camera import world_to_ndc
from .depth_tiles import DepthTiles, build_depth_tiles, pair_of, unpack_pair_half
from .fused_schedule import pixel_index, schedule_pack, schedule_scalars
from .pathtrace import REAL_EPS, MarchResult, trace_frame

# Rows of the (11, N) resolve-state table both R1 versions return.
RESOLVE_FIELDS = (
    "hit", "hit_cum", "hit_diff", "hit_th", "hit_hitd", "hit_lcum",
    "hit_lhd", "hit_prev", "hit_ixy", "prev_diff", "prev_sidx",
)


def default_rounds(height: int, width: int) -> int:
    """Resolve-round budget by resolution: 4 at >= 720p, 10 below."""
    return 4 if min(height, width) >= 720 else 10


def resolve_rounds_ref(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir,
                       is_back, pair_table, scalars, *, gh, gw, pairs_x,
                       n_rounds, chain, s_max):
    """Plain PyTorch version of R1: the torch port of ``run_rounds``
    (dense rounds), reading each link's fields at ptr + j and its texel
    as one pair-table word. Returns the (11, N) f32 resolve state."""
    k, n = pk_cum.shape
    dev = pk_cum.device
    m = [scalars[i] for i in range(16)]
    zz, zw = scalars[16], scalars[17]
    words_all = pair_table.reshape(-1)
    n_cand = n_cand.to(torch.int64)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    st = dict(
        hit=torch.zeros(n, dtype=torch.bool, device=dev),
        hit_cum=z, hit_diff=z, hit_th=z, hit_hitd=z, hit_lcum=z, hit_lhd=z,
        hit_prev=torch.zeros(n, dtype=torch.int64, device=dev),
        hit_ixy=torch.zeros(n, dtype=torch.int64, device=dev),
        prev_diff=z,
        prev_sidx=torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    ptr = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(n_rounds):
        chain_on = ~st["hit"] & (ptr < n_cand)
        adv = torch.zeros_like(ptr)
        pair0 = None
        for j in range(chain):
            s = ptr + j
            valid = chain_on & (s < n_cand)
            sc = torch.clamp(s, max=k - 1)[None]
            cd = pk_cum.gather(0, sc)[0]
            scode = pk_scode.gather(0, sc)[0]
            hist = pk_hist.gather(0, sc)[0]
            th = torch.div(scode, 8192.0, rounding_mode="floor") * 0.025
            sbase = torch.remainder(scode, 8192.0)
            s_idx = torch.remainder(sbase, 65.0).to(torch.int64)
            p_idx = torch.div(sbase, 65.0, rounding_mode="floor").to(torch.int64) - 1
            lcum = torch.div(hist, 4096.0, rounding_mode="floor") * 0.025
            lhd = torch.remainder(hist, 4096.0) * 0.025

            px = ray_pos[:, 0] + cd * ray_dir[:, 0]
            py = ray_pos[:, 1] + cd * ray_dir[:, 1]
            pz = ray_pos[:, 2] + cd * ray_dir[:, 2]
            clipx = px * m[0] + py * m[1] + pz * m[2] + m[3]
            clipy = px * m[4] + py * m[5] + pz * m[6] + m[7]
            clipz = px * m[8] + py * m[9] + pz * m[10] + m[11]
            w = px * m[12] + py * m[13] + pz * m[14] + m[15]
            w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
            u = clipx / w * 0.5 + 0.5
            v = clipy / w * 0.5 + 0.5
            hitd = 1.0 / (clipz / w * zz + zw)
            ix = pixel_index(u, gw)
            iy = pixel_index(v, gh)
            pair, texel, high = pair_of(ix, iy, pairs_x)
            if j == 0:
                pair0 = pair
            else:
                valid = valid & (pair == pair0)
            d_raw = unpack_pair_half(words_all[pair * 128 + texel], high)
            scene = 1.0 / (d_raw * zz + zw)
            is_sky = d_raw == 0.0
            d = scene - hitd
            halvings = torch.ceil(torch.log2(
                torch.clamp(-d / torch.clamp(th, min=1e-6), min=1.0)
            ))
            budget_ok = (s_idx + 1).to(torch.float32) + halvings <= float(s_max)
            in_window = (d >= -th) | (is_back & budget_ok)
            hit_now = valid & (d <= 0.0) & in_window & ~is_sky

            for key, val in (("hit_cum", cd), ("hit_diff", d), ("hit_th", th),
                             ("hit_hitd", hitd), ("hit_lcum", lcum),
                             ("hit_lhd", lhd), ("hit_prev", p_idx),
                             ("hit_ixy", iy * gw + ix)):
                st[key] = torch.where(hit_now, val, st[key])
            fail = valid & ~hit_now
            st["prev_diff"] = torch.where(fail, d, st["prev_diff"])
            st["prev_sidx"] = torch.where(fail, s_idx, st["prev_sidx"])
            adv = adv + fail.to(torch.int64)
            st["hit"] = st["hit"] | hit_now
            chain_on = fail
        ptr = ptr + adv
    return torch.stack([st[key].to(torch.float32) for key in RESOLVE_FIELDS])


def resolve_rounds(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                   pair_table, scalars, **params):
    """R1 wrapper. CPU tensors: ``resolve_rounds_ref``. CUDA tensors: the
    kernel, or an exception; there is no fallback."""
    if pk_cum.device.type == "cpu":
        return resolve_rounds_ref(pk_cum, pk_scode, pk_hist, n_cand, ray_pos,
                                  ray_dir, is_back, pair_table, scalars, **params)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    k, n = pk_cum.shape
    ins = [
        pk_cum.contiguous(), pk_scode.contiguous(), pk_hist.contiguous(),
        n_cand.to(torch.int32).contiguous(),
        ray_pos.to(torch.float32).contiguous(), ray_dir.to(torch.float32).contiguous(),
        is_back.to(torch.uint8).contiguous(), pair_table.to(torch.int32).contiguous(),
        scalars.to(torch.float32).contiguous(),
    ]
    require_cuda("resolve_rounds", *ins)
    if any(t.dtype != torch.float32 or t.shape != (k, n) for t in ins[:3]) or (
        ins[3].shape != (n,) or ins[4].shape != (n, 3) or ins[5].shape != (n, 3)
        or ins[6].shape != (n,) or ins[8].numel() != 18
    ):
        raise RuntimeError("resolve_rounds: bad input shapes or dtypes")
    out = torch.empty((len(RESOLVE_FIELDS), n), dtype=torch.float32, device=pk_cum.device)
    p = params
    rc = lib.sspt_resolve_rounds(
        *[t.data_ptr() for t in ins], out.data_ptr(),
        n, k, p["gh"], p["gw"], p["pairs_x"], p["n_rounds"], p["chain"],
        p["s_max"], stream_of(out),
    )
    check(rc, "resolve_rounds")
    LAUNCHES["resolve_rounds"] += 1
    return out


def ray_march_hiz(cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside,
                  dither, view_dir, scene_distance, alive, *, tiles: DepthTiles,
                  n_rounds: int | None = None) -> MarchResult:
    """Wavefront RayMarching (PathTracing.hlsl:7-254) on plain tiles; the
    signature of the JAX ``ray_march_hiz``. Lanes are (lh, lw)."""
    variants.check_supported()
    cfg.check_supported()
    lh, lw = ray_pos.shape[0], ray_pos.shape[1]
    n = lh * lw
    gh, gw = tiles.height, tiles.width
    if n_rounds is None:
        n_rounds = cfg.hiz_rounds if cfg.hiz_rounds is not None else default_rounds(gh, gw)
    s_max = settings.maximum_steps
    k = min(16, s_max)
    large_step = (
        settings.step_size + (20.0 - settings.step_size) * scene_distance * 0.001
    )
    is_back_ray = (
        ray_dir[..., 0] * view_dir[..., 0] + ray_dir[..., 1] * view_dir[..., 1]
        + ray_dir[..., 2] * view_dir[..., 2]
    ) > 0.0
    scalars = schedule_scalars(cam)
    pos_n = ray_pos.reshape(n, 3)
    dir_n = ray_dir.reshape(n, 3)
    back_n = is_back_ray.reshape(n)
    pk_cum, pk_scode, pk_hist, n_cand = schedule_pack(
        pos_n, dir_n, dither.expand(lh, lw).reshape(n),
        large_step.expand(lh, lw).reshape(n), alive.reshape(n), back_n,
        tiles.mini_table, scalars,
        gh=gh, gw=gw, minis_x=tiles.minis_x, s_max=s_max, k=k, max_small_step=cfg.max_small_step,
        max_medium_step=cfg.max_medium_step, small_step_size=cfg.small_step_size,
        medium_step_size=cfg.medium_step_size,
        marching_thickness=cfg.marching_thickness, step_growth=cfg.step_growth,
        thickness_growth=cfg.thickness_growth,
    )
    res = resolve_rounds(
        pk_cum, pk_scode, pk_hist, n_cand, pos_n, dir_n, back_n,
        tiles.pair_table, scalars, gh=gh, gw=gw, pairs_x=tiles.pairs_x,
        n_rounds=int(n_rounds), chain=int(cfg.hiz_chain), s_max=s_max,
    )
    return finalize(res.reshape(len(RESOLVE_FIELDS), lh, lw), ray_pos, ray_dir,
                    is_back_ray, cam, gh, gw)


def finalize(res, ray_pos, ray_dir, is_back_ray, cam, gh, gw) -> MarchResult:
    """Hit interpolation (ref PathTracing.hlsl:199-214) from the resolve
    state; ``pathtrace_hiz.py:907-961`` of the JAX package."""
    st = dict(zip(RESOLVE_FIELDS, res))
    hit = st["hit"] > 0.5
    hit_prev = st["hit_prev"].to(torch.int64)
    hit_ixy = st["hit_ixy"].to(torch.int64)
    prev_sidx = st["prev_sidx"].to(torch.int64)
    hit_cum, hit_diff, hit_th = st["hit_cum"], st["hit_diff"], st["hit_th"]
    scene_at_hit = hit_diff + st["hit_hitd"]
    prev_exact = prev_sidx == hit_prev
    last_diff = torch.where(
        prev_exact & (hit_prev >= 0), st["prev_diff"], scene_at_hit - st["hit_lhd"]
    )
    one = torch.ones_like(hit_diff)
    sgn = torch.where(hit_diff >= 0.0, one, -one)
    lsgn = torch.where(last_diff >= 0.0, one, -one)
    use_lerp = sgn != lsgn
    denom = last_diff - hit_diff
    denom = torch.where(torch.abs(denom) < 1e-20, torch.full_like(denom, 1e-20), denom)
    t = last_diff / denom
    lerp_cum = st["hit_lcum"] + (hit_cum - st["hit_lcum"]) * t
    final_cum = torch.where(use_lerp, lerp_cum, hit_cum)
    hit_pos = ray_pos + final_cum[..., None] * ray_dir
    hit_uv = torch.stack([
        (torch.remainder(hit_ixy, gw).to(torch.float32) + 0.5) / gw,
        (torch.div(hit_ixy, gw, rounding_mode="floor").to(torch.float32) + 0.5) / gh,
    ], dim=-1)
    crossed_out = is_back_ray & (hit_diff < -hit_th)
    cross_uv = world_to_ndc(cam.view_proj, hit_pos)[..., :2]
    hit_uv = torch.where(crossed_out[..., None], cross_uv, hit_uv)
    zero = torch.zeros_like(hit_pos)
    return MarchResult(
        hit=hit,
        position=torch.where(hit[..., None], hit_pos, zero),
        distance=torch.where(hit, hit_cum, torch.full_like(hit_cum, REAL_EPS)),
        uv=torch.where(hit[..., None], hit_uv, torch.zeros_like(hit_uv)),
        is_back_hit=torch.zeros_like(hit),
    )


def build_tiles_for(gb, cam, variants) -> DepthTiles:
    """The plain depth structure (the dual layout is ROADMAP Queue 1 item 9)."""
    variants.check_supported()
    return build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)


def trace_frame_hiz(gb, cam, probes, settings, cfg, variants, frame_index,
                    n_rounds=None, tiles: DepthTiles | None = None):
    """Pass 0 with the hiz march (``trace_frame`` with ``march_fn``
    injected). ``n_rounds`` (or ``cfg.hiz_rounds``) may be a tuple of
    per-bounce budgets, indexed by march call order (last extends)."""
    if tiles is None:
        tiles = build_tiles_for(gb, cam, variants)
    rounds = n_rounds if n_rounds is not None else cfg.hiz_rounds
    if isinstance(rounds, (tuple, list)):
        sched = tuple(int(r) for r in rounds)
        calls = {"n": 0}

        def march_fn(*args, **kw):
            r = sched[min(calls["n"], len(sched) - 1)]
            calls["n"] += 1
            return ray_march_hiz(*args, tiles=tiles, n_rounds=r, **kw)
    else:
        march_fn = partial(ray_march_hiz, tiles=tiles, n_rounds=rounds)
    return trace_frame(gb, cam, probes, settings, cfg, variants, frame_index,
                       march_fn=march_fn)
