"""The hiz march: wavefront schedule + hierarchical depth.

The counterpart of ``unitysspathtracingurp_tpu.ops.pathtrace_hiz``. The
no-refraction / no-backface variant set marches plain ``DepthTiles``;
the refraction and backface variants march ``DualDepthTiles``, where
each lane's insideObject state picks a (test, back) layer combo:

  1-3. ``fused_schedule.schedule_pack`` (kernel K1; dual: K4,
       ``schedule_pack_dual``) builds every lane's step schedule,
       filters steps against the minitile depth intervals and packs the
       first K candidates.
  4.   ``resolve_rounds`` (kernel R1; dual: R1's dual mode,
       ``resolve_rounds_dual``) exact-tests candidates in ``n_rounds``
       rounds of up to ``hiz_chain`` links against the f16 depth table.
  5.   The finalize (hit interpolation) stays as torch ops.

The quality-gated deviations from the parity march are the JAX
package's (its module docstring lists them); this port adds none.
"""

from __future__ import annotations

from functools import partial

import torch

from ..camera import world_to_ndc
from .depth_tiles import (
    DepthTiles, DualDepthTiles, build_depth_tiles, build_dual_depth_tiles, pair_of,
    tile_of, unpack_dual, unpack_pair_half, variant_combos,
)
from .fused_schedule import (
    march_kwargs, pixel_index, schedule_pack, schedule_pack_dual, schedule_scalars,
)
from .pathtrace import REAL_EPS, MarchResult, trace_frame

# Rows of the (11, N) resolve-state table both R1 versions return.
RESOLVE_FIELDS = (
    "hit", "hit_cum", "hit_diff", "hit_th", "hit_hitd", "hit_lcum",
    "hit_lhd", "hit_prev", "hit_ixy", "prev_diff", "prev_sidx",
)
# The dual mode's four extra rows.
DUAL_FIELDS = ("hit_sd", "prev_sd", "hit_back", "hit_via_search")


def default_rounds(height: int, width: int) -> int:
    """Resolve-round budget by resolution: 4 at >= 720p, 10 below."""
    return 4 if min(height, width) >= 720 else 10


def _resolve_plain(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                   table, scalars, dual, *, gh, gw, n_rounds, chain, s_max,
                   pairs_x=0, tiles_x=0, tiles_per_combo=0, has_back=False,
                   links_out=None):
    """The plain versions of R1 (``dual`` None, pair table) and its dual
    mode (``dual`` = (pk_step, combo, search), tile table). A list
    ``links_out`` receives the per-lane count of links tested (one table
    word and one slot each): the work a bound on the kernel counts."""
    k, n = pk_cum.shape
    dev = pk_cum.device
    m = [scalars[i] for i in range(16)]
    zz, zw = scalars[16], scalars[17]
    words_all = table.reshape(-1)
    n_cand = n_cand.to(torch.int64)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    fields = RESOLVE_FIELDS if dual is None else RESOLVE_FIELDS + DUAL_FIELDS
    st = dict(
        hit=torch.zeros(n, dtype=torch.bool, device=dev),
        hit_cum=z, hit_diff=z, hit_th=z, hit_hitd=z, hit_lcum=z, hit_lhd=z,
        hit_prev=torch.zeros(n, dtype=torch.int64, device=dev),
        hit_ixy=torch.zeros(n, dtype=torch.int64, device=dev),
        prev_diff=z,
        prev_sidx=torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    if dual is not None:
        pk_step, combo, search = dual
        row_off = combo.to(torch.int64) * tiles_per_combo
        st.update(hit_sd=z, prev_sd=z, hit_back=torch.zeros_like(st["hit"]),
                  hit_via_search=torch.zeros_like(st["hit"]))
    ptr = torch.zeros(n, dtype=torch.int64, device=dev)
    tested = torch.zeros_like(ptr)
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
            if dual is None:
                pair, texel, high = pair_of(ix, iy, pairs_x)
            else:
                pair, texel = tile_of(ix, iy, tiles_x)
            if j == 0:
                pair0 = pair
            else:
                valid = valid & (pair == pair0)
            tested = tested + valid.to(torch.int64)
            if dual is None:
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
            else:
                step = pk_step.gather(0, sc)[0] * 0.025
                t_raw, b_raw = unpack_dual(words_all[((pair + row_off) * 128) + texel])
                scene = 1.0 / (t_raw * zz + zw)
                is_sky = t_raw == 0.0
                scene_back = 1.0 / (b_raw * zz + zw)
                back_ok = (b_raw != 0.0) & (scene_back >= scene)
                d = scene - hitd
                # Signed diff (hlsl:127-136): back rays beyond a valid back
                # surface bracket that surface instead.
                is_bs = is_back & (hitd > scene_back) & back_ok
                sd = torch.where(is_bs, torch.where(back_ok, hitd - scene_back, d - th), d)
                # Hit windows (hlsl:168-181): backed runs to
                # max(back, test + step), plain is the thickness window.
                hit_backed = (d <= 0.0) & (hitd <= torch.maximum(scene_back, scene + step))
                hit_plain = (d <= 0.0) & (d >= -th)
                base_hit = torch.where(back_ok, hit_backed, hit_plain)
                halvings = torch.ceil(torch.log2(
                    torch.clamp(-d / torch.clamp(th, min=1e-6), min=1.0)
                ))
                budget_ok = (s_idx + 1).to(torch.float32) + halvings <= float(s_max)
                search_ok = search
                if has_back:
                    search_ok = search_ok | (~is_back & back_ok & (hitd <= scene_back))
                hit_now = valid & ~is_sky & (base_hit | (search_ok & (d <= 0.0) & budget_ok))
                back_hit_now = hit_now & back_ok & (hitd > scene_back) & (sd >= 0.0)
                st["hit_sd"] = torch.where(hit_now, sd, st["hit_sd"])
                st["hit_back"] = torch.where(hit_now, back_hit_now, st["hit_back"])
                st["hit_via_search"] = torch.where(hit_now, ~base_hit, st["hit_via_search"])

            for key, val in (("hit_cum", cd), ("hit_diff", d), ("hit_th", th),
                             ("hit_hitd", hitd), ("hit_lcum", lcum),
                             ("hit_lhd", lhd), ("hit_prev", p_idx),
                             ("hit_ixy", iy * gw + ix)):
                st[key] = torch.where(hit_now, val, st[key])
            fail = valid & ~hit_now
            st["prev_diff"] = torch.where(fail, d, st["prev_diff"])
            st["prev_sidx"] = torch.where(fail, s_idx, st["prev_sidx"])
            if dual is not None:
                st["prev_sd"] = torch.where(fail, sd, st["prev_sd"])
            adv = adv + fail.to(torch.int64)
            st["hit"] = st["hit"] | hit_now
            chain_on = fail
        ptr = ptr + adv
    if links_out is not None:
        links_out.append(tested)
    return torch.stack([st[key].to(torch.float32) for key in fields])


def resolve_rounds_ref(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir,
                       is_back, pair_table, scalars, *, gh, gw, pairs_x,
                       n_rounds, chain, s_max, links_out=None):
    """Plain PyTorch version of R1: the torch port of ``run_rounds``
    (dense rounds), reading each link's fields at ptr + j and its texel
    as one pair-table word. Returns the (11, N) f32 resolve state."""
    return _resolve_plain(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                          pair_table, scalars, None, gh=gh, gw=gw, pairs_x=pairs_x,
                          n_rounds=n_rounds, chain=chain, s_max=s_max,
                          links_out=links_out)


def resolve_rounds_dual_ref(pk_cum, pk_scode, pk_hist, pk_step, n_cand, ray_pos,
                            ray_dir, is_back, combo, search, tile_table, scalars, *,
                            gh, gw, tiles_x, tiles_per_combo, n_rounds, chain, s_max,
                            has_back, links_out=None):
    """Plain PyTorch version of R1's dual mode (``run_rounds`` on
    ``DualDepthTiles``, pathtrace_hiz.py:682-694, 736-793, 836): each
    link reads ONE tile-table word, row combo * tiles_per_combo + tile,
    holding the (test, back) raw depths. Returns the (15, N) f32 state:
    RESOLVE_FIELDS then DUAL_FIELDS."""
    return _resolve_plain(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                          tile_table, scalars, (pk_step, combo, search), gh=gh, gw=gw,
                          tiles_x=tiles_x, tiles_per_combo=tiles_per_combo,
                          n_rounds=n_rounds, chain=chain, s_max=s_max, has_back=has_back,
                          links_out=links_out)


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


def resolve_rounds_dual(pk_cum, pk_scode, pk_hist, pk_step, n_cand, ray_pos, ray_dir,
                        is_back, combo, search, tile_table, scalars, **params):
    """R1 dual-mode wrapper. CPU tensors: ``resolve_rounds_dual_ref``.
    CUDA tensors: the kernel, or an exception; there is no fallback."""
    if pk_cum.device.type == "cpu":
        return resolve_rounds_dual_ref(pk_cum, pk_scode, pk_hist, pk_step, n_cand,
                                       ray_pos, ray_dir, is_back, combo, search,
                                       tile_table, scalars, **params)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    k, n = pk_cum.shape
    ins = [
        pk_cum.contiguous(), pk_scode.contiguous(), pk_hist.contiguous(),
        pk_step.contiguous(), n_cand.to(torch.int32).contiguous(),
        ray_pos.to(torch.float32).contiguous(), ray_dir.to(torch.float32).contiguous(),
        is_back.to(torch.uint8).contiguous(), combo.to(torch.int32).contiguous(),
        search.to(torch.uint8).contiguous(), tile_table.to(torch.int32).contiguous(),
        scalars.to(torch.float32).contiguous(),
    ]
    require_cuda("resolve_rounds_dual", *ins)
    if any(t.dtype != torch.float32 or t.shape != (k, n) for t in ins[:4]) or any(
        t.shape != (n,) for t in (ins[4], ins[7], ins[8], ins[9])
    ) or ins[5].shape != (n, 3) or ins[6].shape != (n, 3) or ins[11].numel() != 18:
        raise RuntimeError("resolve_rounds_dual: bad input shapes or dtypes")
    out = torch.empty((len(RESOLVE_FIELDS) + len(DUAL_FIELDS), n), dtype=torch.float32,
                      device=pk_cum.device)
    p = params
    rc = lib.sspt_resolve_rounds_dual(
        *[t.data_ptr() for t in ins], out.data_ptr(),
        n, k, p["gh"], p["gw"], p["tiles_x"], p["tiles_per_combo"], p["n_rounds"],
        p["chain"], p["s_max"], int(p["has_back"]), stream_of(out),
    )
    check(rc, "resolve_rounds_dual")
    LAUNCHES["resolve_rounds_dual"] += 1
    return out


def ray_march_hiz(cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside,
                  dither, view_dir, scene_distance, alive, *, tiles,
                  n_rounds: int | None = None) -> MarchResult:
    """Wavefront RayMarching (PathTracing.hlsl:7-254); the signature of
    the JAX ``ray_march_hiz``. Lanes are (lh, lw). Plain ``DepthTiles``
    serve the no-refraction / no-backface variants only; with
    ``DualDepthTiles`` the lane's insideObject state (constant within
    one march) selects its layer combo (hlsl:79-98)."""
    variants.check_supported()
    cfg.check_supported()
    dual = isinstance(tiles, DualDepthTiles)
    if not dual and (variants.backface_textures or variants.support_refraction):
        raise ValueError("refraction / backface variants march DualDepthTiles")
    lh, lw = ray_pos.shape[0], ray_pos.shape[1]
    n = lh * lw
    gh, gw = tiles.height, tiles.width
    if n_rounds is None:
        n_rounds = cfg.hiz_rounds if cfg.hiz_rounds is not None else default_rounds(gh, gw)
    s_max = settings.maximum_steps
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
    lane_args = (pos_n, dir_n, dither.expand(lh, lw).reshape(n),
                 large_step.expand(lh, lw).reshape(n), alive.reshape(n))
    march_kw = march_kwargs(cfg, tiles, s_max)
    resolve_kw = dict(gh=gh, gw=gw, n_rounds=int(n_rounds), chain=int(cfg.hiz_chain),
                      s_max=s_max)
    if not dual:
        pk_cum, pk_scode, pk_hist, n_cand = schedule_pack(
            *lane_args, back_n, tiles.mini_table, scalars, **march_kw)
        res = resolve_rounds(
            pk_cum, pk_scode, pk_hist, n_cand, pos_n, dir_n, back_n,
            tiles.pair_table, scalars, pairs_x=tiles.pairs_x, **resolve_kw,
        )
    else:
        # Per-lane (test, back) combo from insideObject (hlsl:79-98), and
        # the lanes that may run the binary search whatever the texel's
        # back data: back rays and, under refraction, exiting lanes
        # (insideObject == 2 never blocks the search, hlsl:149).
        inside = inside.expand(lh, lw)
        if tiles.n_combos == 1:
            combo = torch.zeros((lh, lw), dtype=torch.int32, device=inside.device)
        elif tiles.n_combos == 2:
            combo = (inside != 0.0).to(torch.int32)
        else:
            combo = torch.clamp(inside.to(torch.int32), 0, 2)
        search = is_back_ray
        if variants.support_refraction:
            search = search | (inside == 2.0)
        combo, search = combo.reshape(n), search.reshape(n)
        pk_cum, pk_scode, pk_hist, pk_step, n_cand = schedule_pack_dual(
            *lane_args, combo, search, tiles.mini_table, tiles.bmax_table, scalars,
            chunks_per_combo=tiles.chunks_per_combo, **march_kw)
        # Refraction without back data has no back layer anywhere: front
        # rays can never start the search (hlsl:149-156).
        res = resolve_rounds_dual(
            pk_cum, pk_scode, pk_hist, pk_step, n_cand, pos_n, dir_n, back_n, combo,
            search, tiles.tile_table, scalars, tiles_x=tiles.tiles_x,
            tiles_per_combo=tiles.tiles_per_combo,
            has_back=bool(variants.backface_textures), **resolve_kw,
        )
    return finalize(res.reshape(res.shape[0], lh, lw), ray_pos, ray_dir,
                    is_back_ray, cam, gh, gw, dual=dual)


def finalize(res, ray_pos, ray_dir, is_back_ray, cam, gh, gw, *, dual=False) -> MarchResult:
    """Hit interpolation (ref PathTracing.hlsl:199-214) from the resolve
    state; ``pathtrace_hiz.py:907-961`` of the JAX package. ``dual``:
    the state is the dual mode's 15 rows; it lerps on the signed diff,
    decodes search-class hits at the crossing and reports back hits."""
    fields = RESOLVE_FIELDS + DUAL_FIELDS if dual else RESOLVE_FIELDS
    if res.shape[0] != len(fields):
        raise ValueError(f"finalize: {len(fields)} resolve rows expected, got {res.shape[0]}")
    st = dict(zip(fields, res))
    hit = st["hit"] > 0.5
    hit_prev = st["hit_prev"].to(torch.int64)
    hit_ixy = st["hit_ixy"].to(torch.int64)
    prev_sidx = st["prev_sidx"].to(torch.int64)
    hit_cum, hit_diff, hit_th = st["hit_cum"], st["hit_diff"], st["hit_th"]
    scene_at_hit = hit_diff + st["hit_hitd"]
    prev_exact = prev_sidx == hit_prev
    sd_hit = st["hit_sd"] if dual else hit_diff
    sd_prev = st["prev_sd"] if dual else st["prev_diff"]
    last_diff = torch.where(
        prev_exact & (hit_prev >= 0), sd_prev, scene_at_hit - st["hit_lhd"]
    )
    one = torch.ones_like(hit_diff)
    sgn = torch.where(sd_hit >= 0.0, one, -one)
    lsgn = torch.where(last_diff >= 0.0, one, -one)
    use_lerp = sgn != lsgn
    denom = last_diff - sd_hit
    denom = torch.where(torch.abs(denom) < 1e-20, torch.full_like(denom, 1e-20), denom)
    t = last_diff / denom
    lerp_cum = st["hit_lcum"] + (hit_cum - st["hit_lcum"]) * t
    final_cum = torch.where(use_lerp, lerp_cum, hit_cum)
    hit_pos = ray_pos + final_cum[..., None] * ray_dir
    hit_uv = torch.stack([
        (torch.remainder(hit_ixy, gw).to(torch.float32) + 0.5) / gw,
        (torch.div(hit_ixy, gw, rounding_mode="floor").to(torch.float32) + 0.5) / gh,
    ], dim=-1)
    if dual:
        crossed_out = st["hit_via_search"] > 0.5
    else:
        crossed_out = is_back_ray & (hit_diff < -hit_th)
    cross_uv = world_to_ndc(cam.view_proj, hit_pos)[..., :2]
    hit_uv = torch.where(crossed_out[..., None], cross_uv, hit_uv)
    zero = torch.zeros_like(hit_pos)
    return MarchResult(
        hit=hit,
        position=torch.where(hit[..., None], hit_pos, zero),
        distance=torch.where(hit, hit_cum, torch.full_like(hit_cum, REAL_EPS)),
        uv=torch.where(hit[..., None], hit_uv, torch.zeros_like(hit_uv)),
        is_back_hit=(st["hit_back"] > 0.5) if dual else torch.zeros_like(hit),
    )


def build_tiles_for(gb, cam, variants):
    """The depth structure the hiz march needs for this variant set:
    plain pair tables without refraction and backface, per-combo
    dual-layer tables otherwise."""
    variants.check_supported()
    if not (variants.backface_textures or variants.support_refraction):
        return build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)
    return build_dual_depth_tiles(
        variant_combos(gb, variants), cam.near, cam.far, gb.height, gb.width
    )


def trace_frame_hiz(gb, cam, probes, settings, cfg, variants, frame_index,
                    back_depth_enabled: int = 0, n_rounds=None, tiles=None):
    """Pass 0 with the hiz march (``trace_frame`` with ``march_fn``
    injected). ``back_depth_enabled`` is the ThicknessMode value (2 =
    DepthNormals: back normals feed the inside-object normal flip).
    ``n_rounds`` (or ``cfg.hiz_rounds``) may be a tuple of per-bounce
    budgets, indexed by march call order (last extends)."""
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
                       march_fn=march_fn, back_depth_enabled=back_depth_enabled)
