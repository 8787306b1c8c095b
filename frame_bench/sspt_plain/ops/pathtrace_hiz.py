"""The hiz march: wavefront schedule + hierarchical depth.

A frozen copy of the port's plain path for the benchmark's reference.
The no-refraction / no-backface variant set marches plain
``DepthTiles``; the refraction and backface variants march
``DualDepthTiles``, where each lane's insideObject state picks a
(test, back) layer combo:

  1-3. ``fused_schedule.schedule_pack`` (K1's plain version; dual: K4's,
       ``schedule_pack_dual``) builds every lane's step schedule,
       filters steps against the minitile depth intervals and packs the
       first K candidates.
  4.   ``resolve_rounds`` (R1's plain version; dual: R1-dual's,
       ``resolve_rounds_dual``) exact-tests candidates in ``n_rounds``
       rounds of up to ``hiz_chain`` links against the f16 depth table;
       with ``hiz_round_cap`` the rounds after the first dense one run
       on the compacted unresolved lanes.
  5.   The finalize (hit interpolation).

Everything runs as torch ops on any device; the copy has no kernels.
The home prefix, the unfused resolve and the diagnostic march are not
copied: they raise.
"""

from __future__ import annotations

from functools import partial

import torch

from ..camera import world_to_ndc
from .depth_tiles import (
    DualDepthTiles, build_depth_tiles, build_dual_depth_tiles, pair_of, tile_of, unpack_dual,
    unpack_pair_half, variant_combos,
)
from .fused_schedule import (
    march_kwargs, pixel_index, project, schedule_pack, schedule_pack_dual, schedule_scalars,
)
from .pathtrace import (
    REAL_EPS, MarchResult, compact_capacity, compact_indices, march_large_step, trace_frame,
)

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


def _resolve_rounds_torch(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                          table, scalars, dual, *, gh, gw, n_rounds, chain, s_max,
                          pairs_x=0, tiles_x=0, tiles_per_combo=0, has_back=False,
                          state=None):
    """The resolve rounds as torch ops, on the plain layout (``dual``
    None, pair table) or the dual one (``dual`` = (pk_step, combo,
    search), tile table): each link's slot fields read at ptr + j and its
    texel as one table word. ``state`` (1 + rows, N), ptr then the
    resolve rows, is the state the rounds start from, and the result then
    has the same layout; None starts from ptr 0 and the zero state and
    returns the rows alone."""
    n = pk_cum.shape[1]
    dev = pk_cum.device
    m = [scalars[i] for i in range(16)]
    zz, zw = scalars[16], scalars[17]
    n_cand = n_cand.to(torch.int64)
    fields = RESOLVE_FIELDS if dual is None else RESOLVE_FIELDS + DUAL_FIELDS
    if state is None:
        state = zero_state(n, dual is not None, dev)
        rows_only = True
    else:
        rows_only = False
    ptr = state[0].to(torch.int64)
    st = dict(zip(fields, state[1:]))
    for key in ("hit", "hit_back", "hit_via_search"):
        if key in st:
            st[key] = st[key] > 0.5
    for key in ("hit_prev", "hit_ixy", "prev_sidx"):
        st[key] = st[key].to(torch.int64)
    pk = [pk_cum, pk_scode, pk_hist]
    search = row_off = None
    if dual is not None:
        pk_step, combo, search = dual
        pk.append(pk_step)
        row_off = combo.to(torch.int64) * tiles_per_combo
    link = partial(_link, m, zz, zw, ray_pos, ray_dir, gh=gh, gw=gw, pairs_x=pairs_x,
                   tiles_x=tiles_x, dual=dual is not None)
    for r in range(n_rounds):
        chain_on = ~st["hit"] & (ptr < n_cand)
        adv = torch.zeros_like(ptr)
        pair0 = None
        for j, (lk, word) in enumerate(_read_links(pk, ptr, chain, link, table, row_off)):
            valid = chain_on & (ptr + j < n_cand)
            if j == 0:
                pair0 = lk["pair"]
            else:
                valid = valid & (lk["pair"] == pair0)
            fail = _hit_rule(st, lk, word, valid, is_back, search, zz=zz, zw=zw, s_max=s_max,
                             has_back=has_back)
            adv = adv + fail.to(torch.int64)
            chain_on = fail
        ptr = ptr + adv
    rows = [st[key].to(torch.float32) for key in fields]
    return torch.stack(rows if rows_only else [ptr.to(torch.float32)] + rows)


def _link(m, zz, zw, ray_pos, ray_dir, cd, scode, hist, step=None, *, gh, gw, pairs_x,
          tiles_x, dual):
    """One link from its slot fields: the decoded codes, the position
    re-derived from the march distance and its projection, and its
    depth-table row (``pair``; the tile row in the dual layout) and word."""
    th = torch.div(scode, 8192.0, rounding_mode="floor") * 0.025
    sbase = torch.remainder(scode, 8192.0)
    u, v, raw = project(m, ray_pos[:, 0] + cd * ray_dir[:, 0],
                        ray_pos[:, 1] + cd * ray_dir[:, 1],
                        ray_pos[:, 2] + cd * ray_dir[:, 2])
    ix = pixel_index(u, gw)
    iy = pixel_index(v, gh)
    lk = dict(
        cd=cd, th=th,
        s_idx=torch.remainder(sbase, 65.0).to(torch.int64),
        p_idx=torch.div(sbase, 65.0, rounding_mode="floor").to(torch.int64) - 1,
        lcum=torch.div(hist, 4096.0, rounding_mode="floor") * 0.025,
        lhd=torch.remainder(hist, 4096.0) * 0.025,
        hitd=1.0 / (raw * zz + zw), ixy=iy * gw + ix,
    )
    if dual:
        lk["pair"], lk["texel"] = tile_of(ix, iy, tiles_x)
        lk["step"] = step * 0.025
    else:
        lk["pair"], lk["texel"], lk["high"] = pair_of(ix, iy, pairs_x)
    return lk


def _read_links(pk, ptr, chain, link, table, row_off):
    """Link j's slot fields read at ptr + j and its texel as one table
    word (row offset by the lane's combo in the dual layout), link by
    link."""
    k = pk[0].shape[0]
    words_all = table.reshape(-1)
    for j in range(chain):
        sc = torch.clamp(ptr + j, max=k - 1)[None]
        lk = link(*[f.gather(0, sc)[0] for f in pk])
        row = lk["pair"] if row_off is None else lk["pair"] + row_off
        yield lk, words_all[row * 128 + lk["texel"]]


def _hit_rule(st, lk, word, valid, is_back, search, *, zz, zw, s_max, has_back):
    """The exact test of one link against its texel word (the JAX
    package's pathtrace_hiz.py:729-840; ``search`` None on the plain
    layout), folded into the resolve state ``st``. Returns the lanes
    whose valid link failed."""
    if search is None:
        d_raw = unpack_pair_half(word, lk["high"])
        scene = 1.0 / (d_raw * zz + zw)
        is_sky = d_raw == 0.0
        d = scene - lk["hitd"]
        halvings = torch.ceil(torch.log2(
            torch.clamp(-d / torch.clamp(lk["th"], min=1e-6), min=1.0)
        ))
        budget_ok = (lk["s_idx"] + 1).to(torch.float32) + halvings <= float(s_max)
        in_window = (d >= -lk["th"]) | (is_back & budget_ok)
        hit_now = valid & (d <= 0.0) & in_window & ~is_sky
    else:
        hitd, th = lk["hitd"], lk["th"]
        t_raw, b_raw = unpack_dual(word)
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
        hit_backed = (d <= 0.0) & (hitd <= torch.maximum(scene_back, scene + lk["step"]))
        hit_plain = (d <= 0.0) & (d >= -th)
        base_hit = torch.where(back_ok, hit_backed, hit_plain)
        halvings = torch.ceil(torch.log2(
            torch.clamp(-d / torch.clamp(th, min=1e-6), min=1.0)
        ))
        budget_ok = (lk["s_idx"] + 1).to(torch.float32) + halvings <= float(s_max)
        search_ok = search
        if has_back:
            search_ok = search_ok | (~is_back & back_ok & (hitd <= scene_back))
        hit_now = valid & ~is_sky & (base_hit | (search_ok & (d <= 0.0) & budget_ok))
        back_hit_now = hit_now & back_ok & (hitd > scene_back) & (sd >= 0.0)
        st["hit_sd"] = torch.where(hit_now, sd, st["hit_sd"])
        st["hit_back"] = torch.where(hit_now, back_hit_now, st["hit_back"])
        st["hit_via_search"] = torch.where(hit_now, ~base_hit, st["hit_via_search"])

    for key, val in (("hit_cum", lk["cd"]), ("hit_diff", d), ("hit_th", lk["th"]),
                     ("hit_hitd", lk["hitd"]), ("hit_lcum", lk["lcum"]),
                     ("hit_lhd", lk["lhd"]), ("hit_prev", lk["p_idx"]),
                     ("hit_ixy", lk["ixy"])):
        st[key] = torch.where(hit_now, val, st[key])
    fail = valid & ~hit_now
    st["prev_diff"] = torch.where(fail, d, st["prev_diff"])
    st["prev_sidx"] = torch.where(fail, lk["s_idx"], st["prev_sidx"])
    if search is not None:
        st["prev_sd"] = torch.where(fail, sd, st["prev_sd"])
    st["hit"] = st["hit"] | hit_now
    return fail


def zero_state(n: int, dual: bool, device):
    """The (1 + rows, N) state the rounds start from: ptr 0, no hit,
    prev_sidx -1, everything else 0."""
    rows = len(RESOLVE_FIELDS) + (len(DUAL_FIELDS) if dual else 0)
    state = torch.zeros((1 + rows, n), dtype=torch.float32, device=device)
    state[1 + RESOLVE_FIELDS.index("prev_sidx")] = -1.0
    return state


def resolve_rounds(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                   pair_table, scalars, *, gh, gw, pairs_x, n_rounds, chain, s_max,
                   state=None):
    """R1's plain version: the torch port of ``run_rounds``, reading each
    link's fields at ptr + j and its texel as one pair-table word.
    Returns the (11, N) f32 resolve state, or with ``state`` (the (12, N)
    ptr + rows to start from) the (12, N) state after the rounds."""
    return _resolve_rounds_torch(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                                 pair_table, scalars, None, gh=gh, gw=gw, pairs_x=pairs_x,
                                 n_rounds=n_rounds, chain=chain, s_max=s_max, state=state)


def resolve_rounds_dual(pk_cum, pk_scode, pk_hist, pk_step, n_cand, ray_pos, ray_dir,
                        is_back, combo, search, tile_table, scalars, *, gh, gw, tiles_x,
                        tiles_per_combo, n_rounds, chain, s_max, has_back, state=None):
    """R1-dual's plain version (``run_rounds`` on ``DualDepthTiles``,
    pathtrace_hiz.py:682-694, 736-793, 836): each link reads ONE
    tile-table word, row combo * tiles_per_combo + tile, holding the
    (test, back) raw depths. Returns the (15, N) f32 state:
    RESOLVE_FIELDS then DUAL_FIELDS; with ``state`` (16, N), ptr first."""
    return _resolve_rounds_torch(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                                 tile_table, scalars, (pk_step, combo, search), gh=gh, gw=gw,
                                 tiles_x=tiles_x, tiles_per_combo=tiles_per_combo,
                                 n_rounds=n_rounds, chain=chain, s_max=s_max,
                                 has_back=has_back, state=state)


def ray_march_hiz(cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside,
                  dither, view_dir, scene_distance, alive, *, tiles,
                  n_rounds: int | None = None, home_ok: bool = False) -> MarchResult:
    """Wavefront RayMarching (PathTracing.hlsl:7-254); the signature of
    the JAX ``ray_march_hiz``. Lanes are (lh, lw). Plain ``DepthTiles``
    serve the no-refraction / no-backface variants only; with
    ``DualDepthTiles`` the lane's insideObject state (constant within
    one march) selects its layer combo (hlsl:79-98). ``home_ok`` is
    accepted for the signature."""
    dual = isinstance(tiles, DualDepthTiles)
    if not dual and (variants.backface_textures or variants.support_refraction):
        raise ValueError("refraction / backface variants march DualDepthTiles")
    if cfg.hiz_home_prefix or cfg.pallas_extract:
        raise ValueError("the home prefix and the unfused resolve are not in this copy")
    lh, lw = ray_pos.shape[0], ray_pos.shape[1]
    n = lh * lw
    gh, gw = tiles.height, tiles.width
    if n_rounds is None:
        n_rounds = cfg.hiz_rounds if cfg.hiz_rounds is not None else default_rounds(gh, gw)
    n_rounds = int(n_rounds)
    s_max = settings.maximum_steps
    large_step = march_large_step(settings, scene_distance)
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
    resolve_kw = dict(gh=gh, gw=gw, chain=int(cfg.hiz_chain), s_max=s_max)
    if not dual:
        packs = schedule_pack(*lane_args, back_n, tiles.mini_table, scalars, **march_kw)
        lanes = dict(zip(("pk_cum", "pk_scode", "pk_hist", "n_cand"), packs),
                     pos=pos_n, dir=dir_n, back=back_n)
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
        packs = schedule_pack_dual(
            *lane_args, combo, search, tiles.mini_table, tiles.bmax_table, scalars,
            chunks_per_combo=tiles.chunks_per_combo, **march_kw)
        lanes = dict(zip(("pk_cum", "pk_scode", "pk_hist", "pk_step", "n_cand"), packs),
                     pos=pos_n, dir=dir_n, back=back_n, combo=combo, search=search)
        # Refraction without back data has no back layer anywhere: front
        # rays can never start the search (hlsl:149-156).
        resolve_kw.update(tiles_x=tiles.tiles_x, tiles_per_combo=tiles.tiles_per_combo,
                          has_back=bool(variants.backface_textures))

    def resolve(ln, st, rounds):
        """``rounds`` rounds from state ``st`` (None: the zero state)."""
        if st is not None and rounds <= 0:
            return st
        if dual:
            return resolve_rounds_dual(
                ln["pk_cum"], ln["pk_scode"], ln["pk_hist"], ln["pk_step"], ln["n_cand"],
                ln["pos"], ln["dir"], ln["back"], ln["combo"], ln["search"], tiles.tile_table,
                scalars, state=st, n_rounds=rounds, **resolve_kw)
        return resolve_rounds(ln["pk_cum"], ln["pk_scode"], ln["pk_hist"], ln["n_cand"],
                              ln["pos"], ln["dir"], ln["back"], tiles.pair_table, scalars,
                              pairs_x=tiles.pairs_x, state=st, n_rounds=rounds, **resolve_kw)

    # Round compaction (pathtrace_hiz.py:845-905): after one dense round.
    if cfg.hiz_round_cap is not None and n_rounds > 1:
        dense, cap = 1, cfg.hiz_round_cap
    else:
        dense, cap = n_rounds, None
    if cap is None:
        res = resolve(lanes, None, n_rounds)
    else:
        state = resolve(lanes, zero_state(n, dual, pos_n.device), dense)
        cap_n = compact_capacity(cap, n)
        if cap_n < n:
            idx, valid, _, _, _ = compact_indices(_active(state, lanes["n_cand"]), cap_n)
            sub = {key: val[:, idx] if key.startswith("pk_") else val[idx]
                   for key, val in lanes.items()}
            cst = state[:, idx]
            # Compacted lanes are all unresolved; overflow lanes keep their
            # dense state and finalize as misses.
            cst[1] = 0.0
            cst = resolve(sub, cst, n_rounds - dense)
            state[:, idx[valid]] = cst[:, valid]
        else:
            state = resolve(lanes, state, n_rounds - dense)
        res = state[1:]
    return finalize(res.reshape(res.shape[0], lh, lw), ray_pos, ray_dir,
                    is_back_ray, cam, gh, gw, dual=dual)


def _active(state, n_cand):
    """Lanes with candidates left to test: no hit and ptr < n_cand."""
    return (state[1] < 0.5) & (state[0] < n_cand.to(torch.float32))


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
    if not (variants.backface_textures or variants.support_refraction):
        return build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)
    return build_dual_depth_tiles(
        variant_combos(gb, variants), cam.near, cam.far, gb.height, gb.width
    )


def trace_frame_hiz(gb, cam, probes, settings, cfg, variants, frame_index,
                    back_depth_enabled: int = 0, n_rounds=None, tiles=None,
                    history_sample=None):
    """Pass 0 with the hiz march (``trace_frame`` with ``march_fn``
    injected). ``back_depth_enabled`` is the ThicknessMode value (2 =
    DepthNormals: back normals feed the inside-object normal flip).
    ``n_rounds`` (or ``cfg.hiz_rounds``) may be a tuple of
    per-bounce budgets (last extends), indexed by the bounce:
    ``trace_frame`` marches ``maximum_depth`` times a sample, so call c
    is bounce c mod ``maximum_depth``. ``history_sample``: the temporal
    history's sample counts, for adaptive spp."""
    if tiles is None:
        tiles = build_tiles_for(gb, cam, variants)
    rounds = n_rounds if n_rounds is not None else cfg.hiz_rounds
    if isinstance(rounds, (tuple, list)):
        sched = tuple(int(r) for r in rounds)
        calls = {"n": 0}

        def march_fn(*args, **kw):
            r = sched[min(calls["n"] % settings.maximum_depth, len(sched) - 1)]
            calls["n"] += 1
            return ray_march_hiz(*args, tiles=tiles, n_rounds=r, **kw)
    else:
        march_fn = partial(ray_march_hiz, tiles=tiles, n_rounds=rounds)
    return trace_frame(gb, cam, probes, settings, cfg, variants, frame_index,
                       march_fn=march_fn, back_depth_enabled=back_depth_enabled,
                       history_sample=history_sample)
