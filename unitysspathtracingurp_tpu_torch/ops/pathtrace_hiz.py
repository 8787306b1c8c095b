"""The hiz march: wavefront schedule + hierarchical depth.

The counterpart of ``unitysspathtracingurp_tpu.ops.pathtrace_hiz``. The
no-refraction / no-backface variant set marches plain ``DepthTiles``;
the refraction and backface variants march ``DualDepthTiles``, where
each lane's insideObject state picks a (test, back) layer combo:

  1-3. ``fused_schedule.schedule_pack`` (kernel K1; dual: K4,
       ``schedule_pack_dual``) builds every lane's step schedule,
       filters steps against the minitile depth intervals and packs the
       first K candidates.
     On bounce 0 of a screen-ordered frame with ``hiz_home_prefix``,
       ``fused_schedule.schedule_pack_home`` (kernel K6) does the same
       and exact-tests each lane's leading in-strip candidates (the home
       prefix), returning the resolve state the rounds start from.
  4.   ``resolve_rounds`` (kernel R1; dual: R1's dual mode,
       ``resolve_rounds_dual``) exact-tests candidates in ``n_rounds``
       rounds of up to ``hiz_chain`` links against the f16 depth table;
       with ``hiz_round_cap`` / ``hiz_home_round_cap`` the rounds after
       the first dense one (home: all of them) run on the compacted
       unresolved lanes.
  5.   The finalize (hit interpolation) stays as torch ops.

With ``_debug_out`` (a dict) the march is the JAX package's diagnostic
march: phases 1-3 run unfused, the schedule stacked over (S, N) by torch
ops, the minitile filter through ``pallas_gather.broadcast_table_select``
(kernel K2) and the pack through ``pallas_gather.pack_by_slot`` (kernel
K3), the rounds one at a time, and the JAX package's counters land in the
dict under its names (``c{call}_pk``, ``c{call}_n_cand``, ...).

The quality-gated deviations from the parity march are the JAX
package's (its module docstring lists them); this port adds none.
"""

from __future__ import annotations

from functools import partial

import torch

from ..camera import world_to_ndc
from .depth_tiles import (
    DepthTiles, DualDepthTiles, build_depth_tiles, build_dual_depth_tiles, build_home_strips,
    mini_of, pair_of, tile_of, unpack_dual, unpack_f16_low, unpack_minmax, unpack_pair_half,
    variant_combos,
)
from .fused_schedule import (
    march_kwargs, march_steps, pixel_index, project, q40, schedule_pack, schedule_pack_dual,
    schedule_pack_home, schedule_scalars, thickness_cap,
)
from .pallas_gather import broadcast_table_select, pack_by_slot
from .pathtrace import REAL_EPS, MarchResult, compact_capacity, compact_indices, trace_frame

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
                   state=None, links_out=None):
    """The plain versions of R1 (``dual`` None, pair table) and its dual
    mode (``dual`` = (pk_step, combo, search), tile table). ``state``
    (1 + rows, N), ptr then the resolve rows, is the state the rounds
    start from, and the result then has the same layout; None starts
    from ptr 0 and the zero state and returns the rows alone. A list
    ``links_out`` receives the per-lane count of links tested (one table
    word and one slot each): the work a bound on the kernel counts."""
    k, n = pk_cum.shape
    dev = pk_cum.device
    m = [scalars[i] for i in range(16)]
    zz, zw = scalars[16], scalars[17]
    words_all = table.reshape(-1)
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
    if dual is not None:
        pk_step, combo, search = dual
        row_off = combo.to(torch.int64) * tiles_per_combo
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

            u, v, raw = project(m, ray_pos[:, 0] + cd * ray_dir[:, 0],
                                ray_pos[:, 1] + cd * ray_dir[:, 1],
                                ray_pos[:, 2] + cd * ray_dir[:, 2])
            hitd = 1.0 / (raw * zz + zw)
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
    rows = [st[key].to(torch.float32) for key in fields]
    return torch.stack(rows if rows_only else [ptr.to(torch.float32)] + rows)


def zero_state(n: int, dual: bool, device):
    """The (1 + rows, N) state the rounds start from without a home
    prefix: ptr 0, no hit, prev_sidx -1, everything else 0."""
    rows = len(RESOLVE_FIELDS) + (len(DUAL_FIELDS) if dual else 0)
    state = torch.zeros((1 + rows, n), dtype=torch.float32, device=device)
    state[1 + RESOLVE_FIELDS.index("prev_sidx")] = -1.0
    return state


def resolve_rounds_ref(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir,
                       is_back, pair_table, scalars, *, gh, gw, pairs_x,
                       n_rounds, chain, s_max, state=None, links_out=None):
    """Plain PyTorch version of R1: the torch port of ``run_rounds``,
    reading each link's fields at ptr + j and its texel as one pair-table
    word. Returns the (11, N) f32 resolve state, or with ``state`` (the
    (12, N) ptr + rows to start from) the (12, N) state after the rounds."""
    return _resolve_plain(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                          pair_table, scalars, None, gh=gh, gw=gw, pairs_x=pairs_x,
                          n_rounds=n_rounds, chain=chain, s_max=s_max, state=state,
                          links_out=links_out)


def resolve_rounds_dual_ref(pk_cum, pk_scode, pk_hist, pk_step, n_cand, ray_pos,
                            ray_dir, is_back, combo, search, tile_table, scalars, *,
                            gh, gw, tiles_x, tiles_per_combo, n_rounds, chain, s_max,
                            has_back, state=None, links_out=None):
    """Plain PyTorch version of R1's dual mode (``run_rounds`` on
    ``DualDepthTiles``, pathtrace_hiz.py:682-694, 736-793, 836): each
    link reads ONE tile-table word, row combo * tiles_per_combo + tile,
    holding the (test, back) raw depths. Returns the (15, N) f32 state:
    RESOLVE_FIELDS then DUAL_FIELDS; with ``state`` (16, N), ptr first."""
    return _resolve_plain(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                          tile_table, scalars, (pk_step, combo, search), gh=gh, gw=gw,
                          tiles_x=tiles_x, tiles_per_combo=tiles_per_combo,
                          n_rounds=n_rounds, chain=chain, s_max=s_max, has_back=has_back,
                          state=state, links_out=links_out)


def _state_args(state, rows, n, dev):
    """The state-in pointer (0 for none) and the output of R1's kernel."""
    if state is None:
        return 0, torch.empty((rows, n), dtype=torch.float32, device=dev)
    if state.shape != (1 + rows, n) or state.dtype != torch.float32:
        raise RuntimeError(f"resolve state must be ({1 + rows}, {n}) f32")
    return state.data_ptr(), torch.empty((1 + rows, n), dtype=torch.float32, device=dev)


def resolve_rounds(pk_cum, pk_scode, pk_hist, n_cand, ray_pos, ray_dir, is_back,
                   pair_table, scalars, *, state=None, **params):
    """R1 wrapper. CPU tensors: ``resolve_rounds_ref``. CUDA tensors: the
    kernel, or an exception; there is no fallback."""
    if pk_cum.device.type == "cpu":
        return resolve_rounds_ref(pk_cum, pk_scode, pk_hist, n_cand, ray_pos,
                                  ray_dir, is_back, pair_table, scalars, state=state, **params)
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
    st = None if state is None else state.contiguous()
    require_cuda("resolve_rounds", *ins, *([] if st is None else [st]))
    if any(t.dtype != torch.float32 or t.shape != (k, n) for t in ins[:3]) or (
        ins[3].shape != (n,) or ins[4].shape != (n, 3) or ins[5].shape != (n, 3)
        or ins[6].shape != (n,) or ins[8].numel() != 18
    ):
        raise RuntimeError("resolve_rounds: bad input shapes or dtypes")
    state_ptr, out = _state_args(st, len(RESOLVE_FIELDS), n, pk_cum.device)
    p = params
    rc = lib.sspt_resolve_rounds(
        *[t.data_ptr() for t in ins], state_ptr, out.data_ptr(),
        n, k, p["gh"], p["gw"], p["pairs_x"], p["n_rounds"], p["chain"],
        p["s_max"], stream_of(out),
    )
    check(rc, "resolve_rounds")
    LAUNCHES["resolve_rounds"] += 1
    return out


def resolve_rounds_dual(pk_cum, pk_scode, pk_hist, pk_step, n_cand, ray_pos, ray_dir,
                        is_back, combo, search, tile_table, scalars, *, state=None, **params):
    """R1 dual-mode wrapper. CPU tensors: ``resolve_rounds_dual_ref``.
    CUDA tensors: the kernel, or an exception; there is no fallback."""
    if pk_cum.device.type == "cpu":
        return resolve_rounds_dual_ref(pk_cum, pk_scode, pk_hist, pk_step, n_cand,
                                       ray_pos, ray_dir, is_back, combo, search,
                                       tile_table, scalars, state=state, **params)
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
    st = None if state is None else state.contiguous()
    require_cuda("resolve_rounds_dual", *ins, *([] if st is None else [st]))
    if any(t.dtype != torch.float32 or t.shape != (k, n) for t in ins[:4]) or any(
        t.shape != (n,) for t in (ins[4], ins[7], ins[8], ins[9])
    ) or ins[5].shape != (n, 3) or ins[6].shape != (n, 3) or ins[11].numel() != 18:
        raise RuntimeError("resolve_rounds_dual: bad input shapes or dtypes")
    state_ptr, out = _state_args(st, len(RESOLVE_FIELDS) + len(DUAL_FIELDS), n, pk_cum.device)
    p = params
    rc = lib.sspt_resolve_rounds_dual(
        *[t.data_ptr() for t in ins], state_ptr, out.data_ptr(),
        n, k, p["gh"], p["gw"], p["tiles_x"], p["tiles_per_combo"], p["n_rounds"],
        p["chain"], p["s_max"], int(p["has_back"]), stream_of(out),
    )
    check(rc, "resolve_rounds_dual")
    LAUNCHES["resolve_rounds_dual"] += 1
    return out


def unfused_front_half(lane_args, is_back, scalars, tiles, march_kw, dual_lanes=None,
                       debug=None, pfx="", lane_shape=None):
    """Phases 1-3 of the JAX package's unfused front half
    (pathtrace_hiz.py:292-523): the schedule stacked over (S, N) by torch
    ops, the minitile filter through K2 (``broadcast_table_select``) and
    the pack through K3 (``pack_by_slot``). Returns K1's packs (with
    ``dual_lanes`` = (combo, search): K4's), the same values by the JAX
    package's promise. ``debug`` (a dict) receives the JAX package's
    diagnostic counters under ``pfx``; ``lane_shape`` is (lh, lw)."""
    steps = list(march_steps(*lane_args, scalars, **march_kw))

    def stack(key):
        return torch.stack([st[key] for st in steps])

    ix_s, iy_s, hitd_s, th_s, proc_s = (stack(key) for key in ("ix", "iy", "hitd", "th", "proc"))
    mini_s = mini_of(ix_s, iy_s, tiles.minis_x)
    if dual_lanes is None:
        mmin_s, mmax_s = unpack_minmax(broadcast_table_select(tiles.mini_table, mini_s))
        cand_s = proc_s & (hitd_s >= mmin_s) & ((hitd_s - th_s <= mmax_s) | is_back[None])
    else:
        # The conservative dual rule (pathtrace_hiz.py:382-404).
        combo, search = dual_lanes
        mini_s = mini_s + (combo.to(torch.int64) * (tiles.chunks_per_combo * 128))[None]
        mmin_s, mmax_s = unpack_minmax(broadcast_table_select(tiles.mini_table, mini_s))
        bmax_s = unpack_f16_low(broadcast_table_select(tiles.bmax_table, mini_s))
        step_s = stack("step")
        cand_s = proc_s & (hitd_s >= mmin_s) & (
            (hitd_s - torch.maximum(th_s, step_s) <= mmax_s) | search[None]
            | (hitd_s <= bmax_s))
    s_max, k = march_kw["s_max"], march_kw["k"]
    th_cap = thickness_cap(march_kw["marching_thickness"], march_kw["thickness_growth"], s_max)
    iota = torch.arange(s_max, dtype=torch.float32, device=th_s.device)[:, None]
    fields = [
        stack("cum"),
        iota + 65.0 * (stack("pidx") + 1.0) + q40(th_s, th_cap) * 8192.0,
        q40(stack("lcum"), 4095.0) * 4096.0 + q40(stack("lhd"), 4095.0),
    ]
    if dual_lanes is not None:
        fields.append(q40(step_s, 4095.0))
    packed, n_cand = pack_by_slot(cand_s, fields, k)
    if debug is not None:
        lh, lw = lane_shape
        debug[pfx + "pk"] = tuple(packed[:3])
        debug[pfx + "n_cand"] = n_cand.reshape(lh, lw)
        # Unclamped: lanes above K dropped candidates (the K-cap deviation).
        debug[pfx + "n_cand_true"] = cand_s.sum(0).reshape(lh, lw)
        if dual_lanes is None:
            _locality_counters(debug, pfx, lane_args[0], scalars, tiles, cand_s, ix_s, iy_s,
                               n_cand, march_kw)
        if debug.get("_full"):  # (S, N) dumps: small shapes only
            debug.update({pfx + "cand_s": cand_s, pfx + "proc_s": proc_s,
                          pfx + "hitd_s": hitd_s, pfx + "mmin_s": mmin_s,
                          pfx + ("mmax_s" if dual_lanes is None else "umax_s"): mmax_s,
                          pfx + "th_s": th_s, pfx + "cum_s": fields[0],
                          pfx + "ixy_s": iy_s * march_kw["gw"] + ix_s})
    return (*packed, n_cand)


def _locality_counters(debug, pfx, ray_pos, scalars, tiles, cand_s, ix_s, iy_s, n_cand,
                       march_kw):
    """Start-window locality of the candidates (pathtrace_hiz.py:479-514):
    how many sit in the ray start texel's 32x8-px pair window, for how
    many lanes the first one does, and how many lie within +-lim pair
    bands / pairs of it."""
    m = [scalars[i] for i in range(16)]
    u0, v0, _ = project(m, ray_pos[:, 0], ray_pos[:, 1], ray_pos[:, 2])
    pair_start, _, _ = pair_of(pixel_index(u0, march_kw["gw"]), pixel_index(v0, march_kw["gh"]),
                               tiles.pairs_x)
    pair_c, _, _ = pair_of(ix_s, iy_s, tiles.pairs_x)
    in_home = cand_s & (pair_c == pair_start[None])
    debug[pfx + "cand_total"] = cand_s.sum()
    debug[pfx + "cand_in_home"] = in_home.sum()
    first = torch.argmax(cand_s.to(torch.int32), dim=0)
    debug[pfx + "first_in_home"] = ((n_cand > 0) & in_home.gather(0, first[None])[0]).sum()
    dy = torch.abs(torch.div(pair_c, tiles.pairs_x, rounding_mode="floor")
                   - torch.div(pair_start, tiles.pairs_x, rounding_mode="floor")[None])
    dx = torch.abs(torch.remainder(pair_c, tiles.pairs_x)
                   - torch.remainder(pair_start, tiles.pairs_x)[None])
    for lim in (1, 2, 4, 8, 16):
        debug[pfx + f"cand_within_{lim}"] = (cand_s & (dy <= lim) & (dx <= lim)).sum()


def ray_march_hiz(cfg, settings, variants, gb, cam, ray_pos, ray_dir, inside,
                  dither, view_dir, scene_distance, alive, *, tiles,
                  n_rounds: int | None = None, home_ok: bool = False,
                  _debug_out: dict | None = None) -> MarchResult:
    """Wavefront RayMarching (PathTracing.hlsl:7-254); the signature of
    the JAX ``ray_march_hiz``. Lanes are (lh, lw). Plain ``DepthTiles``
    serve the no-refraction / no-backface variants only; with
    ``DualDepthTiles`` the lane's insideObject state (constant within
    one march) selects its layer combo (hlsl:79-98).

    ``home_ok``: the caller certifies the lanes are the screen-ordered
    pixel grid (bounce 0, spp 1); with ``cfg.hiz_home_prefix`` and a
    plain layout of h % 8 == 0, w % 128 == 0 the front half is K6.
    ``_debug_out``: the diagnostic march (module docstring); each call
    namespaces its counters ``c{call}_`` by the dict's ``_calls``."""
    variants.check_supported()
    dual = isinstance(tiles, DualDepthTiles)
    if not dual and (variants.backface_textures or variants.support_refraction):
        raise ValueError("refraction / backface variants march DualDepthTiles")
    pfx = ""
    if _debug_out is not None:
        call = _debug_out.get("_calls", 0)
        _debug_out["_calls"] = call + 1
        pfx = f"c{call}_"
    lh, lw = ray_pos.shape[0], ray_pos.shape[1]
    n = lh * lw
    gh, gw = tiles.height, tiles.width
    if n_rounds is None:
        n_rounds = cfg.hiz_rounds if cfg.hiz_rounds is not None else default_rounds(gh, gw)
    n_rounds = int(n_rounds)
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
    resolve_kw = dict(gh=gh, gw=gw, chain=int(cfg.hiz_chain), s_max=s_max)
    use_home = (bool(cfg.hiz_home_prefix) and home_ok and not dual and _debug_out is None
                and lh % 8 == 0 and lw % 128 == 0)
    state = None
    if not dual:
        if _debug_out is not None:
            packs = unfused_front_half(lane_args, back_n, scalars, tiles, march_kw,
                                       debug=_debug_out, pfx=pfx, lane_shape=(lh, lw))
        elif use_home:
            *packs, home_out = schedule_pack_home(
                *lane_args, back_n, tiles.mini_table, build_home_strips(tiles, lh, lw),
                scalars, home_shape=(lh, lw), **march_kw)
            # The rounds start from the prefix's outcome: lanes that hit
            # in-strip packed nothing; the others carry the prefix's
            # failed tests into the interpolation.
            state = torch.cat([torch.zeros_like(home_out[:1]), home_out])
        else:
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
        if _debug_out is not None:
            packs = unfused_front_half(lane_args, back_n, scalars, tiles, march_kw,
                                       dual_lanes=(combo, search), debug=_debug_out, pfx=pfx,
                                       lane_shape=(lh, lw))
        else:
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
        if dual:
            return resolve_rounds_dual(
                ln["pk_cum"], ln["pk_scode"], ln["pk_hist"], ln["pk_step"], ln["n_cand"],
                ln["pos"], ln["dir"], ln["back"], ln["combo"], ln["search"], tiles.tile_table,
                scalars, state=st, n_rounds=rounds, **resolve_kw)
        return resolve_rounds(
            ln["pk_cum"], ln["pk_scode"], ln["pk_hist"], ln["n_cand"], ln["pos"], ln["dir"],
            ln["back"], tiles.pair_table, scalars, state=st, pairs_x=tiles.pairs_x,
            n_rounds=rounds, **resolve_kw)

    def run_rounds(ln, st, rounds, base):
        """``rounds`` rounds from state ``st``; the diagnostic march runs
        them one at a time to count the active lanes of each."""
        if _debug_out is None:
            return resolve(ln, st, rounds) if rounds > 0 else st
        for r in range(rounds):
            _debug_out[f"{pfx}active_r{base + r}"] = _active(st, ln["n_cand"]).sum()
            st = resolve(ln, st, 1)
        return st

    # Round compaction (pathtrace_hiz.py:845-905): with the home prefix
    # the rounds run compacted from round 0, else after one dense round.
    if use_home and cfg.hiz_home_round_cap is not None and n_rounds >= 1:
        dense, cap = 0, cfg.hiz_home_round_cap
    elif cfg.hiz_round_cap is not None and n_rounds > 1:
        dense, cap = 1, cfg.hiz_round_cap
    else:
        dense, cap = n_rounds, None
    if state is None and cap is None and _debug_out is None:
        res = resolve(lanes, None, n_rounds)
    else:
        if state is None:
            state = zero_state(n, dual, pos_n.device)
        state = run_rounds(lanes, state, dense, 0)
        cap_n = n if cap is None else compact_capacity(cap, n)
        if cap_n < n:
            idx, valid, n_drop, _, _ = compact_indices(_active(state, lanes["n_cand"]), cap_n)
            if _debug_out is not None:
                _debug_out[f"{pfx}round_compact_drop"] = n_drop
            sub = {key: val[:, idx] if key.startswith("pk_") else val[idx]
                   for key, val in lanes.items()}
            cst = state[:, idx]
            # Compacted lanes are all unresolved; overflow lanes keep their
            # dense state and finalize as misses.
            cst[1] = 0.0
            cst = run_rounds(sub, cst, n_rounds - dense, dense)
            state[:, idx[valid]] = cst[:, valid]
        else:
            state = run_rounds(lanes, state, n_rounds - dense, dense)
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
    variants.check_supported()
    if not (variants.backface_textures or variants.support_refraction):
        return build_depth_tiles(gb.layer1_depth(), cam.near, cam.far)
    return build_dual_depth_tiles(
        variant_combos(gb, variants), cam.near, cam.far, gb.height, gb.width
    )


def trace_frame_hiz(gb, cam, probes, settings, cfg, variants, frame_index,
                    back_depth_enabled: int = 0, n_rounds=None, tiles=None,
                    _debug_out: dict | None = None):
    """Pass 0 with the hiz march (``trace_frame`` with ``march_fn``
    injected). ``back_depth_enabled`` is the ThicknessMode value (2 =
    DepthNormals: back normals feed the inside-object normal flip).
    ``n_rounds`` (or ``cfg.hiz_rounds``) may be a tuple of per-bounce
    budgets, indexed by march call order (last extends). ``_debug_out``:
    every bounce's march is the diagnostic march (``ray_march_hiz``)."""
    if tiles is None:
        tiles = build_tiles_for(gb, cam, variants)
    rounds = n_rounds if n_rounds is not None else cfg.hiz_rounds
    if isinstance(rounds, (tuple, list)):
        sched = tuple(int(r) for r in rounds)
        calls = {"n": 0}

        def march_fn(*args, **kw):
            r = sched[min(calls["n"], len(sched) - 1)]
            calls["n"] += 1
            return ray_march_hiz(*args, tiles=tiles, n_rounds=r, _debug_out=_debug_out, **kw)
    else:
        march_fn = partial(ray_march_hiz, tiles=tiles, n_rounds=rounds, _debug_out=_debug_out)
    return trace_frame(gb, cam, probes, settings, cfg, variants, frame_index,
                       march_fn=march_fn, back_depth_enabled=back_depth_enabled)
