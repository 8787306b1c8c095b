"""The unfused hiz march's selects: K2, K3, K5 and K7.

The counterpart of ``unitysspathtracingurp_tpu.ops.pallas_gather``:
``broadcast_table_select`` wraps kernel K2, ``pack_by_slot`` kernel K3,
``extract_chain`` kernel K5 and ``rowwise_select`` kernel K7
(``csrc/pallas_gather.cu``); ``*_ref`` are their plain PyTorch versions.
K2 and K3 run on the diagnostic march (``pathtrace_hiz.ray_march_hiz``
with ``_debug_out``), phases 2 and 3 of the unfused front half that K1 /
K4 fuse; the JAX package promises the two routes give the same packs.
K5 and K7 run in the unfused resolve rounds (``PTConfig.pallas_extract``,
``pathtrace_hiz.resolve_rounds_unfused``): K5 extracts a round's chain
links from the slot tables, ``row_gather`` fetches each lane's
depth-table row and K7 selects the links' texel words from it; R1 fuses
all three.

The wrappers pick by device: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch


def broadcast_table_select_ref(table, idx):
    """``table.reshape(-1)[idx]`` for a small table of 32-bit words held
    in int32 (the JAX package holds the same bits as f32), 0 where an
    index lies outside the table. Returns int32 of ``idx``'s shape."""
    flat = table.reshape(-1).to(torch.int32)
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < flat.numel())
    return torch.where(ok, flat[torch.clamp(idx, 0, flat.numel() - 1)],
                       torch.zeros((), dtype=torch.int32, device=flat.device))


def broadcast_table_select(table, idx):
    """K2 wrapper. CPU tensors: ``broadcast_table_select_ref``. CUDA
    tensors: the kernel, or an exception; there is no fallback."""
    if idx.device.type == "cpu":
        return broadcast_table_select_ref(table, idx)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    tab = table.to(torch.int32).contiguous()
    ix = idx.to(torch.int32).contiguous()
    require_cuda("broadcast_table_select", tab, ix)
    if tab.numel() * 4 > 227 * 1024:
        raise RuntimeError("broadcast_table_select: table exceeds shared memory")
    out = torch.empty(ix.shape, dtype=torch.int32, device=ix.device)
    rc = lib.sspt_broadcast_table_select(tab.data_ptr(), ix.data_ptr(), out.data_ptr(),
                                         tab.numel(), ix.numel(), stream_of(out))
    check(rc, "broadcast_table_select")
    LAUNCHES["broadcast_table_select"] += 1
    return out


def pack_by_slot_ref(cand, fields, k: int):
    """Per lane n (column), the values of each (S, N) f32 field at the
    lane's first ``k`` candidate steps (rows where ``cand``), as rows of
    (k, N) tables with zeros past the lane's count; plus the (N,) int32
    count clamped to k. -0.0 packs as +0.0, as the JAX masked sums give."""
    s, n = cand.shape
    dev = cand.device
    cand = cand.to(torch.bool)
    slot = torch.cumsum(cand.to(torch.int64), 0) - 1
    lane = torch.arange(n, device=dev)
    dst = torch.where(cand & (slot < k), slot * n + lane, torch.full_like(slot, k * n))
    packed = []
    for f in fields:
        out = torch.zeros(k * n + 1, dtype=torch.float32, device=dev)
        out.scatter_(0, dst.reshape(-1), (f.to(torch.float32) + 0.0).reshape(-1))
        packed.append(out[: k * n].reshape(k, n))
    return packed, torch.clamp(cand.sum(0), max=k).to(torch.int32)


def pack_by_slot(cand, fields, k: int):
    """K3 wrapper (3 or 4 fields, S <= 64, k <= 16). CPU tensors:
    ``pack_by_slot_ref``. CUDA tensors: the kernel, or an exception;
    there is no fallback."""
    if cand.device.type == "cpu":
        return pack_by_slot_ref(cand, fields, k)
    from ..kernels.build import (LAUNCHES, check, flag_bytes, load_library, require_cuda,
                                 stream_of)

    lib = load_library()
    s, n = cand.shape
    c = flag_bytes(cand)
    ins = [f.to(torch.float32).contiguous() for f in fields]
    require_cuda("pack_by_slot", c, *ins)
    if not 3 <= len(ins) <= 4 or any(t.shape != (s, n) for t in ins) or s > 64 or k > 16:
        raise RuntimeError("pack_by_slot: 3 or 4 (S, N) fields, S <= 64, k <= 16")
    outs = [torch.empty((k, n), dtype=torch.float32, device=c.device) for _ in ins]
    count = torch.empty(n, dtype=torch.int32, device=c.device)
    pad = [None] * (4 - len(ins))
    rc = lib.sspt_pack_by_slot(
        c.data_ptr(), *[t.data_ptr() for t in ins], *pad, *[t.data_ptr() for t in outs], *pad,
        count.data_ptr(), s, n, k, len(ins), stream_of(count),
    )
    check(rc, "pack_by_slot")
    LAUNCHES["pack_by_slot"] += 1
    return outs, count


def extract_chain_ref(fields, ptr, chain: int, slot_hi: int):
    """Per field, the (chain, N) f32 table ``out[j, n] = field[ptr[n] + j,
    n]`` of (K, N) f32 slot tables, 0 where ptr + j lies outside [0,
    min(slot_hi, K)). -0.0 comes back as +0.0, as the JAX masked sums give."""
    k = fields[0].shape[0]
    s = ptr.to(torch.int64)[None] + torch.arange(chain, device=ptr.device)[:, None]
    ok = (s >= 0) & (s < min(slot_hi, k))
    s = torch.clamp(s, 0, k - 1)
    zero = torch.zeros((), dtype=torch.float32, device=ptr.device)
    return [torch.where(ok, f.to(torch.float32).gather(0, s) + 0.0, zero) for f in fields]


def extract_chain(fields, ptr, chain: int, slot_hi: int):
    """K5 wrapper (3 or 4 fields). CPU tensors: ``extract_chain_ref``.
    CUDA tensors: the kernel, or an exception; there is no fallback."""
    if ptr.device.type == "cpu":
        return extract_chain_ref(fields, ptr, chain, slot_hi)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    ins = [f.to(torch.float32).contiguous() for f in fields]
    p = ptr.to(torch.int32).contiguous()
    require_cuda("extract_chain", p, *ins)
    k, n = ins[0].shape
    if not 3 <= len(ins) <= 4 or any(t.shape != (k, n) for t in ins) or p.shape != (n,):
        raise RuntimeError("extract_chain: 3 or 4 (K, N) f32 fields and an (N,) ptr")
    outs = [torch.empty((chain, n), dtype=torch.float32, device=p.device) for _ in ins]
    pad = [None] * (4 - len(ins))
    rc = lib.sspt_extract_chain(
        p.data_ptr(), *[t.data_ptr() for t in ins], *pad, *[t.data_ptr() for t in outs], *pad,
        n, k, chain, min(slot_hi, k), len(ins), stream_of(p),
    )
    check(rc, "extract_chain")
    LAUNCHES["extract_chain"] += 1
    return outs


def row_gather(table, row_idx):
    """``rows[i] = table[row_idx[i], :]``, indices clipped to the table:
    the JAX package's XLA ``row_gather`` (pallas_gather.py:260), which
    is no Pallas kernel; here one ``index_select``."""
    return table.index_select(0, torch.clamp(row_idx, 0, table.shape[0] - 1))


def rowwise_select_ref(blocks, idx):
    """``values[r, k] = blocks[r, idx[r, k] & 127]`` from (N, 128) rows of
    32-bit words, int32 (u32 bits) or f32; moved bit for bit, never
    through a float. Returns (N, K) of ``blocks``' dtype."""
    if blocks.dtype == torch.float32:
        return rowwise_select_ref(blocks.view(torch.int32), idx).view(torch.float32)
    return blocks.gather(1, idx.to(torch.int64) & 127)


def rowwise_select(blocks, idx):
    """K7 wrapper (int32 or f32 blocks, K <= 128). CPU tensors:
    ``rowwise_select_ref``. CUDA tensors: the kernel, or an exception;
    there is no fallback."""
    if blocks.device.type == "cpu":
        return rowwise_select_ref(blocks, idx)
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    if blocks.dtype not in (torch.int32, torch.float32):
        raise RuntimeError("rowwise_select: int32 or f32 blocks")
    lib = load_library()
    b = blocks.view(torch.int32).contiguous()
    ix = idx.to(torch.int32).contiguous()
    require_cuda("rowwise_select", b, ix)
    n, k = ix.shape
    if b.shape != (n, 128) or k > 128:
        raise RuntimeError("rowwise_select: (N, 128) blocks and (N, K <= 128) indices")
    out = torch.empty((n, k), dtype=torch.int32, device=b.device)
    rc = lib.sspt_rowwise_select(b.data_ptr(), ix.data_ptr(), out.data_ptr(), n, k,
                                 stream_of(out))
    check(rc, "rowwise_select")
    LAUNCHES["rowwise_select"] += 1
    return out.view(blocks.dtype)
