"""The unfused hiz front half's table select (K2) and candidate pack (K3).

The counterpart of ``unitysspathtracingurp_tpu.ops.pallas_gather``'s
``broadcast_table_select`` and ``pack_by_slot``: ``broadcast_table_select``
wraps kernel K2 and ``pack_by_slot`` kernel K3 (``csrc/pallas_gather.cu``);
``*_ref`` are their plain PyTorch versions. They run on the diagnostic
march (``pathtrace_hiz.ray_march_hiz`` with ``_debug_out``), phases 2
and 3 of the unfused front half that K1 / K4 fuse; the JAX package
promises the two routes give the same packs.

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
    from ..kernels.build import LAUNCHES, check, load_library, require_cuda, stream_of

    lib = load_library()
    s, n = cand.shape
    c = cand.to(torch.uint8).contiguous()
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
