"""Kernel K1's least time on each launch (``csrc/schedule_pack.cu`` via
``ops/fused_schedule.schedule_pack``), frozen from the count that the
port's smoke run used.

Bytes: per lane 34 in (position and direction 12 each, dither and large
step 4 each, alive and back flags 1 each) and k x 12 + 4 out (the three
f32 slot rows and the candidate count), plus the minitile table once,
4 B a word. Operations: s_max march steps of 60 f32 operations a lane.
The bound is the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s (the H100 SXM's HBM rate and f32 rate outside the tensor
cores, at its 700 W limit). Only shapes enter, so it is taken on every
launch.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
STEP_OPS = 60
LANE_IN = 12 + 12 + 4 + 4 + 1 + 1
KERNEL = "schedule_pack_kernel"  # its device op's name holds this


def launch(args, kwargs) -> dict:
    """The shapes of one ``schedule_pack(ray_pos, ray_dir, dither,
    large_step, alive, is_back, mini_table, scalars, **params)`` call."""
    return {"lanes": int(args[0].shape[0]), "table_words": int(args[6].numel()),
            "k": int(kwargs["k"]), "s_max": int(kwargs["s_max"])}


def bound_s(shape: dict) -> float:
    n = shape["lanes"]
    nbytes = n * LANE_IN + n * (shape["k"] * 12 + 4) + shape["table_words"] * 4
    ops = n * shape["s_max"] * STEP_OPS
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
