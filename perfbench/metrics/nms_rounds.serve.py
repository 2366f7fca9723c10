"""Rounds of `rotated_nms_parallel` a served frame takes (the counter
`nms.rounds`: rounds that found a live box), over the profiled frames.
Each round costs one host sync."""

from perfbench import program_trace

LAYER = "decode and NMS"
UNIT = "rounds"
MOVES = "frame_ms_p50"


def read(ctx):
    return program_trace.count_per(ctx, "nms.rounds", "infer.forward")
