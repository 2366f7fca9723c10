"""Model FLOPs of the frames served in the profiled sub-window (the model
family's frozen count of a served frame) per second, over the bf16 peak
of 989 TFLOP/s."""

from perfbench import flops

LAYER = "whole step"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    p = ctx.profile
    if p is None or not p["frames"]:
        return None
    return 100.0 * ctx.flops_per_frame() * p["frames"] / p["window_s"] \
        / flops.H100_PEAK_BF16_FLOPS
