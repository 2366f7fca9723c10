"""Model FLOPs of the frames served in the profiled sub-window (the
frozen `inference_flops_per_frame`) per second, over the bf16 peak of
989 TFLOP/s."""

from perfbench import flops

LAYER = "whole step"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    p = ctx.profile
    if p is None or not p["frames"]:
        return None
    per_frame = flops.inference_flops_per_frame(ctx.cfg)["total"]
    return 100.0 * per_frame * p["frames"] / p["window_s"] \
        / flops.H100_PEAK_BF16_FLOPS
