"""Model FLOPs of the frames trained in the profiled sub-window (the model
family's frozen count of a trained frame) per second, over the bf16 peak
of 989 TFLOP/s."""

from perfbench import flops

LAYER = "whole step"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(ctx):
    p = ctx.profile
    if p is None or not p["frames"]:
        return None
    return 100.0 * ctx.flops_per_frame() * p["frames"] / p["window_s"] \
        / flops.H100_PEAK_BF16_FLOPS
