"""Device ms of each call of the step function that the loop builds
(CUDA events around it), mean over the window's steps."""

LAYER = "train step"
UNIT = "ms"
MOVES = "train_frames_per_s"


def read(ctx):
    return ctx.device_ms_per("step", "steps")
