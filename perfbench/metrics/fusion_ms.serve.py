"""Device ms of the four continuous-fusion layers (CUDA events around
each `fusion_s*` module), mean per served frame."""

LAYER = "fusion layers"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return ctx.device_ms_per("fusion", "frames")
