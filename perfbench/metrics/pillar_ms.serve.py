"""Device ms of the pillar encoder (CUDA events on the entry and exit of
the detector's `pfn` module: pillarization, the canvas's zeroing, the
pillar feature net and its scatter), mean per served frame."""

LAYER = "pillar encoder"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return ctx.device_ms_per("pillar", "frames")
