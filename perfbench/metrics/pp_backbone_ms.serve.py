"""Device ms of the pillar network's backbone (CUDA events on the entry
and exit of the detector's `backbone` module: the three blocks, the
three upsamplings and their concatenation), mean per served frame."""

LAYER = "pillar backbone"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return ctx.device_ms_per("pp_backbone", "frames")
