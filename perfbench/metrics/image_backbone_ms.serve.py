"""Device ms of the image backbone (CUDA events on the module's entry and
exit), mean per served frame."""

LAYER = "image backbone"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return ctx.device_ms_per("image_backbone", "frames")
