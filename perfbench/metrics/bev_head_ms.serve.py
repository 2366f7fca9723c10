"""Device ms of the raster, BEV stages, FPN and head: the detector's
forward (CUDA events on its entry and exit) less its image backbone and
fusion layers, mean per served frame."""

LAYER = "raster, BEV stages, FPN and head"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    total = ctx.device_ms_per("forward", "frames")
    if total is None:
        return None
    for part in ("image_backbone", "fusion"):
        total -= ctx.device_ms_per(part, "frames") or 0.0
    return total
