"""Device ms of `decode_and_nms` (CUDA events around it), mean per
served frame."""

LAYER = "decode and NMS"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return ctx.device_ms_per("decode_nms", "frames")
