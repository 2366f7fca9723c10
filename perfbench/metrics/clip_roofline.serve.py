"""Share of its roofline that the rotated-box clip of decode and NMS
reaches: two [N, 5] float32 inputs and an [N] float32 output at
3.35 TB/s (its operations need less), over the device time that the
profiled sub-window attributes to the op's range."""

from perfbench.flops import H100_HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile["range_s"].get("clip")
    if not s:
        return None
    return 100.0 * ctx.ranges.total_bytes("clip") / H100_HBM_BYTES_PER_S / s
