"""Share of its roofline that pillarization reaches: the bytes of
`pillarize_bytes` in `families/pointpillars.py` (the mask, the masked
points, every output table whole) at 3.35 TB/s, over the device time
that the profiled sub-window attributes to the op's range."""

from perfbench.flops import H100_HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile["range_s"].get("pillarize")
    if not s:
        return None
    return 100.0 * ctx.ranges.total_bytes("pillarize") \
        / H100_HBM_BYTES_PER_S / s
