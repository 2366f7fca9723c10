"""Share of its roofline that the fusion forward reaches when serving:
the least time its work needs (the bytes of `_fusion_bytes` in
`families/contfuse.py` at 3.35 TB/s, counted from each call's inputs;
its operations need less) over the device time that the profiled
sub-window attributes to the op's range."""

from perfbench.flops import H100_HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile["range_s"].get("fusion_fwd")
    if not s:
        return None
    return 100.0 * ctx.ranges.total_bytes("fusion_fwd") \
        / H100_HBM_BYTES_PER_S / s
