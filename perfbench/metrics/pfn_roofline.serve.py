"""Share of its roofline that the pillar feature net with its scatter
reaches: the bytes of `pfn_bytes` in `families/pointpillars.py` (each
kept point and its slot's index once, the per-pillar counts, masks and
coords, the weights, the kept pillars' canvas rows written once) at
3.35 TB/s, over the device time that the profiled sub-window attributes
to the op's range; its operations (9 multiplies and adds a point and
channel in float32) need less."""

from perfbench.flops import H100_HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile["range_s"].get("pfn")
    if not s:
        return None
    return 100.0 * ctx.ranges.total_bytes("pfn") / H100_HBM_BYTES_PER_S / s
