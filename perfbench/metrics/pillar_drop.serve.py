"""Share of the points in the ROI that pillarization dropped (a pillar
beyond the cap P, or a full pillar of N points), over the profiled
frames: the device counters `pillars.points_dropped` over
`pillars.points_in_roi`."""

from perfbench import program_trace

LAYER = "pillar encoder"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    snap = program_trace.records(ctx)
    if snap is None:
        return None
    in_roi = snap["counters"].get("pillars.points_in_roi")
    if not in_roi:
        return None
    return 100.0 * snap["counters"].get("pillars.points_dropped", 0.0) \
        / in_roi
