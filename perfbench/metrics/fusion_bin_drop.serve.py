"""Share of the points eligible for a fusion bin (valid, inside the
grid) that a full bin turned away (`rank >= bin_capacity`), over the
four scales of the profiled frames: the device counters
`fusion.bin_dropped` over `fusion.bin_eligible`."""

from perfbench import program_trace

LAYER = "fusion layers"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    snap = program_trace.records(ctx)
    if snap is None:
        return None
    eligible = snap["counters"].get("fusion.bin_eligible")
    if not eligible:
        return None
    return 100.0 * snap["counters"].get("fusion.bin_dropped", 0.0) / eligible
