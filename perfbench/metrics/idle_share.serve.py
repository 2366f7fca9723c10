"""Share of the profiled sub-window's wall time in which no operation ran
on the device: one minus the union of device operations' intervals over
the sub-window."""

LAYER = "device"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    if ctx.profile is None or ctx.profile["window_s"] <= 0:
        return None
    p = ctx.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
