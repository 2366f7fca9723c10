"""Share of its roofline that the fusion forward and backward reach when
training: the least time their work needs (the bytes of `_fwd_bytes` and
`_bwd_bytes` in `families/contfuse.py` at 3.35 TB/s) over the device
time that the profiled sub-window attributes to both ops' ranges."""

from perfbench.flops import H100_HBM_BYTES_PER_S

LAYER = "kernels"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(ctx):
    if ctx.profile is None:
        return None
    s = sum(ctx.profile["range_s"].get(n, 0.0)
            for n in ("fusion_fwd", "fusion_bwd"))
    if not s:
        return None
    n_bytes = sum(ctx.ranges.total_bytes(n)
                  for n in ("fusion_fwd", "fusion_bwd"))
    return 100.0 * n_bytes / H100_HBM_BYTES_PER_S / s
