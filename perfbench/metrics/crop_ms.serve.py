"""Host ms a served frame spends cropping and padding its sweep
(`preprocess.crop`, the program's span), mean over the profiled frames."""

from perfbench import program_trace

LAYER = "host data path"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return program_trace.ms_per(ctx, "preprocess.crop", "infer.forward")
