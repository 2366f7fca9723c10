"""Host ms a served frame spends preparing its image (`preprocess.image`:
the compiled resize, letterbox and space-to-depth), mean over the
profiled frames."""

from perfbench import program_trace

LAYER = "host data path"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return program_trace.ms_per(ctx, "preprocess.image", "infer.forward")
