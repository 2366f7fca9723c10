"""Share of the profiled frames whose forward was served by CUDA-graph
replay (the program's counter `graph.forwards` over its `infer.forward`
spans), in %. None where the program has no graphed forward
(`dcf_torch.utils.graphs`); 0 where it has one and the cell's detector
bypasses it."""

import importlib.util

from perfbench import program_trace

LAYER = "host dispatch"
UNIT = "%"
MOVES = "frame_ms_p50"


def read(ctx):
    if importlib.util.find_spec("dcf_torch.utils.graphs") is None:
        return None
    share = program_trace.count_per(ctx, "graph.forwards", "infer.forward")
    return None if share is None else 100.0 * share
