"""Host ms a served frame spends in `frame_to_example` and
`stack_examples` (host clock), mean over the window's frames."""

LAYER = "host data path"
UNIT = "ms"
MOVES = "frame_ms_p50"


def read(ctx):
    return ctx.host_ms_per("preprocess", "frames")
