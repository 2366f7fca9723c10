"""Host ms a training step's loop blocks on its next batch (a wrapper on
the loop's batch iterator), mean over the window's steps."""

LAYER = "host data path"
UNIT = "ms"
MOVES = "train_frames_per_s"


def read(ctx):
    s = ctx.spans["host_s"].get("loader_wait")
    return None if s is None else sum(s) * 1e3 / ctx.spans["steps"]
