"""Memory daemon: mean ``gpu_data`` stage of the window's cold
invocations (the wait for the weights' copy not hidden by the build), ms."""
from harness import readers


def read(ctx):
    return readers.stage_ms(ctx, "gpu_data")
