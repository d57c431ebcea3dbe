"""Engine: mean ``gpu_ctx`` stage of the window's cold invocations (the
context build: kernel libraries and the warm-up forward), ms."""
from harness import readers


def read(ctx):
    return readers.stage_ms(ctx, "gpu_ctx")
