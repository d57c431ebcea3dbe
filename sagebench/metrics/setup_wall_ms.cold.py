"""Engine: mean ``setup_wall`` of the window's cold invocations (the
parallel set-up span: the context build beside the weights' copy), ms."""
from harness import readers


def read(ctx):
    return readers.mean_of([v["setup_wall"] * 1e3 for v in readers.window(ctx)
                            if "setup_wall" in v])
