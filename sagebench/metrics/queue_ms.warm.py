"""Runtime: mean time from the runtime's arrival stamp to the start of
the function's handler (a pool thread, then the node's compute lock), ms."""
from harness import readers


def read(ctx):
    return readers.mean_of([(v["handler"][0] - v["arrival"]) * 1e3
                            for v in readers.window(ctx) if "handler" in v and "arrival" in v])
