"""95th percentile over every invocation due in the window, each timed
from when the open schedule made it due to its answer, in ms."""
from harness import readers


def read(ctx):
    return readers.e2e_quantile_ms(ctx, 0.95)
