"""Memory daemon: shared read-only hits over the window's invocations, %."""
from harness import readers


def read(ctx):
    n = len(readers.window(ctx))
    return 100.0 * ctx["stats"].get("shared_hits", 0) / n if n else None
