"""Model (``compute_ms.<kind>``, each cell kind alike): mean time of the
forward in the function's handler over the window's invocations, ms
(``readers.compute_ms``)."""
from harness import readers


def read(ctx):
    return readers.compute_ms(ctx)
