"""Memory daemon (``h2d_gbps.<kind>``, each cell kind alike): the bytes the
program's database copied host -> device in the window over the host
seconds of those copies (counters ``h2d_bytes``, ``h2d_s``), GB/s."""
from harness import spans


def read(ctx):
    return spans.h2d_gbps(ctx)
