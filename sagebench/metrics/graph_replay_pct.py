"""Model (``graph_replay_pct.<kind>``, each cell kind alike): the window's
forwards that replayed a CUDA graph over all of them, replayed, captured or
eager (counters ``graph_replays``, ``graph_captures``, ``eager_forwards``
summed over the functions), %."""
from harness import spans


def read(ctx):
    return spans.graph_replay_pct(ctx)
