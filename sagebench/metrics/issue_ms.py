"""Model (``issue_ms.<kind>``, each cell kind alike): mean of the program
span ``forward`` over the window's invocations (the host issuing the
forward: a CUDA graph's replay, or each launch of an eager forward), ms."""
from harness import spans


def read(ctx):
    return spans.issue_ms(ctx)
