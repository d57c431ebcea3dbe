"""Whole step (``mfu_pct.<kind>``, each cell kind alike): model FLOPs served
in the window over the window times the bf16 peak, % (``readers.mfu_pct``;
the card's power limit is printed beside)."""
from harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
