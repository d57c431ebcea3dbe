"""Device (``device_idle_pct.<kind>``, each cell kind alike): share of the
traced window in which nothing ran on the card, %."""
from harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
