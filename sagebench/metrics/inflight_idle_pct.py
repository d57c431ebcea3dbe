"""Device (``inflight_idle_pct.<kind>``, each cell kind alike): share of the
traced window in which an invocation is between its arrival and its end
and nothing runs on the card, %."""
from harness import spans


def read(ctx):
    return spans.inflight_idle_pct(ctx)
