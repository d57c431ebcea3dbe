"""Runtime (``lock_wait_ms.<kind>``, each cell kind alike): mean over the
window's invocations of the time each waited for the node's compute lock
or the shared compute plane (the sum of its program spans ``lock_wait``),
ms."""
from harness import spans


def read(ctx):
    return spans.lock_wait_ms(ctx)
