"""Seconds from the process's start to the window's: imports, the card's set-up,
the weights made and page-locked, the kernels built or loaded, the set-up's
cold invocation and warm-ups."""


def read(ctx):
    return ctx["setup_s"]
