"""Invocations answered within the window over the window's seconds."""
from harness import readers


def read(ctx):
    return len(readers.completed_in_window(ctx)) / ctx["seconds"]
