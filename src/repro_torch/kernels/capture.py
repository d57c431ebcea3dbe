"""The hand-written kernels' launches where a CUDA graph captures them.

A wrapper called inside a CUDA graph's capture launches nothing: its
kernels become nodes of the graph and run at each replay. So a wrapper
counts such a call here and not in its ``launches``: ``tally()`` gathers,
by kernel name, the captured calls this thread makes inside it, and
whoever replays the graph adds that tally to each kernel's ``launches``
after every replay (``flash_attention.add_launches``,
``ssd_scan.add_launches``). A captured call outside a ``tally()`` is
counted nowhere.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter

_tallies = threading.local()  # a capture runs on the thread that issues it


@contextlib.contextmanager
def tally():
    """Gather this thread's captured kernel calls meanwhile, by kernel
    name, into the Counter it yields."""
    outer = getattr(_tallies, "counts", None)
    _tallies.counts = counts = Counter()
    try:
        yield counts
    finally:
        _tallies.counts = outer


def captured(name: str) -> None:
    """A call of kernel ``name`` was captured into a CUDA graph."""
    counts = getattr(_tallies, "counts", None)
    if counts is not None:
        counts[name] += 1
