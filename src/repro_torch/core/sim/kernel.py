"""Engine layer: a lean discrete-event kernel.

The kernel is framework-like — events, a heap, virtual time — and knows
nothing about GPUs or serving. Domain code registers work by posting
:class:`Event` records; the kernel fires them in ``(t, seq)`` order.

Design constraints (docs/simulator.md):

* **Typed event records, C-speed ordering.** :class:`Event` is a tuple
  subclass ``(t, seq, kind, fn, args)``: the heap compares events with the
  C tuple comparator (``t`` then the unique ``seq`` — comparison never
  reaches the callable), while call sites still get named accessors and a
  ``kind`` taxonomy for profiling.
* **Allocation-light.** One object per event, no closure chains: handlers
  are bound methods on slotted state machines and positional ``args`` ride
  the event record itself.
* **Causality is loud.** ``schedule_at`` with a timestamp in the past
  still clamps to *now* (the pre-kernel ``VirtualClock`` behavior, which
  seeded traces depend on) but now counts the violation in
  ``past_events`` and warns once — a new handler that schedules into the
  past surfaces in tests instead of silently reordering history.
"""
from __future__ import annotations

import warnings
from enum import IntEnum
from heapq import heappop, heappush
from typing import Callable, Tuple

__all__ = ["Event", "EventKind", "EventKernel"]

_INF = float("inf")


class EventKind(IntEnum):
    """Event taxonomy (docs/simulator.md). Purely informational: the kernel
    orders by time, never by kind. ``CALL`` is the generic bucket the
    :class:`~repro_torch.core.clock.VirtualClock` facade posts into."""

    CALL = 0        # generic scheduled callback (legacy facade)
    ARRIVAL = 1     # a workload arrival entering the system
    FEED = 2        # trace-feeder refill (streaming replay)
    TRANSFER = 3    # bandwidth-broker stream completion
    ADMISSION = 4   # memory-admission grant / expiry timer
    COMPUTE = 5     # compute (kernel-execution) completion
    TIMER = 6       # exit-ladder and other domain timers
    FAULT = 7       # injected fault (crash/restart/degrade/flap)


class Event(tuple):
    """One scheduled event: ``(t, seq, kind, fn, args)``.

    A tuple subclass so heap sift comparisons run in C — ``seq`` is unique
    per kernel, so ordering is decided before the non-comparable ``fn``
    field is ever reached.
    """

    __slots__ = ()

    def __new__(cls, t: float, seq: int, kind: int, fn: Callable,
                args: Tuple = ()):
        return tuple.__new__(cls, (t, seq, kind, fn, args))

    @property
    def t(self) -> float:
        return self[0]

    @property
    def seq(self) -> int:
        return self[1]

    @property
    def kind(self) -> int:
        return self[2]

    @property
    def fn(self) -> Callable:
        return self[3]

    @property
    def args(self) -> Tuple:
        return self[4]

    def __repr__(self) -> str:  # debugging aid, not a hot path
        kind = EventKind(self[2]).name if self[2] in EventKind._value2member_map_ \
            else self[2]
        return f"Event(t={self[0]:.6f}, seq={self[1]}, kind={kind}, fn={self[3]!r})"


class EventKernel:
    """Heap-scheduled virtual time. Single-threaded; the domain drives it.

    Counters (all plain ints, safe to read any time):

    * ``events_processed`` — events fired since construction.
    * ``kind_counts[k]`` — events fired per :class:`EventKind` value.
    * ``past_events`` — ``schedule_at`` calls that targeted the past and
      were clamped to *now* (each one is a latent causality bug in a
      handler; the first occurrence warns).
    """

    __slots__ = ("_t", "_q", "_seq", "events_processed", "kind_counts",
                 "past_events")

    def __init__(self):
        self._t = 0.0
        self._q: list = []
        self._seq = 0
        self.events_processed = 0
        self.kind_counts = [0] * (max(EventKind) + 1)
        self.past_events = 0

    # ------------------------------------------------------------------
    def now(self) -> float:
        return self._t

    def empty(self) -> bool:
        return not self._q

    @property
    def queued(self) -> int:
        """Events currently on the heap. (Deliberately a property, not
        ``__len__``: several call sites truth-test clocks — ``clock or
        RealClock()`` — and an empty kernel must stay truthy.)"""
        return len(self._q)

    # ------------------------------------------------------------------
    def schedule(self, dt: float, fn: Callable, *args,
                 kind: int = EventKind.CALL) -> None:
        """Post ``fn(*args)`` at ``now + dt`` (negative ``dt`` clamps to
        now, matching the pre-kernel clock)."""
        self._seq += 1
        # tuple.__new__ directly: skips the Python-level Event.__new__
        # frame on the hottest allocation in the simulator
        heappush(self._q,
                 tuple.__new__(Event, (self._t + (dt if dt > 0.0 else 0.0),
                                       self._seq, kind, fn, args)))

    def schedule_at(self, t: float, fn: Callable, *args,
                    kind: int = EventKind.CALL) -> None:
        """Post ``fn(*args)`` at absolute time ``t``. A ``t`` in the past
        clamps to *now* — counted in ``past_events`` and warned once, so
        causality bugs in new handlers surface in tests instead of being
        silently reordered."""
        if t < self._t:
            self.past_events += 1
            if self.past_events == 1:
                warnings.warn(
                    f"schedule_at(t={t!r}) is in the past (now={self._t!r}); "
                    "clamping to now. Further occurrences are counted in "
                    "EventKernel.past_events without warning.",
                    RuntimeWarning, stacklevel=3)
            t = self._t
        self._seq += 1
        heappush(self._q, tuple.__new__(Event, (t, self._seq, kind, fn, args)))

    # ------------------------------------------------------------------
    def run_until(self, t_end: float = _INF) -> int:
        """Fire events in ``(t, seq)`` order up to and including ``t_end``;
        returns the number fired. With a finite ``t_end`` the clock lands
        exactly on ``t_end`` afterwards (idle time is skipped)."""
        q = self._q
        counts = self.kind_counts
        fired = 0
        while q and q[0][0] <= t_end:
            ev = heappop(q)
            self._t = ev[0]
            counts[ev[2]] += 1
            fn, args = ev[3], ev[4]
            if args:
                fn(*args)
            else:
                fn()
            fired += 1
        self.events_processed += fired
        if t_end != _INF and t_end > self._t:
            self._t = t_end
        return fired
