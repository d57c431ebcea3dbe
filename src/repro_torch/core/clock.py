"""Clock abstraction: RealClock (threads) / VirtualClock (discrete-event).

Policy code takes a clock so the threaded runtime and the trace simulator
share one implementation of SAGE's decision logic.

``VirtualClock`` is a thin facade over the discrete-event engine in
:mod:`repro_torch.core.sim.kernel` — the event heap, typed event records, and
the past-time causality counter all live there; this class only pins the
legacy name and call signature (``now`` / ``schedule`` / ``schedule_at`` /
``run_until`` / ``empty``) that pre-kernel callers were built against.
"""
from __future__ import annotations

import time

from repro_torch.core.sim.kernel import EventKernel, EventKind


class RealClock:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock(EventKernel):
    """Event-queue virtual time, single-threaded (driven by the simulator).

    Inherits the whole kernel: ``schedule(dt, fn, *args)`` /
    ``schedule_at(t, fn, *args)`` post typed events, ``run_until`` fires
    them in ``(t, seq)`` order, ``events_processed`` / ``kind_counts`` /
    ``past_events`` expose the engine counters (docs/simulator.md).
    """

    __slots__ = ()


__all__ = ["RealClock", "VirtualClock", "EventKind"]
