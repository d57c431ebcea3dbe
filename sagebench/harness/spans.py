"""The program's own spans and counters as a run keeps them, and the
interval arithmetic that reads them against the device trace.

The program (``repro_torch``) records, for each invocation, spans keyed by
its request id (``Telemetry.spans_of``: ``lock_wait``, ``ctx_build``,
``data_wait``, ``forward``), and counters: on its database the bytes and
host seconds of every host -> device copy (``Database.h2d_bytes``,
``h2d_s``); by function the forwards that replayed a CUDA graph, captured
one or ran eagerly (``core.functions.graph_replays``, ``graph_captures``,
``eager_forwards``). The runner keeps each invocation's spans in its
record on the window's clock (``spans``: (name, start, end) in seconds
from the window's start) and the counters' changes over the window
(the context's ``counters``); a program without them leaves them out, and
every reading here is then None. A traced run's ``trace`` holds the card's
idle intervals in window seconds (``idle``)."""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]
Span = Tuple[str, float, float]
IN_FLIGHT, NONE = "in_flight", "no_invocation"
FORWARDS = ("graph_replays", "graph_captures", "eager_forwards")


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """What ``[lo, hi]`` holds outside the union of ``busy``."""
    out, at = [], lo
    for a, b in merged(busy):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def covered_before(idle: Sequence[Interval], xs: Sequence[float]) -> np.ndarray:
    """For each x, the seconds of the sorted, disjoint ``idle`` below x."""
    xs = np.asarray(xs, dtype=np.float64)
    if not idle:
        return np.zeros_like(xs)
    s = np.array([a for a, _ in idle])
    length = np.array([b for _, b in idle]) - s
    cum = np.concatenate([[0.0], np.cumsum(length)])
    i = np.searchsorted(s, xs, side="right")  # idle[:i] start at or before x
    last = np.maximum(i - 1, 0)
    part = np.where(i > 0, np.clip(xs - s[last], 0.0, length[last]), 0.0)
    return cum[last] + part


def idle_by_span(idle: Sequence[Interval], spans: Sequence[Span],
                 inflight: Sequence[Interval], window_s: float) -> Dict[str, float]:
    """The idle seconds of ``[0, window_s]``, each under one label: the name
    of the program span open at that instant, over all invocations (the
    latest to start; a ``lock_wait`` only where no other span is open,
    since the card then waits for the lock's holder); else ``in_flight``
    where an invocation is between its arrival and its end; else
    ``no_invocation``. ``idle`` is sorted and disjoint."""
    def clip(a, b):
        return max(a, 0.0), min(b, window_s)

    opens, closes = defaultdict(list), defaultdict(list)
    points = {0.0, window_s}
    for k, (name, a, b) in enumerate(spans):
        a, b = clip(a, b)
        if b > a:
            opens[a].append((k, a, name))
            closes[b].append(k)
            points.update((a, b))
    flight_opens, flight_closes = defaultdict(int), defaultdict(int)
    for a, b in inflight:
        a, b = clip(a, b)
        if b > a:
            flight_opens[a] += 1
            flight_closes[b] += 1
            points.update((a, b))
    xs = sorted(points)
    below = covered_before(idle, xs)
    out: Dict[str, float] = defaultdict(float)
    active: Dict[int, Tuple[bool, float, str]] = {}
    flying = 0
    for j, p in enumerate(xs[:-1]):
        for k in closes[p]:
            active.pop(k, None)
        for k, a, name in opens[p]:
            active[k] = (name != "lock_wait", a, name)
        flying += flight_opens[p] - flight_closes[p]
        if active:
            label = max(active.values())[2]
        else:
            label = IN_FLIGHT if flying > 0 else NONE
        out[label] += float(below[j + 1] - below[j])
    return {k: v for k, v in sorted(out.items(), key=lambda kv: -kv[1]) if v > 0}


# --- readings of a run's context (``runner.run_cell``)

def with_spans(ctx: dict) -> List[dict]:
    """The window's invocations whose record holds the program's spans."""
    return [v for v in ctx["invocations"] if "spans" in v]


def lock_wait_ms(ctx: dict) -> Optional[float]:
    """Mean over the invocations with spans of each one's summed
    ``lock_wait`` spans, ms."""
    waits = [sum(b - a for n, a, b in v["spans"] if n == "lock_wait") for v in with_spans(ctx)]
    return statistics.fmean(waits) * 1e3 if waits else None


def issue_ms(ctx: dict) -> Optional[float]:
    """Mean ``forward`` span (the host issuing the forward), ms."""
    fwd = [b - a for v in with_spans(ctx) for n, a, b in v["spans"] if n == "forward"]
    return statistics.fmean(fwd) * 1e3 if fwd else None


def h2d_gbps(ctx: dict) -> Optional[float]:
    """The window's host -> device bytes over their host seconds, GB/s."""
    c = ctx.get("counters") or {}
    if c.get("h2d_s", 0) <= 0 or "h2d_bytes" not in c:
        return None
    return c["h2d_bytes"] / c["h2d_s"] / 1e9


def graph_replay_pct(ctx: dict) -> Optional[float]:
    """The window's forwards that replayed a CUDA graph over all its
    forwards (replayed, captured, eager), %."""
    c = ctx.get("counters") or {}
    if not all(k in c for k in FORWARDS):
        return None
    total = sum(c[k] for k in FORWARDS)
    return 100.0 * c["graph_replays"] / total if total > 0 else None


def idle_by_span_of(ctx: dict) -> Optional[Dict[str, float]]:
    """``idle_by_span`` of a traced run, over the invocations with spans."""
    t, invs = ctx.get("trace"), with_spans(ctx)
    if not t or "idle" not in t or not invs:
        return None
    return idle_by_span(t["idle"], [s for v in invs for s in v["spans"]],
                        [(v["arrival"], v["end"]) for v in invs], t["window_s"])


def inflight_idle_pct(ctx: dict) -> Optional[float]:
    """The share of the traced window in which an invocation is between
    its arrival and its end and the card is idle, %."""
    by = idle_by_span_of(ctx)
    if by is None:
        return None
    return 100.0 * sum(v for k, v in by.items() if k != NONE) / ctx["trace"]["window_s"]
