"""Read the program's own spans and copy counters over one run of a cell,
on the device trace's clock.

    python3 sagebench/tools/spans.py --workload <cell> --seed <n> --seconds 51 --trace 1

The program (``repro_torch``) records, for each invocation, spans keyed by
its request id (``Telemetry.spans_of``: ``lock_wait``, ``ctx_build``,
``data_wait``, ``forward``) and, on its database, the bytes and host
seconds of every host -> device copy (``Database.h2d_bytes``, ``h2d_s``).
The harness does not keep them yet. This tool runs the cell as ``run.py``
does (``runner.run_cell``, without the check of the answers) and keeps them
beside what the runner keeps, without changing what it measures: the
spans of every node's invocations (fresh nodes' too, where the runner
keeps their records), the database's counters at the window's start and
end, and, traced, the card's idle intervals in the window (from the
profiler's events, as ``trace.summarize`` reads them). Spans are put on
the window's clock through the runner's arrival stamps, whose window
start is the instant the window's ``record_function`` range opens.

One JSON line: the readings (``lock_wait_ms``: the mean summed
``lock_wait`` of an invocation; ``issue_ms``: the mean ``forward`` span;
``h2d_gbps``: the window's copied bytes over their host seconds;
``inflight_idle_pct``: the share of the window in which an invocation is
between its arrival and its end and the card is idle), ``idle_by_span``
(the window's idle seconds, each under the program span open then, over
all invocations, else ``in_flight`` or ``no_invocation``), the
cell's metrics as ``run.py`` reads them, and the cost of one span on this
host (``span_cost``)."""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "sagebench"), str(ROOT / "src")]

Interval = Tuple[float, float]
Span = Tuple[str, float, float]
IN_FLIGHT, NONE = "in_flight", "no_invocation"


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


def device_idle(prof) -> Optional[Tuple[List[Interval], float]]:
    """The card's idle intervals in the traced window, in seconds from the
    window's start, and the window's length (``trace.summarize``'s reading
    of the events); None where the trace holds no window."""
    from harness import trace

    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == trace.WINDOW and not trace._on_card(e)]
    if not win:
        return None
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.start_ns() + e.duration_ns() for e in win)
    busy = [((e.start_ns() - w0) / 1e9, (e.start_ns() + e.duration_ns() - w0) / 1e9)
            for e in events if trace._on_device(e)
            and e.start_ns() < w1 and e.start_ns() + e.duration_ns() > w0]
    window_s = (w1 - w0) / 1e9
    return gaps(busy, 0.0, window_s), window_s


class Kept:
    """What the tool keeps of one run beside the runner: each record and
    its spans by request id, the database, its counters at the window's
    start, and the traced window's idle intervals."""

    def __init__(self):
        self.records: Dict[str, tuple] = {}
        self.db = None
        self.h2d0: Optional[Tuple[int, float]] = None
        self.idle: Optional[Tuple[List[Interval], float]] = None


def h2d(db) -> Optional[Tuple[int, float]]:
    """The database's (``h2d_bytes``, ``h2d_s``), or None where the program
    counts no copies."""
    if db is None or not hasattr(db, "h2d_bytes"):
        return None
    return db.h2d_bytes, db.h2d_s


@contextlib.contextmanager
def keeping():
    """Hooks on the runner for the ``with`` block (taken off after it)."""
    from harness import runner, trace

    kept = Kept()
    keep_records, setup, summarize = runner.Program.keep_records, runner.setup, trace.summarize

    def keep_records_too(prog, rt):
        keep_records(prog, rt)
        spans_of = getattr(rt.telemetry, "spans_of", None)
        for rec in rt.telemetry.snapshot():
            kept.records[rec.request_id] = (rec, spans_of(rec.request_id) if spans_of else None)

    def setup_too(*args, **kwargs):
        out = setup(*args, **kwargs)
        kept.db = out[0].db
        kept.h2d0 = h2d(kept.db)  # nothing is copied from here to the window's start
        return out

    def summarize_too(prof, *args, **kwargs):
        kept.idle = device_idle(prof)
        return summarize(prof, *args, **kwargs)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(runner.Program, "keep_records", keep_records_too))
        stack.enter_context(mock.patch.object(runner, "setup", setup_too))
        stack.enter_context(mock.patch.object(trace, "summarize", summarize_too))
        yield kept


def readings(context: dict, invocations: list, kept: Kept) -> dict:
    """The readings of one run (``runner.run_cell``'s context and
    invocations, and what ``keeping`` kept over it)."""
    spans: List[Span] = []
    inflight: List[Interval] = []
    lock_waits, forwards, counts = [], [], []
    builds = warm_none = 0
    for inv, seen in zip(invocations, context["invocations"]):
        rec, own = kept.records.get(inv.uuid, (None, None))
        if rec is None or own is None or "arrival" not in seen:
            continue
        t0 = rec.arrival_t - seen["arrival"]  # the window's start on the host's clock
        own = [(n, a - t0, b - t0) for n, a, b in own]
        spans += own
        inflight.append((seen["arrival"], seen["end"]))
        counts.append(len(own))
        lock_waits.append(sum(b - a for n, a, b in own if n == "lock_wait"))
        forwards += [b - a for n, a, b in own if n == "forward"]
        builds += any(n == "ctx_build" for n, _, _ in own)
        warm_none += rec.warm_stage is None
    out = {"invocations_with_spans": len(counts),
           "spans_per_invocation": statistics.fmean(counts) if counts else None,
           "ctx_builds": builds, "warm_stage_none": warm_none,
           "lock_wait_ms": statistics.fmean(lock_waits) * 1e3 if lock_waits else None,
           "issue_ms": statistics.fmean(forwards) * 1e3 if forwards else None,
           "h2d_gbps": None, "h2d_bytes": None, "inflight_idle_pct": None,
           "idle_by_span": None}
    end = h2d(kept.db)
    if kept.h2d0 is not None and end is not None and end[1] > kept.h2d0[1]:
        nbytes, secs = end[0] - kept.h2d0[0], end[1] - kept.h2d0[1]
        out.update(h2d_gbps=nbytes / secs / 1e9, h2d_bytes=nbytes)
    if kept.idle is not None and counts:
        idle, traced_s = kept.idle
        by = idle_by_span(idle, spans, inflight, traced_s)
        out["idle_by_span"] = by
        out["inflight_idle_pct"] = 100.0 * sum(v for k, v in by.items() if k != NONE) / traced_s
    return out


def span_cost(n: int = 200_000) -> dict:
    """Host ns of one ``with span(...)``, inside an invocation and outside."""
    from repro_torch.core.telemetry import Telemetry, span

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with span("x"):
                pass
        return (time.perf_counter() - t) / n * 1e9

    outside = loop()
    with Telemetry().recording("cost"):
        inside = loop()
    return {"ns_per_span": inside, "ns_outside_an_invocation": outside}


def collect(config: dict, mix: dict, *, seed: int, seconds: float, trace: bool, device: str,
            reference, log=lambda obj: None) -> dict:
    """One run of the cell with the program's spans and counters kept."""
    from harness import runner

    with keeping() as kept:
        run = runner.run_cell(config, mix, seed=seed, seconds=seconds, trace=trace,
                              device=device, log=log, reference=reference)
    out = readings(run["context"], run["invocations"], kept)
    kept.db = None
    return {"readings": out, "context": run["context"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()

    import torch
    from harness import manifest, traffic

    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    mix = traffic.validate(manifest.mix(cell["traffic"]))
    cost = span_cost()
    got = collect(manifest.config(cell["config"]), mix, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device="cuda",
                  reference=manifest.reference(cell["config"]))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = manifest.read_all(manifest.metrics_of(bench, cell["name"], kind), got["context"])
    print(json.dumps({"workload": args.workload, "seed": args.seed, "trace": args.trace,
                      "card": torch.cuda.get_device_name(0), "span_cost": cost,
                      **got["readings"],
                      "metrics": {k: v["value"] for k, v in metrics.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
