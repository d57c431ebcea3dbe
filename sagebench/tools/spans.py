"""Read the program's own spans and copy counters over one run of a cell,
on the device trace's clock, beside what the harness reads of them.

    python3 sagebench/tools/spans.py --workload <cell> --seed <n> --seconds 51 --trace 1

The program (``repro_torch``) records, for each invocation, spans keyed by
its request id (``Telemetry.spans_of``: ``lock_wait``, ``ctx_build``,
``data_wait``, ``forward``) and, on its database, the bytes and host
seconds of every host -> device copy (``Database.h2d_bytes``, ``h2d_s``),
and by function its forwards replayed, captured and eager
(``core.functions.graph_replays``, ``graph_captures``, ``eager_forwards``).
The runner keeps them too (``harness/spans.py``). This tool runs the cell
as ``run.py`` does (``runner.run_cell``, without the check of the answers)
and keeps them a second way, by hooks on the runner that change nothing it
measures: the spans of every node's invocations (fresh nodes' too, where
the runner keeps their records), the counters at the end of set-up and
after the run, and, traced, the card's idle intervals in the
window (``trace.summarize``'s). Spans are put on the window's clock through
the runner's arrival stamps. The readings are ``harness/spans.py``'s
arithmetic on what the hooks kept, so on one run they equal the per-layer
metrics the harness reads from its own records (printed beside them).

One JSON line: the readings (``lock_wait_ms``: the mean summed
``lock_wait`` of an invocation; ``issue_ms``: the mean ``forward`` span;
``h2d_gbps``: the window's copied bytes over their host seconds;
``inflight_idle_pct``: the share of the window in which an invocation is
between its arrival and its end and the card is idle; ``graph_replay_pct``:
the forwards replayed over all of them), ``idle_by_span``
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
from pathlib import Path
from typing import Dict, List, Optional, Tuple
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "sagebench"), str(ROOT / "src")]

from harness import spans  # noqa: E402

Interval = spans.Interval


class Kept:
    """What the tool keeps of one run beside the runner: each record and
    its spans by request id, the program's counters (``Program.counters``)
    at the end of set-up and after the run, and the traced window's idle
    intervals."""

    def __init__(self):
        self.records: Dict[str, tuple] = {}
        self.prog = None
        self.counters0: Dict[str, float] = {}
        self.counters1: Dict[str, float] = {}
        self.idle: Optional[Tuple[List[Interval], float]] = None


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
        kept.prog = out[0]
        kept.counters0 = kept.prog.counters()  # nothing moves from here to the window's start
        return out

    def summarize_too(prof, *args, **kwargs):
        out = summarize(prof, *args, **kwargs)
        kept.idle = None if out is None else (out["idle"], out["window_s"])
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(runner.Program, "keep_records", keep_records_too))
        stack.enter_context(mock.patch.object(runner, "setup", setup_too))
        stack.enter_context(mock.patch.object(trace, "summarize", summarize_too))
        yield kept
        kept.counters1 = kept.prog.counters() if kept.prog is not None else {}
        kept.prog = None


def readings(context: dict, invocations: list, kept: Kept) -> dict:
    """The readings of one run (``runner.run_cell``'s context and
    invocations, and what ``keeping`` kept over it)."""
    own: List[dict] = []
    builds = warm_none = 0
    for inv, seen in zip(invocations, context["invocations"]):
        rec, recorded = kept.records.get(inv.uuid, (None, None))
        if rec is None or recorded is None or "arrival" not in seen:
            continue
        t0 = rec.arrival_t - seen["arrival"]  # the window's start on the host's clock
        on_window = [(n, a - t0, b - t0) for n, a, b in recorded]
        own.append({"arrival": seen["arrival"], "end": seen["end"], "spans": on_window})
        builds += any(n == "ctx_build" for n, _, _ in on_window)
        warm_none += rec.warm_stage is None
    counters = {k: v - kept.counters0[k] for k, v in kept.counters1.items()
                if k in kept.counters0}
    kept_ctx = {"invocations": own, "counters": counters,
                "trace": None if kept.idle is None else {"idle": kept.idle[0],
                                                         "window_s": kept.idle[1]}}
    gbps = spans.h2d_gbps(kept_ctx)
    return {"invocations_with_spans": len(own),
            "spans_per_invocation": statistics.fmean(len(v["spans"]) for v in own)
            if own else None,
            "ctx_builds": builds, "warm_stage_none": warm_none,
            "lock_wait_ms": spans.lock_wait_ms(kept_ctx), "issue_ms": spans.issue_ms(kept_ctx),
            "h2d_gbps": gbps, "h2d_bytes": None if gbps is None else counters["h2d_bytes"],
            "inflight_idle_pct": spans.inflight_idle_pct(kept_ctx),
            "graph_replay_pct": spans.graph_replay_pct(kept_ctx),
            "idle_by_span": spans.idle_by_span_of(kept_ctx)}


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
