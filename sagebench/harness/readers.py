"""What the metrics' readers (``metrics/<name>.py``) share. Each takes the
run's context (``runner.run_cell``) and gives a number, or None where the
run holds nothing for it to read. Times in the context are seconds from
the window's start."""
from __future__ import annotations

import math
import statistics
from typing import List, Optional

from harness import counts, stats, trace

INF = math.inf


def window(ctx: dict) -> List[dict]:
    return ctx["invocations"]


def latencies_from_due(ctx: dict) -> List[float]:
    """Each invocation of the window, from when it was due to when its
    answer came; a failed one is infinite."""
    return [INF if v["failed"] else v["done"] - v["due"] for v in window(ctx)]


def e2e_quantile_ms(ctx: dict, q: float) -> Optional[float]:
    lat = latencies_from_due(ctx)
    return stats.quantile(lat, q) * 1e3 if lat else None


def completed_in_window(ctx: dict) -> List[dict]:
    return [v for v in window(ctx) if not v["failed"] and v["done"] <= ctx["seconds"]]


def mean_of(values: List[float]) -> Optional[float]:
    return statistics.fmean(values) if values else None


def stage_ms(ctx: dict, stage: str) -> Optional[float]:
    """Mean of a stage of the runtime's records over the window, in ms."""
    return mean_of([v["stages"][stage] * 1e3 for v in window(ctx)
                    if "stages" in v and stage in v["stages"]])


def compute_ms(ctx: dict) -> Optional[float]:
    """Mean time the function's handler ran, from when it held the node's
    compute lock to its return, less the time it waited for its data (the
    record's ``gpu_data``): the forward, in ms."""
    return mean_of([(v["handler"][1] - v["handler"][0] - v["stages"].get("gpu_data", 0.0))
                    * 1e3 for v in window(ctx) if "handler" in v and "stages" in v])


def mfu_pct(ctx: dict) -> Optional[float]:
    """Model FLOPs of the invocations completed in the window over what
    the card's bf16 peak gives in the window, in %."""
    done = completed_in_window(ctx)
    if not done:
        return None
    return 100.0 * len(done) * ctx["flops_per_invocation"] / (ctx["seconds"] * counts.PEAK_BF16)


def device_idle_pct(ctx: dict) -> Optional[float]:
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(ctx: dict, patterns, count_pattern: str, bound_s: float) -> Optional[float]:
    """The least time of the kernel's calls in the traced window (its bound
    per call, times the calls: the launches of ``count_pattern``) over the
    device time of every kernel in ``patterns``, in %."""
    t = ctx["trace"]
    if not t:
        return None
    secs, _ = trace.kernel_time(t, patterns)
    _, calls = trace.kernel_time(t, [count_pattern])
    if secs <= 0 or calls == 0:
        return None
    return 100.0 * calls * bound_s / secs


def median_ms(invocations: List[dict], part: str) -> Optional[float]:
    """Median of one part of the invocations' records, ms: a stage, the
    ``setup_wall`` or the harness's ``handler`` span."""
    vals = []
    for v in invocations:
        if part == "handler" and "handler" in v:
            vals.append(v["handler"][1] - v["handler"][0])
        elif part == "setup_wall" and "setup_wall" in v:
            vals.append(v["setup_wall"])
        elif part in v.get("stages", {}):
            vals.append(v["stages"][part])
    return statistics.median(vals) * 1e3 if vals else None
