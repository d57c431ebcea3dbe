"""Reading the device trace of a traced run (``--trace 1``).

``torch.profiler`` records the window on the card (CUPTI) and on the host.
The window itself is a ``record_function`` range, ``WINDOW``, on the
thread that drives it. From the raw events this module takes:

* the device's busy intervals in the window: kernels, copies and memsets
  (every event on the card but the ranges that mark host annotations),
  merged, so ``busy_s`` is the time in which anything ran on the card;
* the card's idle intervals, in seconds from the window's start;
* each kernel's summed device time and count, by name;
* the longest idle gaps of the card, each named by what the host was doing
  at its middle: the innermost host event (an operator or a runtime call)
  that covered it, or ``host: none``."""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from harness import spans

WINDOW = "sagebench.window"


def start():
    """A started profiler that records the host and the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False, profile_memory=False)
    prof.start()
    torch.cuda.synchronize()
    return prof


def _on_card(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"


def _on_device(e) -> bool:
    """A kernel, copy or memset on the card (not a range that only marks
    a host annotation on the device's timeline)."""
    if not _on_card(e):
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation() if annotation is not None else e.name() == WINDOW)


def short(name: str) -> str:
    """A kernel's name without its template arguments and parameters, with
    the functors and element types named inside them kept, for the
    breakdown (the sums are keyed by the full name)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name, maxsplit=1)[0]
    inner = re.findall(r"(\w*Functor\w*|direct_copy\w*|\w+_kernel\w*|BFloat16|float)", name)
    seen = []
    for tok in inner:
        if tok != base.rsplit("::", 1)[-1] and tok not in seen:
            seen.append(tok)
    return f"{base}[{','.join(seen)}]" if seen else base


def summarize(prof, top: int = 10) -> Optional[dict]:
    """The trace's reading, or None where it holds no window or no device
    work in it."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and not _on_card(e)]
    if not win:
        return None
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.start_ns() + e.duration_ns() for e in win)
    dev, host = [], []
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if t <= w0 or s >= w1:
            continue
        if _on_device(e):
            s, t = max(s, w0), min(t, w1)
            dev.append((s, t))
            slot = by_kernel[e.name()]
            slot[0] += (t - s) / 1e9
            slot[1] += 1
        elif not _on_card(e) and e.name() != WINDOW:
            host.append((s, t, e.name()))
    if not dev:
        return None
    merged = spans.merged(dev)
    busy_ns = sum(t - s for s, t in merged)
    gaps = [(merged[0][0] - w0, w0, merged[0][0])]
    gaps += [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps.append((w1 - merged[-1][1], merged[-1][1], w1))
    idle = [((a - w0) / 1e9, (b - w0) / 1e9) for length, a, b in gaps if length > 0]
    gaps = sorted(gaps, reverse=True)[:top]
    if host:
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = np.array([h[1] for h in host], dtype=np.int64)
    named = defaultdict(float)
    for length, a, b in gaps:
        label = "host: none"
        if host:
            mid = (a + b) // 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            if cover.size:
                label = host[int(cover[np.argmax(hs[cover])])][2]
        named[label] += length / 1e9
    ops = sorted(((short(k), v[0]) for k, v in by_kernel.items()), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "idle": idle,
        "kernels": {k: {"seconds": v[0], "count": v[1]} for k, v in by_kernel.items()},
        "device_ops": [[k, v] for k, v in ops],
        "idle_gaps": [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])],
    }


def kernel_time(summary: dict, patterns) -> tuple:
    """(seconds, count) summed over the kernels whose name holds any of
    ``patterns``."""
    secs, n = 0.0, 0
    for name, v in summary["kernels"].items():
        if any(p in name for p in patterns):
            secs += v["seconds"]
            n += v["count"]
    return secs, n
