"""Where the cold set-up of one serving policy spends its time, on the card.

In a new process: ``chip_smoke.cold_runs(SYSTEM)`` (the full-width
qwen2.5-3b served cold three times under SYSTEM, each cold request followed
by a warm one; the same runs as ``chip_smoke.py``'s ``cold_setup`` phase)
under ``torch.profiler`` with CPU and CUDA activity, every thread's CPU
operators where this torch can record them. Prints one JSON line per
request (the ``cold/<run>/<kind>`` ranges that ``cold_runs`` opens): per
host thread, labelled from ``cold_runs``' log (``loader``: the thread that
copied the weights; ``build``: the thread that built the context; others
by id), its CUDA API calls by total time and its lazy module loads; on
the device, the host -> device copies and the kernels (count,
busy time, first start and last end from the request's start), and the
kernels' busy time while a copy ran. Then the result of ``cold_runs``.

    python scripts/torch_cold_trace.py sage
    python scripts/torch_cold_trace.py fixedgsl --trace fixedgsl_trace.json
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def profiler_config():
    """Every thread's CPU operators where this torch offers it; the CUDA
    runtime and device activity come from CUPTI on every thread anyway."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True), True
    except TypeError:
        return None, False


def spans(events):
    """(count, busy ms, first start ms, last end ms) of ``events`` (µs)."""
    if not events:
        return {"n": 0, "busy_ms": 0.0}
    return {"n": len(events), "busy_ms": sum(e["dur"] for e in events) / 1e3,
            "first_ms": min(e["ts"] for e in events),
            "last_ms": max(e["ts"] + e["dur"] for e in events)}


def overlap_ms(a, b) -> float:
    """Time (ms) during which an event of ``a`` and one of ``b`` both run
    (``b`` sorted and its events disjoint, as one stream's are)."""
    total = 0.0
    for x in a:
        x0, x1 = x["ts"], x["ts"] + x["dur"]
        for y in b:
            y0, y1 = y["ts"], y["ts"] + y["dur"]
            if y0 >= x1:
                break
            total += max(0.0, min(x1, y1) - max(x0, y0))
    return total / 1e3


def window(trace, name, labels, top):
    """The summary of the request whose range is called ``name``."""
    mark = next(e for e in trace if e.get("name") == name and e.get("ph") == "X")
    t0, t1 = mark["ts"], mark["ts"] + mark["dur"]
    inside = [e for e in trace if e.get("ph") == "X" and t0 <= e["ts"] < t1]
    threads = collections.defaultdict(lambda: collections.defaultdict(lambda: [0, 0.0, 0.0]))
    modules = collections.defaultdict(lambda: [0, 0.0])
    for e in inside:
        label = labels.get(e.get("tid"), str(e.get("tid")))
        if "Module" in e["name"]:
            modules[label][0] += 1
            modules[label][1] += e["dur"] / 1e3
        if e.get("cat", "").startswith("cuda_"):  # the CUDA API's calls and waits
            row = threads[label][e["name"]]
            row[0] += 1
            row[1] += e["dur"] / 1e3
            row[2] = max(row[2], e["dur"] / 1e3)
    copies = sorted((e for e in inside if e.get("cat") == "gpu_memcpy"), key=lambda e: e["ts"])
    kernels = sorted((e for e in inside if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    device = {}
    for kind, evs in (("copies", copies), ("kernels", kernels)):
        s = spans(evs)
        if evs:
            s["first_ms"] = (s["first_ms"] - t0) / 1e3
            s["last_ms"] = (s["last_ms"] - t0) / 1e3
        device[kind] = s
    device["copy_bytes"] = sum(e.get("args", {}).get("bytes", 0) for e in copies)
    device["kernel_busy_during_copies_ms"] = overlap_ms(copies, kernels)
    return {"request": name, "span_ms": mark["dur"] / 1e3, "device": device,
            "module_loads": {k: {"n": n, "ms": t} for k, (n, t) in modules.items()},
            "threads": {label: {
                "runtime_ms": sum(r[1] for r in calls.values()),
                "top": sorted(([n, *r] for n, r in calls.items()), key=lambda r: -r[2])[:top]}
                for label, calls in threads.items()}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("system", choices=("sage", "fixedgsl"))
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--trace", help="also write the chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_cold_trace: no CUDA device")
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    config, all_threads = profiler_config()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        got = chip_smoke.cold_runs(args.system)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        trace = json.loads(Path(path).read_text())["traceEvents"]
    for i, run in enumerate(got["runs"]):
        labels = {run["loads"]["copy_thread"]: "loader",
                  **{t: "build" for t in run["loads"]["build_thread"]}}
        for kind in ("cold", "warm"):
            print(json.dumps({"system": args.system, "all_threads_cpu_ops": all_threads,
                              **window(trace, f"cold/{i}/{kind}", labels, args.top)}),
                  flush=True)
    print(json.dumps({**got, "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
