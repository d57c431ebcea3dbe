"""Run one cell of the benchmark once, on the card of this machine.

    python3 sagebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``sagebench/configs/<config>.json``, its plain
reference beside it in ``<config>.py``) and a traffic mix
(``sagebench/traffic/<traffic>.json``). The run makes its weights and
prompts from ``--seed``, builds the program's SAGE runtime over them,
serves a cold invocation of each of the mix's functions and its warm-ups
(the set-up, timed as ``setup_s``), then drives the mix for ``--seconds``;
with ``--trace 1`` under ``torch.profiler``. Once the window has closed and
the program's state is freed, the answers the window served (all, or those
of a sample of (function, prompt) pairs drawn from the seed) are compared
with the reference (``harness/check.py``).

Standard output: one JSON line of each earlier reading (``"line"`` names
it), then, last, the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, each read by ``sagebench/metrics/<name>.py`` or, where a
suffixed name has none, its stem's), ``device``
(and ``breakdown`` when traced: the device's longest operations, its
longest idle gaps by what the host was doing, and its idle seconds by the
program's span open then, ``idle_by_span``), and ``checks``, each number compared with
its limit. Standard error ends with the same numbers, one to a line.

Exit codes: 2 without a card (or fewer than the cell asks for), 3 if JAX,
``flax`` or the JAX package was loaded; no result is printed then."""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout (the
# program's own CUDA kernels build into ROOT/build/kernels)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = str(ROOT / "build" / "sagebench" / _sub)
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def card(query: str = "name,power.limit") -> dict:
    """What ``nvidia-smi`` reads of the card: its name and power limit, or
    another ``--query-gpu`` list."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"unavailable: {exc}"}
    return {"nvidia_smi": f"{query}: {out.splitlines()[0] if out else ''}"}


STATE = "clocks.sm,clocks.max.sm,temperature.gpu,power.draw"


def emit(line: str, obj: dict) -> None:
    print(json.dumps({"line": line, **obj}), flush=True)


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from harness import check, manifest, readers, runner, spans, traffic

    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"sagebench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config = manifest.config(cell["config"])
    mix = traffic.validate(manifest.mix(cell["traffic"]))
    reference = manifest.reference(cell["config"])
    info = {"kind": torch.cuda.get_device_name(0), **card(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("card", info)
    emit("card_before", card(STATE))

    run = runner.run_cell(config, mix, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          log=lambda obj: emit("setup", obj), reference=reference,
                          t_process=T_PROCESS)
    ctx, invs = run["context"], run["invocations"]
    emit("card_after", card(STATE))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = manifest.read_all(manifest.metrics_of(bench, cell["name"], kind), ctx)
    cold = bool(mix.get("fresh_node"))
    recs = ctx["invocations"]
    emit("window", {
        "attempted": len(recs), "answered_in_window": sum(
            1 for v in recs if not v["failed"] and v["done"] <= ctx["seconds"]),
        "generator_late_ms": {"max": max((v["sent"] - v["due"] for v in recs), default=0) * 1e3,
                              "mean": sum(v["sent"] - v["due"] for v in recs)
                              / max(len(recs), 1) * 1e3},
        "intended_warm_stage": None if cold else 1,
        "other_warm_stage": sum(1 for v in recs if "warm_stage" in v
                                and v["warm_stage"] != (None if cold else 1)),
        "no_record": sum(1 for v in recs if "warm_stage" not in v),
        "context_builds": sum(1 for v in recs if v.get("stages", {}).get("gpu_ctx", 0) > 1e-3),
        "by_function": [sum(1 for v in recs if v["function"] == f)
                        for f in range(int(mix.get("functions", 1)))],
        "errors": sorted({v["error"] for v in recs if v["error"]})[:5],
        "median_ms": {k: readers.median_ms(recs, k)
                      for k in ("gpu_ctx", "gpu_data", "compute", "setup_wall", "handler")},
        "memory_peak_bytes": ctx["memory_peak_bytes"]})
    if cold:
        emit("cold_nodes", {"node_start_ms": [v["node"]["start_s"] * 1e3 for v in recs
                                              if v.get("node")],
                            "node_stop_ms": [v["node"]["stop_s"] * 1e3 for v in recs
                                             if v.get("node")]})
    device = {"platform": "gpu", "kind": info["kind"], "count": cell["chips"],
              "memory_peak_bytes": ctx["memory_peak_bytes"]}
    result = {"correct": False, "attempted": len(recs),
              "failed": sum(1 for v in recs if v["failed"]), "metrics": metrics,
              "device": device}
    summary = ctx["trace"]
    if args.trace:
        if summary is None:
            print("sagebench: the trace holds no device work in the window", file=sys.stderr)
        else:
            device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
            by_span = spans.idle_by_span_of(ctx)
            if by_span is not None:
                result["breakdown"]["idle_by_span"] = [[k, v] for k, v in by_span.items()][:10]
    del run, ctx
    t = time.monotonic()
    verdict = check.check(config, mix, args.seed, "cuda", reference, invs)
    emit("check", {"seconds": time.monotonic() - t, "compared": verdict["compared"],
                   "pairs": verdict["pairs"]})
    found = runner.foreign_modules()
    if found:
        print(f"sagebench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    result["correct"] = bool(verdict["correct"] and (summary is not None or not args.trace))
    result["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                        for k, v in verdict["numbers"].items()}
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
