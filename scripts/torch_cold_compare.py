"""Cold set-up and serving of one or more checkouts of the port, on the card.

Each checkout given (a directory holding ``chip_smoke.py`` and ``src/``) is
run in fresh processes of its own, in turns (the order reversed on every
other repeat: A B, B A, ...):

- ``serve``: the checkout's kernels built (``chip_smoke.phase_build``),
  then ``launch/serve.py``'s ``serve`` and ``examples/torch_serve_workload.py``'s
  ``drive`` under FixedGSL and SAGE with ``chip_smoke.py``'s settings (its
  ``serve`` and ``serve_workload`` phases). One JSON line per checkout and
  repeat: per run, the requests' mean and p99 e2e and the warm ones'
  (a warm stage reused) median and mean e2e, in ms.
- ``cold``: ``chip_smoke.py --cold-runs SYSTEM`` (the full-width
  qwen2.5-3b served cold three times, as ``cold_setup`` does) under SAGE,
  then FixedGSL. One JSON line per checkout and repeat: the first cold's
  SAGE / FixedGSL e2e and ``gpu_ctx``, the later colds' median SAGE /
  FixedGSL e2e, each cold ``compute`` over its policy's warm median, the
  weights' copies, and the garbage collections inside each cold request
  (where the checkout logs them).
- ``cold`` with ``--arms ARM/POLICY ...``: fresh processes that import the
  checkout's ``chip_smoke`` and run ``cold_runs(POLICY, settle)``,
  the list in turns on every repeat. ARM says what runs before each
  request: ``none``; ``collect`` (a full garbage collection); ``sleep`` (a
  sleep as long as the median collection before the same request of this
  command's ``collect`` processes so far; list a ``collect`` arm before it);
  ``pooled`` runs nothing before a request but the baselines' loads on
  the idle threads of one pool (``pooled_loads``).
  Each process's whole record (per request the host's window: thread CPU,
  rusage, every thread's CPU, collections, allocator deltas; the
  context build's and the compute's windows and the forward's per-layer
  host and device times; the threads' lives; a canary process's late
  wake-ups) goes as one line to ``--log``; stdout gets a
  summary line per process. ``--report LOG`` summarizes such a log.

    python scripts/torch_cold_compare.py . build/parent --repeats 2
    python scripts/torch_cold_compare.py . --skip serve --repeats 12 \
        --arms none/sage none/fixedgsl collect/fixedgsl sleep/fixedgsl \
        --log build/cold_arms.jsonl
    python scripts/torch_cold_compare.py --report build/cold_arms.jsonl
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def serve_child(tree: str) -> None:
    sys.path[:0] = [tree, str(Path(tree) / "src")]
    import chip_smoke as cs
    from repro_torch.launch.serve import serve

    cs.phase_card()
    cs.phase_build()
    example = cs.load_example("torch_serve_workload")

    def summary(tel) -> dict:
        e2e = [r.e2e * 1e3 for r in tel.records]
        warm = [r.e2e * 1e3 for r in tel.records if r.warm_stage is not None]
        return {"requests": len(e2e), "errors": tel.error_count(),
                "mean_e2e_ms": statistics.mean(e2e), "p99_e2e_ms": tel.p99_e2e() * 1e3,
                "warm": len(warm), "warm_median_e2e_ms": statistics.median(warm) if warm else None,
                "warm_mean_e2e_ms": statistics.mean(warm) if warm else None}

    out = {}
    for system in ("fixedgsl", "sage"):
        served = serve("qwen2.5-3b", system, requests=cs.SERVE_REQUESTS, rate=cs.SERVE_RATE,
                       time_scale=cs.SERVE_TIME_SCALE, device="cuda")
        out[f"serve/{system}"] = summary(served.telemetry)
    for system in ("fixedgsl", "sage"):
        tel = example.drive(system, cs.SERVE_WORKLOAD_REQUESTS, cs.SERVE_WORKLOAD_RATE,
                            device="cuda")
        out[f"serve_workload/{system}"] = summary(tel)
    print(json.dumps(out), flush=True)


def run(cmd, tree: str) -> dict:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=tree)
    if res.returncode:
        sys.exit(f"torch_cold_compare: {cmd} in {tree} failed: {res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def cold(tree: str) -> dict:
    got = {s: run([sys.executable, "chip_smoke.py", "--cold-runs", s], tree)
           for s in ("sage", "fixedgsl")}
    colds = {s: [r["cold"] for r in got[s]["runs"]] for s in got}
    e2e = {s: [c["e2e_s"] for c in colds[s]] for s in colds}
    ctx = {s: colds[s][0]["stages_s"]["gpu_ctx"] for s in colds}
    over_warm = {}
    for s in got:
        warm = statistics.median(r["warm"]["stages_s"]["compute"] for r in got[s]["runs"])
        over_warm[s] = [c["stages_s"]["compute"] / warm for c in colds[s]]
    return {"first_cold_e2e_ratio": e2e["sage"][0] / e2e["fixedgsl"][0],
            "first_build_ms": {s: got[s]["runs"][0]["context_build_ms"] for s in got},
            "first_cold_e2e_ms": {s: e2e[s][0] * 1e3 for s in e2e},
            "cold_account": {s: [r.get("account") for r in got[s]["runs"]] for s in got},
            "first_gpu_ctx_ms": {s: ctx[s] * 1e3 for s in ctx},
            "first_gpu_ctx_ratio": ctx["sage"] / ctx["fixedgsl"],
            "later_colds_ratio": (statistics.median(e2e["sage"][1:])
                                  / statistics.median(e2e["fixedgsl"][1:])),
            "cold_compute_over_warm": over_warm,
            "copy_ms": {s: [r.get("loads", {}).get("copy_ms") for r in got[s]["runs"]]
                        for s in got},
            "collections_in_cold": {s: [r.get("collections_in_cold") for r in got[s]["runs"]]
                                    for s in got}}


def build_child(tree: str) -> None:
    sys.path[:0] = [tree, str(Path(tree) / "src")]
    import chip_smoke as cs

    cs.phase_card()
    cs.phase_build()
    print(json.dumps({"built": tree}), flush=True)


# a process that sleeps 1 ms at a time and, when its stdin closes, prints
# each wake-up that came more than 3 ms late: (host clock at the sleep's
# start, seconds it took). CLOCK_MONOTONIC is the machine's, so its gaps
# line up with the spans of the process beside it: a wake-up late inside
# a span stalled the whole machine, not that process alone
CANARY = """
import json, sys, threading, time
gaps, stop = [], threading.Event()
threading.Thread(target=lambda: (sys.stdin.read(), stop.set()), daemon=True).start()
while not stop.is_set():
    t = time.monotonic(); time.sleep(0.001); dt = time.monotonic() - t
    if dt > 0.004:
        gaps.append((t, dt))
print(json.dumps(gaps))
"""


def pooled_loads() -> None:
    """Run the baselines' loads (``MemoryDaemon``'s unpooled
    ``_submit_load``) on the idle threads of one unbounded
    ``ThreadPoolExecutor`` instead: the control arm that showed a thread a
    load, ending beside the next request's compute, slowing it. The daemon
    now keeps its loads' threads itself (``daemon._IdleThreads``), so on
    this checkout the arm matches ``none``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.daemon import MemoryDaemon

    pool, plain = ThreadPoolExecutor(max_workers=64), MemoryDaemon._submit_load

    def submit(self, job, key):
        return plain(self, job, key) if self.pooled else pool.submit(job)

    MemoryDaemon._submit_load = submit


def cold_child(tree: str, system: str, arm: str, sleep_ms: str) -> None:
    """One fresh process of an arm: ``cold_runs`` with its hosts probed,
    each thread's life (start, end, its CPU seconds) logged, and a canary
    process beside it."""
    import threading

    sys.path[:0] = [tree, str(Path(tree) / "src")]
    import chip_smoke as cs

    lengths = [float(x) for x in sleep_ms.split(",")] if sleep_ms else []
    settle = {"none": None, "pooled": None, "collect": lambda slot: gc.collect(),
              "sleep": lambda slot: time.sleep(lengths[slot] / 1e3)}[arm]
    if arm == "pooled":
        pooled_loads()
    lives, plain_run = [], threading.Thread.run

    def run(self):
        t0 = time.monotonic()
        try:
            plain_run(self)
        finally:
            lives.append((self.name, threading.get_native_id(), t0, time.monotonic(),
                          time.thread_time()))

    threading.Thread.run = run
    canary = subprocess.Popen([sys.executable, "-c", CANARY], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, text=True)
    try:
        got = cs.cold_runs(system, settle=settle)
    finally:
        late = json.loads(canary.communicate("", timeout=60)[0])
    got.update(canary=late, thread_lives=lives)
    print(json.dumps(got), flush=True)


def first_over_warm(got: dict) -> list:
    warm = statistics.median(r["warm"]["stages_s"]["compute"] for r in got["runs"])
    return [r["cold"]["stages_s"]["compute"] / warm for r in got["runs"]]


def arms(tree: str, specs: list, repeats: int, log) -> None:
    """``specs`` (ARM/POLICY) in turns, ``repeats`` times, each a fresh
    process; the sleep arm sleeps the collect arm's median so far."""
    collected = {}  # request slot -> the collect arm's collections' ms
    for rep in range(repeats):
        for spec in specs if rep % 2 == 0 else specs[::-1]:
            arm, system = spec.split("/")
            sleeps = ""
            if arm == "sleep":
                if not collected:
                    sys.exit("torch_cold_compare: list a collect arm before the sleep arm")
                sleeps = ",".join(str(statistics.median(collected[k])) for k in sorted(collected))
            got = run([sys.executable, str(Path(__file__).resolve()), "--cold-child", tree,
                       system, arm, sleeps], tree)
            if arm == "collect":
                for i, r in enumerate(got["runs"]):
                    for j, kind in enumerate(("cold", "warm")):
                        collected.setdefault(2 * i + j, []).append(r["settle_ms"][kind])
            got.update(arm=arm, repeat=rep, tree=tree)
            log.write(json.dumps(got) + "\n")
            log.flush()
            computes = [next(w for w in r["host"]["cold"]["inside"] if w["kind"] == "compute")
                        for r in got["runs"]]
            print(json.dumps({"what": "cold_arm", "arm": arm, "system": system, "repeat": rep,
                              "cold_compute_over_warm": first_over_warm(got),
                              "first_build_ms": got["runs"][0]["context_build_ms"],
                              "first_compute": {k: computes[0].get(k) for k in
                                                ("wall_ms", "thread_cpu_ms", "issue_end_ms")},
                              "settle_ms": [r.get("settle_ms") for r in got["runs"]]}),
                  flush=True)


def overlap_ms(gaps, t0: float, t1: float) -> float:
    """Ms by which the canary's wake-ups that overlap [t0, t1] came late."""
    return sum(max(0.0, min(t + dt, t1) - max(t, t0)) for t, dt in gaps if dt > 0) * 1e3


def span_row(w: dict, got: dict, t_request: float) -> dict:
    """A probed build or compute in brief: its start (ms into the
    request), wall and thread CPU ms, rusage, the forward's issue and
    per-layer host and device ms, the canary's lateness inside it, and
    the threads that ended inside it."""
    t0 = t_request + w["start_ms"] / 1e3
    t1 = t0 + w["wall_ms"] / 1e3
    row = {"start": round(w["start_ms"], 1), "wall": round(w["wall_ms"], 1),
           "cpu": round(w["thread_cpu_ms"], 1), **{k[3:]: v for k, v in w["rusage"].items()},
           "canary_late": round(overlap_ms(got["canary"], t0, t1), 1),
           "ended": [(name, round((end - t0) * 1e3, 1), round(cpu * 1e3))
                     for name, _, start, end, cpu in got["thread_lives"] if t0 <= end <= t1]}
    if "host_ms" in w:
        h, d = w["host_ms"], w["device_ms"]
        row.update(issue=(round(w["issue_start_ms"], 1), round(w["issue_end_ms"], 1)),
                   host=round(sum(h), 1),
                   host_max=(round(max(h), 1), h.index(max(h))), device=round(sum(d), 1),
                   device_max=(round(max(d), 1), d.index(max(d))))
    return row


def report(path: str) -> None:
    """Per arm and policy: each process's cold computes over its warm
    median and its first build; then per process and cold request its
    stages and the probed build's and compute's ``span_row``, beside the
    request's collections, allocator deltas and busiest threads."""
    rows = [json.loads(line) for line in open(path)]
    groups = {}
    for got in rows:
        groups.setdefault((got["arm"], got["system"]), []).append(got)
    for (arm, system), procs in groups.items():
        over = [first_over_warm(g) for g in procs]
        print(json.dumps({"arm": arm, "system": system, "processes": len(procs),
                          "first_over_warm": [round(x[0], 3) for x in over],
                          "slow_first": sum(x[0] > 1.15 for x in over),
                          "slow_later": sum(y > 1.15 for x in over for y in x[1:]),
                          "over_1.1": [sum(x[0] > 1.1 for x in over),
                                       sum(y > 1.1 for x in over for y in x[1:])],
                          "later_over_warm": sorted(round(y, 3) for x in over for y in x[1:]),
                          "first_build_ms": [round(g["runs"][0]["context_build_ms"], 1)
                                             for g in procs]}))
        for g, x in zip(procs, over):
            for i, r in enumerate(g["runs"]):
                req = r["host"]["cold"]
                spans = {w["kind"]: span_row(w, g, req["t"]) for w in req["inside"]}
                print(json.dumps({
                    "arm": arm, "system": system, "repeat": g["repeat"], "run": i,
                    "over_warm": round(x[i], 3),
                    "stages": {k: round(v * 1e3, 1) for k, v in r["cold"]["stages_s"].items()
                               if k in ("gpu_ctx", "gpu_data", "compute")},
                    **spans,
                    "request": {"gc": req["collections"], "alloc": req["alloc_deltas"],
                                "host_alloc": req["host_alloc_deltas"],
                                "threads": [(n, round(c, 1)) for n, _, c, _ in
                                            req["threads_ms"][:4]]}}))


def main() -> None:
    if sys.argv[1:2] == ["--serve-child"]:
        return serve_child(sys.argv[2])
    if sys.argv[1:2] == ["--build-child"]:
        return build_child(sys.argv[2])
    if sys.argv[1:2] == ["--cold-child"]:
        return cold_child(*sys.argv[2:6])
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="checkouts to compare")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--skip", choices=("serve", "cold"), action="append", default=[])
    ap.add_argument("--arms", nargs="+",
                    help="ARM/POLICY: ARM none, collect, sleep or pooled (pooled_loads)")
    ap.add_argument("--log", help="the arms' whole records, one JSON line a process")
    ap.add_argument("--report", help="summarize a --log file and exit")
    args = ap.parse_args()
    if args.report:
        return report(args.report)
    trees = [str(Path(t).resolve()) for t in args.trees]
    for what in ("serve", "cold"):
        if what in args.skip:
            continue
        if what == "cold" and args.arms:
            with open(args.log or "cold_arms.jsonl", "a") as log:
                for tree in trees:
                    run([sys.executable, str(Path(__file__).resolve()), "--build-child", tree],
                        tree)
                    arms(tree, args.arms, args.repeats, log)
            continue
        for rep in range(args.repeats):
            for tree in trees if rep % 2 == 0 else trees[::-1]:
                got = (run([sys.executable, str(Path(__file__).resolve()), "--serve-child",
                            tree], tree) if what == "serve" else cold(tree))
                print(json.dumps({"what": what, "tree": tree, "repeat": rep, **got}),
                      flush=True)


if __name__ == "__main__":
    main()
