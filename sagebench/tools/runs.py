"""Run cells of the benchmark one after another, each run a process of its
own, and keep every run's result line, earlier lines, exit code and wall
time in a JSON-lines log.

    python3 sagebench/tools/runs.py --log runs.jsonl \
        --run olmoe-1b-7b.cold:1234:30:0 --run mamba2-780m.saturate:99:30:1 ...

Each ``--run`` is ``workload:seed:seconds:trace``; ``--set N`` tags the
runs of the call. ``--spread`` prints, for the log's runs with trace 0,
each cell's end-to-end metrics per set, with the set's spread
(``stats.spread``)."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "sagebench"))


def run_one(spec: str, timeout: float) -> dict:
    workload, seed, seconds, trace = spec.split(":")
    cmd = [sys.executable, "sagebench/run.py", "--workload", workload, "--seed", seed,
           "--seconds", seconds, "--trace", trace]
    t = time.monotonic()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = 124, exc.stdout or "", exc.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    rec = {"workload": workload, "seed": int(seed), "seconds": float(seconds),
           "trace": int(trace), "rc": rc, "wall_s": time.monotonic() - t,
           "earlier": [], "result": None, "stderr_tail": err[-3000:]}
    for ln in lines:
        try:
            obj = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if "line" in obj:
            rec["earlier"].append(obj)
        else:
            rec["result"] = obj
    return rec


def spread_report(path: str) -> None:
    from harness import stats

    by = defaultdict(lambda: defaultdict(list))
    for ln in open(path):
        r = json.loads(ln)
        if r["trace"] or not r["result"]:
            continue
        for k, v in r["result"]["metrics"].items():
            by[(r["workload"], r.get("set", 0))][k].append(v["value"])
    for (w, s), ms in sorted(by.items()):
        for k, vals in sorted(ms.items()):
            sp = stats.spread(vals) if len(vals) >= 2 else float("nan")
            med = sorted(vals)[len(vals) // 2]
            print(f"{w} set{s} {k}: n={len(vals)} median={med:.6g} spread={sp:.4f} "
                  f"values={[round(v, 4) for v in vals]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--set", type=int, default=0, help="tag the runs with this set number")
    ap.add_argument("--timeout", type=float, default=1500)
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args()
    if args.spread:
        spread_report(args.log)
        return 0
    Path(args.log).parent.mkdir(parents=True, exist_ok=True)
    for spec in args.run:
        rec = run_one(spec, args.timeout)
        rec["set"] = args.set
        with open(args.log, "a") as f:
            f.write(json.dumps(rec) + "\n")
        res = rec["result"] or {}
        print(json.dumps({"run": spec, "rc": rec["rc"], "wall_s": round(rec["wall_s"], 1),
                          "correct": res.get("correct"), "metrics": {
                              k: v["value"] for k, v in res.get("metrics", {}).items()},
                          "checks": res.get("checks"), "device": res.get("device")}),
              flush=True)
        if rec["rc"] != 0:
            print(rec["stderr_tail"][-1500:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
