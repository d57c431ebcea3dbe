"""Find the highest rate a configuration's warm node sustains: one process,
one set-up, then a closed loop of ``--clients`` for ``--seconds`` (the
node's service rate, mu), then open Poisson loops at each ``--fractions``
of mu, each for ``--seconds`` and on the mix's own fixed schedule
(``traffic.open_schedule`` with its ``schedule_seed``) and functions.
Prints one JSON line a step: the offered and answered rates, p50 and p95
from the due time, and the backlog's growth (the mean latency from the due
time of the step's last third of invocations over its first third's);
then the knee and the rate a cell offers at ``--cell-share`` of it.

    python3 sagebench/tools/sweep.py --config olmoe-1b-7b --traffic zipf4_olmoe \
        --seed 7 --seconds 30 --fractions 0.7,0.8,0.85,0.9,0.95,1.0

A rate is sustained when every invocation is answered within the step's
window and ``DRAIN`` times it again, and the growth is under ``GROWTH``.
The knee is the highest fraction that is sustained with every lower
fraction tried: a step that fails ends the climb, whatever a higher one
reads."""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
GROWTH = 1.25
DRAIN = 3.0
sys.path[:0] = [str(ROOT / "sagebench"), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--fractions", default="0.8,0.9,0.95,1.0,1.05")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cell-share", type=float, default=0.8)
    args = ap.parse_args()

    from harness import manifest, runner, stats, traffic

    config, mix = manifest.config(args.config), manifest.mix(args.traffic)
    ref = manifest.reference(args.config)
    prog, rt, prompts, order, fn_order = runner.setup(config, mix, args.seed, args.device, ref,
                                            lambda obj: print(json.dumps(obj), flush=True))
    t0 = time.monotonic()
    invs = runner.run_closed(prog, rt, prompts, order, fn_order, args.clients, False, t0,
                             t0 + args.seconds)
    done = [v for v in invs if v.done is not None and v.done <= t0 + args.seconds]
    mu = len(done) / args.seconds
    print(json.dumps({"step": "closed", "clients": args.clients, "rate_per_s": mu}), flush=True)
    knee = 0.0
    climbing = True
    for frac in sorted(float(f) for f in args.fractions.split(",")):
        rate = frac * mu
        due = traffic.open_schedule(rate, args.seconds, int(mix["schedule_seed"]),
                                    mix.get("burst"))
        t0 = time.monotonic()
        invs = runner.run_open(prog, rt, prompts, order, fn_order, due, t0)
        while (any(v.done is None for v in invs)
               and time.monotonic() < t0 + (1 + DRAIN) * args.seconds):
            time.sleep(0.005)
        lat = [(v.done - v.due) if v.done is not None else float("inf") for v in invs]
        n = len(lat)
        third = max(1, n // 3)
        first, last = statistics.fmean(lat[:third]), statistics.fmean(lat[-third:])
        answered = sum(1 for v in invs if v.done is not None and v.done <= t0 + args.seconds)
        sustained = all(v.done is not None for v in invs) and last / first < GROWTH
        climbing = climbing and sustained
        if climbing:
            knee = frac
        print(json.dumps({
            "step": "open", "fraction": frac, "rate_per_s": rate, "invocations": n,
            "answered_in_window": answered / n,
            "p50_ms": stats.quantile(lat, 0.5) * 1e3, "p95_ms": stats.quantile(lat, 0.95) * 1e3,
            "growth": last / first, "sustained": sustained}), flush=True)
    print(json.dumps({"step": "knee", "fraction": knee, "knee_per_s": knee * mu,
                      "cell_rate_per_s": args.cell_share * knee * mu}), flush=True)
    runner.retire(prog, rt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
