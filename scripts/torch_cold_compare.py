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

    python scripts/torch_cold_compare.py . build/parent --repeats 2
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
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
            "first_gpu_ctx_ms": {s: ctx[s] * 1e3 for s in ctx},
            "first_gpu_ctx_ratio": ctx["sage"] / ctx["fixedgsl"],
            "later_colds_ratio": (statistics.median(e2e["sage"][1:])
                                  / statistics.median(e2e["fixedgsl"][1:])),
            "cold_compute_over_warm": over_warm,
            "copy_ms": {s: [r.get("loads", {}).get("copy_ms") for r in got[s]["runs"]]
                        for s in got},
            "collections_in_cold": {s: [r.get("collections_in_cold") for r in got[s]["runs"]]
                                    for s in got}}


def main() -> None:
    if sys.argv[1:2] == ["--serve-child"]:
        return serve_child(sys.argv[2])
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="checkouts to compare")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--skip", choices=("serve", "cold"), action="append", default=[])
    args = ap.parse_args()
    trees = [str(Path(t).resolve()) for t in args.trees]
    for what in ("serve", "cold"):
        if what in args.skip:
            continue
        for rep in range(args.repeats):
            for tree in trees if rep % 2 == 0 else trees[::-1]:
                got = (run([sys.executable, str(Path(__file__).resolve()), "--serve-child",
                            tree], tree) if what == "serve" else cold(tree))
                print(json.dumps({"what": what, "tree": tree, "repeat": rep, **got}),
                      flush=True)


if __name__ == "__main__":
    main()
