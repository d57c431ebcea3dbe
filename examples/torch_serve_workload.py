"""End-to-end serving on the PyTorch/CUDA port, as examples/serve_workload.py
does for the JAX package: one Workload replayed against real (reduced)
models through the gateway, comparing FixedGSL with SAGE under identical
open-loop load (the serving counterpart of the paper's §7.2), with
per-request SLO deadlines recorded end to end. The three functions are the
reduced qwen2.5-3b and qwen3-8b (the flash-attention kernel on the card)
and mamba2-780m (the SSD-scan kernel).

Run:  python examples/torch_serve_workload.py [--requests 24]   # on the card
      python examples/torch_serve_workload.py --device cpu       # on the CPU
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import FunctionSpec, Gateway, PoissonWorkload  # noqa: E402

SPECS = [
    FunctionSpec(name="qwen2.5-3b-fn", arch="qwen2.5-3b", profile="resnet50",
                 deadline_s=2.0),
    FunctionSpec(name="qwen3-8b-fn", arch="qwen3-8b", profile="bert",
                 deadline_s=2.0),
    FunctionSpec(name="mamba2-780m-fn", arch="mamba2-780m", profile="seq2seq",
                 deadline_s=2.0),
]


def drive(system: str, requests: int, rate: float, seed: int = 0, device: str = "cuda"):
    """Replay ``requests`` Poisson requests against ``system`` on ``device``,
    retire the node and shut the gateway down; returns the telemetry."""
    gw = Gateway(backend="runtime", policy=system, time_scale=0.05,
                 exit_ttl=3.0, device=device)
    for spec in SPECS:
        gw.register(spec)
    # open-loop Poisson over the three functions, truncated at `requests`
    # (duration oversized so the count is always reached)
    workload = PoissonWorkload([s.name for s in SPECS], rate,
                               duration_s=4.0 * requests / rate, seed=seed,
                               max_events=requests)
    t0 = time.monotonic()
    tel = gw.replay(workload)
    wall = time.monotonic() - t0
    print(f"{system:10s} {len(workload)} reqs {wall:6.2f}s "
          f"({len(workload)/wall:5.2f}/s) mean={tel.mean_e2e()*1e3:8.1f}ms "
          f"p99={tel.p99_e2e()*1e3:8.1f}ms warm%={tel.warm_fraction()*100:5.1f} "
          f"slo_miss%={tel.slo_miss_rate()*100:5.1f} "
          f"shared={gw.runtime.daemon.stats['shared_hits']:3d} "
          f"mem={gw.memory_usage()['device_used']/2**20:6.0f}MB "
          f"errors={tel.error_count()}")
    gw.runtime.drain()
    gw.shutdown()
    return tel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=6.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("system     load                mean        p99      warm   slo   sharing  memory  errors")
    base = drive("fixedgsl", args.requests, args.rate, device=args.device).mean_e2e()
    sage = drive("sage", args.requests, args.rate, device=args.device).mean_e2e()
    print(f"\nSAGE speedup vs FixedGSL on {args.device}: {base/sage:.1f}x")
    return {"fixedgsl": base, "sage": sage}


if __name__ == "__main__":
    main()
