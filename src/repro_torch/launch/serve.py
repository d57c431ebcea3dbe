"""Serving launcher: the unified gateway fronting real (reduced) models,
the serving side's end-to-end entry point (the JAX package's
``launch/serve.py``).

It runs on the card unless ``device="cpu"`` (``--device cpu``); asking for
the card where there is none raises. After the replay the node is retired
(``SageRuntime.drain``: the exact teardown of a drained node) before the
gateway shuts down, so the launcher leaves no device memory behind.
``serve`` returns the telemetry with the retired node's statistics and
memory usage.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --system sage --requests 32 --rate 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict

from repro_torch.api import FunctionSpec, Gateway, PoissonWorkload
from repro_torch.core.telemetry import Telemetry


@dataclass
class Served:
    telemetry: Telemetry
    stats: Dict[str, int]  # the daemon's statistics (loads, shared_hits, ...)
    usage: Dict[str, int]  # memory_usage() after the node retired: all zeros
    device: str            # where the node's database held its tensors


def serve(
    arch: str = "qwen2.5-3b",
    system: str = "sage",
    *,
    requests: int = 32,
    rate: float = 8.0,
    profile: str = "resnet50",
    time_scale: float = 0.2,
    seed: int = 0,
    device: str = "cuda",
) -> Served:
    gw = Gateway(backend="runtime", policy=system, time_scale=time_scale,
                 exit_ttl=5.0, device=device)
    gw.register(FunctionSpec(name=f"{arch}-fn", arch=arch, profile=profile))
    workload = PoissonWorkload(f"{arch}-fn", rate,
                               duration_s=4.0 * requests / rate, seed=seed,
                               max_events=requests)
    t0 = time.monotonic()
    tel = gw.replay(workload, seed=seed)
    wall = time.monotonic() - t0
    n = len(workload)
    print(f"[serve:{system}] {n} requests in {wall:.2f}s "
          f"({n/wall:.2f}/s) mean={tel.mean_e2e()*1e3:.1f}ms "
          f"p99={tel.p99_e2e()*1e3:.1f}ms warm%={tel.warm_fraction()*100:.0f} "
          f"shared_hits={gw.runtime.daemon.stats['shared_hits']}")
    usage = gw.runtime.drain()
    gw.shutdown()
    return Served(tel, dict(gw.runtime.daemon.stats), usage, str(gw.runtime.db.device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--system", default="sage")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--profile", default="resnet50")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve(args.arch, args.system, requests=args.requests, rate=args.rate,
                 profile=args.profile, device=args.device)


if __name__ == "__main__":
    main()
