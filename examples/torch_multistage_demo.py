"""Multi-stage resource exit on the PyTorch/CUDA port, live (paper §6.3 /
Table 4), as examples/multistage_demo.py does for the JAX package: invoke
through the gateway, then watch the ladder demote resources stage by
stage; hit each stage with a new request and see which setup phases it
skips. Beside the gateway's declared memory it prints the card's real
allocated bytes (``torch.cuda.memory_allocated``) when it runs there.

Run:  python examples/torch_multistage_demo.py                # on the card
      python examples/torch_multistage_demo.py --device cpu   # on the CPU
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import FunctionSpec, Gateway  # noqa: E402

TTL = 0.6  # compressed 30 s -> 0.6 s per stage for the demo


def mem(gw, device):
    u = gw.memory_usage()
    line = (f"device={u['device_used']/2**20:6.0f}MB ctx={u['context_bytes']/2**20:4.0f}MB "
            f"host={u['host_used']/2**20:6.0f}MB")
    if torch.device(device).type == "cuda":
        line += f" allocated={torch.cuda.memory_allocated()/2**20:6.1f}MB"
    return line


def main(device: str = "cuda") -> list:
    """Walk the ladder on ``device``; returns the records of the cold
    request and of the hit at each stage."""
    gw = Gateway(backend="runtime", policy="sage", time_scale=0.05,
                 exit_ttl=TTL, device=device)
    gw.register(FunctionSpec(name="f", arch="qwen2.5-3b", profile="resnet50"))

    print("cold invocation:")
    r = gw.invoke("f", seed=0)
    records = [r]
    print(f"  e2e={r.e2e*1e3:7.1f}ms  {mem(gw, device)}")

    # each warm hit resets the ladder, so the wait before hit k must span
    # k-1 full stage TTLs to land in stage k (the ladder advance is a
    # mechanism-layer peek; load itself goes through the gateway)
    for stage, wait in ((1, 0.5 * TTL), (2, 1.5 * TTL), (3, 2.5 * TTL),
                        (4, 3.5 * TTL)):
        time.sleep(wait)
        gw.runtime.engines["f"]._advance_ladders()
        print(f"after stage-{stage} window: {mem(gw, device)}")
        r = gw.invoke("f", seed=stage)
        records.append(r)
        print(f"  warm hit at stage {r.warm_stage}: e2e={r.e2e*1e3:7.1f}ms "
              f"(gpu_ctx={r.stages.get('gpu_ctx', 0)*1e3:.1f}ms "
              f"gpu_data={r.stages.get('gpu_data', 0)*1e3:.1f}ms)")
    gw.runtime.drain()
    gw.shutdown()
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
