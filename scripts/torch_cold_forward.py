"""Where a fresh process's first forward spends its time, on the card.

In a new process: build or load the kernel libraries, draw ``--arch``'s
weights on the card from seed 0 (full width, or ``--reduced``), optionally
run the GPU context's warm-up (``core.functions.warm_up``: one period of
layers on zero weights at the request's shapes), then time forwards at
``--batch`` x ``--seq`` one after another, each under ``torch.profiler``
and between CUDA events. Prints one JSON line per forward: its wall and
device milliseconds and the operators with the most host time (lazy module
loads show as "Runtime Triggered Module Loading").

    python scripts/torch_cold_forward.py                  # qwen2.5-3b, 4 x 1024
    python scripts/torch_cold_forward.py --warm-up        # the same after the context's warm-up
    python scripts/torch_cold_forward.py --arch mamba2-780m --reduced --batch 1 --seq 16
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--warm-up", action="store_true")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_cold_forward: no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.core.functions import warm_up
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import forward, init_params

    cfg = ARCHS[args.arch].reduced() if args.reduced else ARCHS[args.arch]
    dev = torch.device("cuda")
    for k in (flash_attention, ssd_scan):
        k.load()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq), dtype=torch.int32,
                           device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    if args.warm_up:
        t0 = time.monotonic()
        warm_up(cfg, args.batch, args.seq, dev)
        print(json.dumps({"warm_up_ms": (time.monotonic() - t0) * 1e3}), flush=True)
    for i in range(args.forwards):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            start.record()
            with torch.inference_mode():
                forward(cfg, params, {"tokens": tokens})
            end.record()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:args.top]
        print(json.dumps({
            "arch": cfg.name, "forward": i, "wall_ms": wall_ms,
            "device_span_ms": start.elapsed_time(end), "warm_up": args.warm_up,
            "top_host_ms": {e.key: e.self_cpu_time_total / 1e3 for e in rows},
            "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
