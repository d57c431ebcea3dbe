"""The control of the check, at a cell's own size, on the card: for each
seed, the configuration's reference computed with its products in fp8 (one
precision below the bf16 the configurations serve in), put in the program's
place: its answers for each of the run's prompts, judged against the
float32 reference exactly as the window's answers are (``check.gap``).
With ``--margins`` (a configuration with experts) it also prints the gap of
the float32 reference whose router input alone is rounded to bf16 (how far
routing flips alone move the answers), and per layer how close the
reference's routing came to a tie: the smallest margins between the 8th and
the 9th router probability of a token, and the share of tokens whose margin
is under each of ``TIE_LEVELS``.

    python3 sagebench/tools/control.py --config olmoe-1b-7b --traffic zipf4_olmoe \
        --seeds 11,12,13
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "sagebench"), str(ROOT / "src")]

TIE_LEVELS = (1e-6, 1e-5, 1e-4, 1e-3)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--margins", action="store_true")
    args = ap.parse_args()

    import torch

    from harness import check, manifest, traffic, weights

    config, mix = manifest.config(args.config), manifest.mix(args.traffic)
    ref = manifest.reference(args.config)
    m = config["model"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.monotonic()
        W = weights.make(ref.layout(m), seed, args.device)
        prompts = traffic.prompts(mix, m["vocab_size"], seed, args.device)
        gaps, margins, flips = [], [], []
        for p in range(prompts.shape[0]):
            probe = [] if args.margins else None
            kw = {"probe": probe} if probe is not None else {}
            want = ref.forward_last(W, prompts[p], m, "fp32", **kw)
            got = ref.forward_last(W, prompts[p], m, "fp8")
            gaps.append(check.gap(got[:, :8].cpu().numpy(), want))
            if probe:
                margins.append(probe)
                rounded = ref.forward_last(W, prompts[p], m, "fp32", round_router=True)
                flips.append(check.gap(rounded[:, :8].cpu().numpy(), want))
        line = {"config": args.config, "seed": seed, "control_gap": max(gaps),
                "control_gaps": gaps, "seconds": time.monotonic() - t}
        if margins:
            line["router_rounding_gap"] = max(flips)
            line["router_rounding_gaps"] = flips
            per_layer = []
            for layer in range(len(margins[0])):
                ms = torch.cat([pm[layer] for pm in margins])
                per_layer.append({"min": float(ms.min()),
                                  **{f"under_{lv:g}": float((ms < lv).float().mean())
                                     for lv in TIE_LEVELS}})
            line["router_margins"] = per_layer
        print(json.dumps(line), flush=True)
        del W, prompts
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
