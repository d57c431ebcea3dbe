"""End-to-end training example on the PyTorch/CUDA port, as
examples/train_lm.py does for the JAX package: the deterministic token
pipeline, AdamW, atomic checkpoints, auto-resume and the straggler
watchdog, through ``repro_torch.launch.train.train_loop``. Attention runs
the hand-written flash-attention kernel and its backward kernel on the card.

Run:  python examples/torch_train_lm.py --tiny                 # on the card
      python examples/torch_train_lm.py --tiny --device cpu    # on the CPU
(without --tiny: a ~100M-parameter qwen-family model, 12L x 512d x 8H.)
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tiny:
        arch, smoke, gb, seq = "qwen2.5-3b", True, 8, 64
    else:
        # ~100M: qwen2.5 family geometry scaled down (12L x 512d x 8H)
        base = get_arch("qwen2.5-3b")
        cfg100m = dataclasses.replace(
            base, name="qwen2.5-100m", num_layers=12, d_model=512,
            num_heads=8, num_kv_heads=2, head_dim=64, d_ff=2048,
            vocab_size=32768, param_dtype="float32", compute_dtype="float32",
        )
        print(f"training {cfg100m.name}: {cfg100m.param_count()/1e6:.1f}M params")
        ARCHS[cfg100m.name] = cfg100m  # so train_loop can resolve it by name
        arch, smoke, gb, seq = cfg100m.name, False, 8, 256

    state, losses, wd = train_loop(
        arch, smoke=smoke, steps=args.steps, global_batch=gb, seq_len=seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10, lr=3e-4,
        device=args.device,
    )
    print(f"\nfinal loss: {losses[-1]:.4f} (from {losses[0]:.4f}); "
          f"stragglers flagged: {len(wd.flagged)}")
    return losses


if __name__ == "__main__":
    main()
