"""Fault-tolerant training launcher (the JAX package's ``launch/train.py``).

* auto-resume from the newest atomic checkpoint (restart == recovery);
* per-step wall-time watchdog: an EWMA straggler detector flags steps
  slower than ``straggler_factor`` x the running mean (it logs and counts);
* deterministic data resume (a batch is a pure function of its step);
* optional simulated failure injection (``--fail-at-step``) proving the
  restart path end to end.

It runs on the card unless ``device="cpu"`` (``--device cpu``). The weights
are drawn from a CPU generator seeded with ``seed`` and moved to the
device, so a run on the card starts from the same weights as one on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --steps 50 --ckpt-dir <dir> [--no-resume] [--fail-at-step 20] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.slowness import EwmaDetector
from repro_torch.data.database import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.steps import init_train_state, make_train_step

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


class StragglerWatchdog:
    """EWMA step-time monitor: a thin wrapper over the shared
    :class:`~repro_torch.core.slowness.EwmaDetector`, so the serving-side
    gray-failure detector and the training watchdog judge stragglers with
    the same primitive and thresholds."""

    def __init__(self, factor: float = 2.5, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self._det = EwmaDetector(factor=factor, alpha=alpha)
        self.flagged = []

    @property
    def ewma(self) -> Optional[float]:
        return self._det.ewma

    def observe(self, step: int, dt: float) -> bool:
        baseline = self._det.ewma  # the EWMA this step is judged against
        is_straggler = self._det.observe(dt)
        if is_straggler:
            self.flagged.append((step, dt, baseline))
        return is_straggler


def train_loop(
    arch: str = "qwen2.5-3b",
    *,
    smoke: bool = True,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 64,
    ckpt_dir: str = DEFAULT_CKPT_DIR,
    ckpt_every: int = 10,
    resume: bool = True,
    fail_at_step: Optional[int] = None,
    microbatches: int = 1,
    lr: float = 1e-3,
    log_every: int = 10,
    seed: int = 0,
    device="cuda",
):
    """Train ``arch`` (its reduced config with ``smoke``) for ``steps``
    steps; returns (state, the losses of the steps run, the watchdog)."""
    device = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                              total_steps=steps)
    data = TokenPipeline(DataConfig(cfg.vocab_size, global_batch, seq_len, seed=seed))
    mgr = CheckpointManager(ckpt_dir, keep=2)

    state = init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(seed), device)
    start = 0
    if resume:
        latest, state = mgr.restore_latest(state)
        if latest is not None:
            start = latest
            print(f"[train] resumed from step {latest}")

    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    watchdog = StragglerWatchdog()
    losses = []
    for step in range(start, steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.monotonic()
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # the step's one read back to the host
        losses.append(loss)
        dt = time.monotonic() - t0
        if watchdog.observe(step, dt):
            print(f"[watchdog] step {step} straggled: {dt*1e3:.0f}ms "
                  f"(ewma {watchdog.ewma*1e3:.0f}ms)")
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            mgr.save(step + 1, state, extra={"loss": loss})
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
    return state, losses, watchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-resume", dest="resume", action="store_false")
    ap.add_argument("--fail-at-step", type=int)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train_loop(
        args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.global_batch, seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, fail_at_step=args.fail_at_step,
        microbatches=args.microbatches, device=args.device,
    )


if __name__ == "__main__":
    main()
