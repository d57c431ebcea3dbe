"""Train-step factories (the JAX package's ``training/steps.py``).

``make_train_step`` builds the single-device step: loss -> gradients (one
backward through the model; optional microbatch accumulation in fp32) ->
AdamW.

``make_dp_compressed_step`` builds the data-parallel step over a
``torch.distributed`` group: every rank holds the whole parameters and
passes its own rows of the batch, and the gradients are all-reduced in int8
with error feedback (``compression.compress_allreduce``).

The JAX steps take gradients with ``jax.value_and_grad``; here one
``torch.autograd.grad`` call over the parameter leaves, which the step marks
``requires_grad``. As ``adamw_update`` does, a step updates the state's
tensors in place and returns the same dict.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.data.database import resolve_device
from repro_torch.distributed.compat import is_dtensor
from repro_torch.training import compression
from repro_torch.training.loss import lm_loss
from repro_torch.training.optimizer import OptimizerConfig, adamw_init, adamw_update

TrainState = Dict[str, Any]
METRIC_KEYS = ("loss", "z_loss", "aux_loss", "total_loss", "tokens")


def init_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                     generator: torch.Generator, device="cuda") -> TrainState:
    """{"params", "opt"}. The weights are drawn on the generator's device
    and moved to ``device``, so a CPU generator gives the same weights on
    every device."""
    from repro_torch.models import init_params

    device = resolve_device(device)
    params = init_params(cfg, generator, generator.device)
    if generator.device != device:
        params = T.tree_map(lambda p: p.to(device), params)
    return {"params": params, "opt": adamw_init(opt_cfg, params)}


def _value_and_grad(cfg: ModelConfig, params, batch) -> Tuple[Dict, List[torch.Tensor]]:
    """(metrics, the gradient of every parameter leaf in flatten order, in
    the leaf's dtype; zeros for a leaf the loss does not reach)."""
    leaves = T.leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        total, metrics = lm_loss(cfg, params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in metrics.items()}, grads


def _split(x: torch.Tensor, B: int, microbatches: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``x``'s batch-sized axis (axis 0 for tokens and
    masks; axis 1 for (3, B, S) M-RoPE position ids), as the JAX ``split``
    cuts it."""
    ax = 0 if x.shape[0] == B else next(a for a, d in enumerate(x.shape) if d == B)
    if is_dtensor(x):  # each rank cuts its own rows (distributed.local)
        from repro_torch.distributed import local
        return local.narrow_batch(x, ax, microbatches, i)
    n = B // microbatches
    return x.narrow(ax, i * n, n)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    *,
    microbatches: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict]]:
    """Single-device train step: loss -> grads (fp32 accum) -> AdamW."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if microbatches == 1:
            metrics, grads = _value_and_grad(cfg, params, batch)
        else:
            B = batch["tokens"].shape[0]
            gsum = [torch.zeros_like(p, dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
                    for p in T.leaves(params)]
            msum = None
            for i in range(microbatches):
                mbatch = {k: _split(v, B, microbatches, i) for k, v in batch.items()}
                met, g = _value_and_grad(cfg, params, mbatch)
                for acc, gi in zip(gsum, g):
                    acc.add_(gi)
                msum = met if msum is None else {k: msum[k] + met[k] for k in msum}
            grads = [g.div_(microbatches) for g in gsum]
            metrics = {k: v / microbatches for k, v in msum.items()}
            metrics["tokens"] = msum["tokens"]
        grads = T.unflatten(params, grads)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, grads, state["opt"], params)
        metrics.update(opt_metrics)
        return {**state, "params": new_params, "opt": new_opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# DP + int8-compressed gradient all-reduce (replicated params)
# ---------------------------------------------------------------------------


def init_dp_state(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                  generator: torch.Generator, device="cuda") -> TrainState:
    state = init_train_state(cfg, opt_cfg, generator, device)
    state["residuals"] = compression.init_residuals(state["params"])
    return state


def make_dp_compressed_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    group=None,
    *,
    compress: bool = True,
):
    """Data-parallel step over ``group`` (the default process group when
    None): params replicated, each rank passes its own rows of the batch,
    gradients all-reduced in int8 with error feedback (or meaned in fp32
    with ``compress=False``), metrics meaned over the group."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        n = dist.get_world_size(group)
        metrics, grads = _value_and_grad(cfg, params, batch)
        grads = T.unflatten(params, grads)
        if compress:
            grads, new_res = compression.compress_allreduce(grads, state["residuals"], group)
        else:
            def mean(g):
                g = g.to(torch.float32)
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
                return g / n
            grads = T.tree_map(mean, grads)
            new_res = state["residuals"]
        stacked = torch.stack([metrics[k].to(torch.float32) for k in METRIC_KEYS])
        dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
        metrics = dict(zip(METRIC_KEYS, (stacked / n).unbind()))
        new_params, new_opt, om = adamw_update(opt_cfg, grads, state["opt"], params)
        metrics.update(om)
        return {"params": new_params, "opt": new_opt, "residuals": new_res}, metrics

    return step
