"""AdamW with a configurable state dtype, global-norm clipping and a cosine
LR schedule, over nested dicts of tensors: the JAX package's
``training/optimizer.py`` with the same arithmetic (fp32 math, fp32 bias
correction from an fp32 ``step``, weight decay only where ``p.ndim >= 2``).
Not ``torch.optim.AdamW``, whose decay and state differ in detail.

One deliberate difference: ``adamw_update`` updates the parameters and the
moments IN PLACE (and ``step``), and returns the same tensors. The JAX
update returns new arrays; at full width a second copy of the parameters
and the moments (31 GB for qwen2.5-3b) would not fit beside the first on
one 80 GB card. Each gradient is cast to fp32 leaf by leaf, inside the
update, so no fp32 copy of the whole gradient tree is ever made. Nothing
here reads a value back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.distributed.compat import is_dtensor, reduce_partials

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # 'bfloat16' for 400B-class archs
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, on fp32 tensors (as
    the JAX function computes it), a 0-d fp32 tensor."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(cfg: OptimizerConfig, params) -> Dict[str, Any]:
    dt = STATE_DTYPES[cfg.state_dtype]
    # zeros_like: a DTensor parameter gets moments placed as it is
    zeros = lambda p: torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)  # noqa: E731
    first = T.leaves(params)[0]
    return {
        "m": T.tree_map(zeros, params),
        "v": T.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, a 0-d fp32 tensor. For sharded
    leaves (``DTensor``s) each rank sums the squares of its own shard (a
    partial-sum gradient reduced first; a shard held by several ranks
    counted by one of them) and one all-reduce over the mesh adds the
    ranks' sums, so the norm, and the clip, are the one-rank norm's."""
    total = 0
    mesh = None
    for x in T.leaves(tree):
        if is_dtensor(x):
            mesh = x.device_mesh
            x = _owned_shard(x)
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    if mesh is not None:
        import torch.distributed._functional_collectives as funcol

        # the mesh spans the default group (every mesh of the port does)
        group = mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD
        total = funcol.all_reduce(total, "sum", group)
    return torch.sqrt(total)


def _owned_shard(x) -> torch.Tensor:
    """A ``DTensor``'s local shard if this rank is the first of those that
    hold it (coordinate 0 on every mesh dim it is replicated over), else
    an empty tensor; a partial sum is reduced first."""
    x = reduce_partials(x)
    coord = x.device_mesh.get_coordinate()
    local = x.to_local()
    if any(pl.is_replicate() and c != 0 for pl, c in zip(x.placements, coord)):
        return local[:0] if local.dim() else local.reshape(1)[:0]
    return local


@torch.no_grad()
def _update_leaf(cfg: OptimizerConfig, p, g, m, v, *, scale, lr, c1, c2) -> None:
    """One leaf's AdamW update, in place. Its fp32 temporaries, each of the
    leaf's size: the cast gradient (reused for the denominator) and the
    step, plus the fp32 values of a bf16 leaf and of bf16 moments."""
    b1, b2 = cfg.betas
    g32 = g.to(torch.float32, copy=True)
    if torch.is_tensor(scale):
        g32.mul_(scale)
    m32, v32 = m.to(torch.float32), v.to(torch.float32)  # the state itself when fp32
    m32.mul_(b1).add_(g32, alpha=1 - b1)
    v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)
    denom = torch.div(v32, c2, out=g32).sqrt_().add_(cfg.eps)  # vhat^1/2 + eps, in g32
    step_ = torch.div(m32, c1).div_(denom)
    del g32, denom
    p32 = p.to(torch.float32)  # p itself when fp32
    if p.ndim >= 2:  # no decay on norms/biases/scalars
        step_.add_(p32, alpha=cfg.weight_decay)
    p32.sub_(step_.mul_(lr))
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


def adamw_update(
    cfg: OptimizerConfig, grads, opt_state, params
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (params, opt_state, metrics): the same tensors as given,
    updated in place (see the module's note), and the pre-clip global
    gradient norm and the step's LR as 0-d fp32 tensors."""
    with torch.no_grad():
        step = opt_state["step"].add_(1)
        b1, b2 = cfg.betas
        gnorm = global_norm(grads)
        scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
                 if cfg.clip_norm else 1.0)
        lr = lr_at(cfg, step)
        # bias correction in fp32
        c1 = 1 - b1 ** step.to(torch.float32)
        c2 = 1 - b2 ** step.to(torch.float32)
        for p, g, m, v in zip(T.leaves(params), T.leaves(grads), T.leaves(opt_state["m"]),
                              T.leaves(opt_state["v"])):
            if is_dtensor(g) and g.placements != p.placements:
                # a sharded parameter's gradient, placed as the parameter
                # (FSDP: the reduce-scatter of a partial gradient)
                g = g.redistribute(p.device_mesh, p.placements)
            _update_leaf(cfg, p, g, m, v, scale=scale, lr=lr, c1=c1, c2=c2)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
