"""Next-token cross-entropy with z-loss and MoE aux-loss folding (the JAX
package's ``training/loss.py``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compat import is_dtensor
from repro_torch.models import forward


def lm_loss(
    cfg: ModelConfig,
    params,
    batch: Dict[str, torch.Tensor],
    *,
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE. ``batch['tokens']`` (B,S); optional
    ``batch['loss_mask']`` (B,S) — position i masks prediction OF token i.
    Returns (total, metrics): 0-d fp32 tensors, nothing read back."""
    logits, aux = forward(cfg, params, batch)  # (B,S,V) fp32
    tokens = batch["tokens"]
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    mask = batch.get("loss_mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
            if mask is None else mask[:, 1:].to(torch.float32))

    if is_dtensor(logits):  # vocab-sharded: each rank sums and gathers what it holds
        from repro_torch.distributed import local
        lse = local.logsumexp(logits)  # (B,S-1)
        tgt_logit = local.target_logits(logits, targets)
    else:
        lse = torch.logsumexp(logits, dim=-1)  # (B,S-1)
        tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = lse - tgt_logit
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (ce * mask).sum() / denom
    zl = z_loss * ((lse**2) * mask).sum() / denom
    total = loss + zl + cfg.router_aux_loss * aux
    metrics = {
        "loss": loss,
        "z_loss": zl,
        "aux_loss": aux,
        "total_loss": total,
        "tokens": denom,
    }
    return total, metrics
