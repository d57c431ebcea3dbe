"""Serving step factories (prefill / decode), as ``repro.serving.engine``.

The JAX steps are jit-able pure functions that return a new cache; these
run eagerly and fill the cache passed to them in place (``models.model``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, init_cache, prefill


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch: Dict[str, torch.Tensor], cache):
        logits, cache, _ = prefill(cfg, params, batch, cache)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, tokens: torch.Tensor, positions: torch.Tensor, cache):
        return decode_step(cfg, params, tokens, positions, cache)

    return serve_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0):
    """The cache pytree on the meta device: shapes and dtypes, no memory."""
    return init_cache(cfg, batch, max_len, enc_len, device="meta")
