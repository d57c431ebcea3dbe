"""``input_specs``: meta-tensor stand-ins for every model input.

The JAX package's ``launch/specs.py`` returns ``jax.ShapeDtypeStruct``s;
here each input is ``torch.empty(shape, dtype=..., device="meta")``, which
carries a shape and a dtype and allocates nothing. The names, the dict keys,
the shapes and the dtypes are the JAX package's. The modality frontends
(whisper's mel conv, qwen2-vl's vision tower) are stubs there too: their
outputs (frame embeddings, M-RoPE position ids) appear here as inputs.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Inputs for a train or prefill step (full-sequence)."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {"tokens": _spec((B, S), torch.int32)}
    if shape.kind == "train":
        specs["loss_mask"] = _spec((B, S), torch.float32)
    if cfg.mrope_sections:
        specs["mrope_positions"] = _spec((3, B, S), torch.int32)
    if cfg.is_encoder_decoder:
        specs["encoder_embeds"] = _spec((B, enc_len_for(cfg, S), cfg.d_model),
                                        getattr(torch, cfg.compute_dtype))
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Inputs for one serve step: a new token per sequence and its position.

    The KV/SSM cache is passed separately (see ``serving.cache_shapes``)."""
    B = shape.global_batch
    return {"tokens": _spec((B, 1), torch.int32), "positions": _spec((B,), torch.int32)}


def enc_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Whisper's conv frontend downsamples mel frames 2x -> S_enc = S // 2."""
    return max(seq_len // 2, 1)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    return batch_input_specs(cfg, shape)
