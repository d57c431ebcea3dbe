"""Builders turning model-zoo architectures into serverless GPUFunctions.

The real runtime serves *actual* models: the GPU context is the loaded
kernel library (built once per process from ``kernels/csrc``) plus the
forward callable, weights are a real dict of tensors fetched from the
database, compute is the real forward pass with the hand-written attention
kernel on the card. Declared sizes (A100-scale, from paper Table 2 profiles
or the arch's true byte count) drive the brokered transfer times and memory
accounting.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import GPUFunction
from repro_torch.core.profiles import MB, FunctionProfile
from repro_torch.core.request import Data, DataType, Request
from repro_torch.data.database import Database
from repro_torch.kernels import flash_attention as _fa
from repro_torch.models import forward, init_params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _host_params(cfg: ModelConfig, seed: int, device: torch.device) -> dict:
    """Seeded weights kept on the host. On a CUDA database they are drawn
    on the card (a CUDA generator; far faster than the CPU at full width)
    and copied back one leaf at a time, so the daemon's load is a real
    host -> device copy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    if device.type == "cpu":
        return params

    def to_host(tree):
        if isinstance(tree, dict):
            return {k: to_host(v) for k, v in tree.items()}
        return tree.cpu()

    return to_host(params)


def make_model_function(
    db: Database,
    fn_name: str,
    arch: str = "qwen3-8b",
    *,
    batch: int = 1,
    seq: int = 16,
    profile: Optional[FunctionProfile] = None,
    declared_ro_bytes: Optional[int] = None,
    seed: int = 0,
) -> GPUFunction:
    """Build an inference GPUFunction backed by a reduced ``arch`` model."""
    return _model_function(db, fn_name, ARCHS[arch].reduced(), batch=batch,
                           seq=seq, profile=profile,
                           declared_ro_bytes=declared_ro_bytes, seed=seed)


def _model_function(
    db: Database,
    fn_name: str,
    cfg: ModelConfig,
    *,
    batch: int = 1,
    seq: int = 16,
    profile: Optional[FunctionProfile] = None,
    declared_ro_bytes: Optional[int] = None,
    seed: int = 0,
) -> GPUFunction:
    """``make_model_function`` for any dense ``cfg`` (full width included)."""
    params = _host_params(cfg, seed, db.device)
    real_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    ro_bytes = declared_ro_bytes or (
        int(profile.read_only_mb * MB) if profile else real_bytes
    )
    weights_key = f"{fn_name}/weights"
    db.put(weights_key, params, size=ro_bytes)
    on_card = db.device.type == "cuda"

    def context_builder():
        # the 'GPU context': shape-only work that never touches the weights
        # (the knowability property that makes parallel setup possible) —
        # build or load the kernel library the forward will launch
        if on_card:
            _fa.load()

        def fwd(p, t):
            # inference_mode is thread-local: entered on the executor thread
            with torch.inference_mode():
                return forward(cfg, p, {"tokens": t})[0]

        return fwd

    def handler(shim, request: Request):
        w = shim.sage_load_to_gpu(weights_key)
        x = shim.sage_load_to_gpu(request.in_data[1].key)
        logits = shim.launch_kernel(shim.gpu_ctx, w, x)
        out_key = f"{fn_name}/out/{request.uuid}"
        shim.sage_dump_to_db(out_key, logits[:, -1, :8].float().cpu().numpy())
        return out_key

    return GPUFunction(
        name=fn_name,
        handler=handler,
        context_builder=context_builder,
        read_only={weights_key: ro_bytes},
        writable_hint=int(profile.writable_mb * MB) if profile else batch * seq * 4,
        compute_s_hint=(profile.compute_ms / 1e3) if profile else 0.0,
    )


def make_request(
    db: Database,
    fn: GPUFunction,
    *,
    batch: int = 1,
    seq: int = 16,
    input_bytes: int = 4 * MB,
    vocab: int = 256,
    seed: int = 0,
) -> Request:
    """A request whose metadata declares everything loadable (Fig 8)."""
    tokens = np.random.default_rng(seed).integers(0, vocab, (batch, seq), dtype=np.int32)
    req = Request(function_name=fn.name)
    in_key = f"{fn.name}/in/{req.uuid}"
    db.put(in_key, torch.from_numpy(tokens), size=input_bytes)
    ro_key = next(iter(fn.read_only))
    req.in_data = [
        Data(key=ro_key, size=fn.read_only[ro_key], dtype=DataType.READ_ONLY),
        Data(key=in_key, size=input_bytes, dtype=DataType.WRITABLE),
    ]
    return req
