"""Builders turning model-zoo architectures into serverless GPUFunctions.

The real runtime serves *actual* models: weights are a real dict of
tensors fetched from the database, compute is the real forward pass with
the hand-written kernels on the card (flash attention for attention
mixers, the SSD scan for Mamba2 mixers). Declared sizes (A100-scale, from
paper Table 2 profiles or the arch's true byte count) drive the brokered
transfer times and memory accounting.

The GPU context is the JAX package's AOT compile at the request's shapes
carried over to eager PyTorch: the kernel libraries are built or loaded,
then a warm-up forward runs at the request's (batch, seq) on zero-filled
weights of ONE period of layers plus the embedding and the unembedding
(every period has the same shapes), and its results are dropped. That
pays, before the weights are on the card, what the first forward would
otherwise pay on its critical path: the lazy loads of every kernel module
the forward launches, the cuBLAS handle and GEMM choices at the
forward's shapes, and the caching allocator's first blocks for the
activations. It reads only ``cfg`` and the shapes, never the weights
(under SAGE they are still loading), so it overlaps the load. The
warm-up's buffers go back to the caching allocator when it ends (nothing
stays allocated for the context) and serve the forward's activations;
the bytes the allocator then holds in reserve beyond what it held before
are ``ModelContext.reserved_bytes``, beside the declared
``GPUFunction.context_bytes``. The warm-up's kernel launches are counted
apart in ``context_launches``.

On the card every context's warm-up and forward run on one compute
stream per device (``compute_stream``), as XLA runs its executables on
the device's compute stream. The caching allocator keeps each stream's
free blocks apart, so the weights' copy, whose destinations are
allocated on the loader's stream, cannot take the blocks a warm-up left
for the forward. Under FixedGSL that copy runs between the build and the
first forward; when both shared the default stream's blocks, the copy
took some, and a fresh process's first full-width qwen2.5-3b forward
called cudaMalloc for a new 2.49 GB segment for its logits inside its
compute stage (on an H100 80GB HBM3 at 700 W, PERF.md §6).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import GPUFunction
from repro_torch.core.profiles import MB, FunctionProfile
from repro_torch.core.request import Data, DataType, Request
from repro_torch.core.telemetry import span
from repro_torch.data.database import Database, page_locked
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import forward, init_params

#: kernel launches made by context builds' warm-up forwards in this process,
#: by kernel name (also counted in each kernel's own ``launches``), and
#: the context builds, by function name
context_launches: Counter = Counter()
context_builds: Counter = Counter()
_ctx_lock = threading.Lock()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _host_params(cfg: ModelConfig, seed: int, device: torch.device) -> dict:
    """Seeded weights kept on the host. On a CUDA database they are drawn
    on the card (a CUDA generator; far faster than the CPU at full width)
    and copied back into one page-locked buffer (``database.page_locked``),
    once, so the daemon's load is a real host -> device copy from
    page-locked memory."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    return params if device.type == "cpu" else page_locked(params)


def warmup_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` cut to one period of layers: the warm-up forward's model."""
    return dataclasses.replace(cfg, num_layers=cfg.period_len)


def warmup_launches(cfg: ModelConfig) -> dict:
    """The kernel launches of one warm-up forward of ``cfg`` on the card."""
    one = warmup_config(cfg)
    return {_fa.NAME: one.num_attn_layers, _ssd.NAME: one.num_mamba_layers}


class ModelContext:
    """A built GPU context: the forward callable (``ctx(p, t)``) and what
    its build did (``build_s``, the warm-up's ``launches``, the bytes the
    caching allocator reserved beyond what it held before,
    ``reserved_bytes``). With a ``stream`` (on the card) the forward runs
    there, ordered after the work queued so far on the caller's stream,
    and the caller's stream waits for it, so that its output and inputs
    are the caller's to use and free as if it had run there: a block one
    stream frees is reused by that stream's later work only, which waits
    for the other's (every caller uses the default stream)."""

    def __init__(self, fwd, build_s: float, launches: dict, reserved_bytes: int,
                 stream=None):
        self.fwd = fwd
        self.build_s = build_s
        self.launches = launches
        self.reserved_bytes = reserved_bytes
        self.stream = stream

    def __call__(self, p, t):
        # the host issuing the forward: the invocation's ``forward`` span
        with span("forward"):
            if self.stream is None:
                return self.fwd(p, t)
            caller = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                out = self.fwd(p, t)
            caller.wait_stream(self.stream)
            return out


_streams: dict = {}


def compute_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream that every context's warm-up and forward on ``device``
    runs on, made at first use."""
    with _ctx_lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device)
        return _streams[device]


def warm_up(cfg: ModelConfig, batch: int, seq: int, device: torch.device) -> dict:
    """One forward of ``warmup_config(cfg)`` at (batch, seq) on zero-filled
    weights on ``device``, its results dropped; on the card it waits for
    its own work. Returns the kernel launches it made."""
    one = warmup_config(cfg)
    # drawn on the device and zeroed: the same shapes as ``param_shapes``,
    # whose ``meta`` constants (Mamba2's log-spaced A) cost seconds of
    # decomposition set-up in a fresh process
    zeros = init_params(one, torch.Generator(device=device).manual_seed(0), device)
    for leaf in _leaves(zeros):
        leaf.zero_()
    tokens = torch.zeros((batch, seq), dtype=torch.int32, device=device)
    with torch.inference_mode():
        forward(one, zeros, {"tokens": tokens})
    del zeros, tokens
    if device.type != "cuda":
        return {}
    # the warm-up's own work, not the whole device's: under SAGE the
    # weights' copies run beside it on the database's stream
    torch.cuda.current_stream(device).synchronize()
    launched = {k: n for k, n in warmup_launches(cfg).items() if n}
    with _ctx_lock:
        context_launches.update(launched)
    return launched


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
    """``make_model_function`` for any ``cfg`` whose forward takes tokens
    alone (every family but encoder-decoder, as in the JAX package), full
    width included."""
    params = _host_params(cfg, seed, db.device)
    real_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    ro_bytes = declared_ro_bytes or (
        int(profile.read_only_mb * MB) if profile else real_bytes
    )
    weights_key = f"{fn_name}/weights"
    db.put(weights_key, params, size=ro_bytes)
    # the kernel libraries this cfg's forward launches on the card
    kernels = []
    if db.device.type == "cuda":
        mixers = {s.mixer for s in cfg.period_spec()}
        kernels = [k for k, m in ((_fa, "attn"), (_ssd, "mamba")) if m in mixers]

    def context_builder():
        # the 'GPU context': shape-only work that never touches the weights
        # (the knowability property that makes parallel setup possible) —
        # build or load the kernel libraries the forward will launch, then
        # the warm-up forward at the request's shapes
        t0 = time.monotonic()
        cuda = db.device.type == "cuda"
        held = torch.cuda.memory_reserved(db.device) if cuda else 0
        for k in kernels:
            k.load()
        stream = compute_stream(db.device) if cuda else None
        if cuda:
            stream.wait_stream(torch.cuda.current_stream(db.device))
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            launched = warm_up(cfg, batch, seq, db.device)
        with _ctx_lock:
            context_builds[fn_name] += 1
        reserved = torch.cuda.memory_reserved(db.device) - held if cuda else 0

        def fwd(p, t):
            # inference_mode is thread-local: entered on the executor thread
            with torch.inference_mode():
                return forward(cfg, p, {"tokens": t})[0]

        return ModelContext(fwd, time.monotonic() - t0, launched, reserved, stream)

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
