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

On the card the forward the context serves is also kept as a CUDA graph,
as the JAX package's executable is launched whole: the host's issue of a
full-width forward (thousands of launches) takes about the forward's
device time, so the card waits on it. A context captures its graph on the
second forward that can replay one (``ModelContext``: plain tensors, the
tokens at the shape the context was built for, the weights at the
addresses of that capture's call) and replays it from then on, with the
same kernels in the same order; every other call runs eagerly. The
graph's private memory pool is admitted by the node's memory daemon, as
context memory, before the graph is kept (the call runs eagerly where it
is not), and counted in ``reserved_bytes``; the graph and its bytes go
when the engine demotes the weights or releases the context's memory
(``ModelContext.release``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
from repro_torch.distributed.compat import is_dtensor
from repro_torch.kernels import capture as _capture
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import forward, init_params
from repro_torch.tree import leaves as tree_leaves

#: kernel launches made by context builds' warm-up forwards in this process,
#: by kernel name (also counted in each kernel's own ``launches``), and
#: the context builds, by function name
context_launches: Counter = Counter()
context_builds: Counter = Counter()
#: forwards on the card, by function name: captured into the context's
#: CUDA graph (and replayed once for that call's answer), replayed from
#: it, and run eagerly
graph_captures: Counter = Counter()
graph_replays: Counter = Counter()
eager_forwards: Counter = Counter()
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


#: the kernels a forward launches, by name
_KERNELS = {_fa.NAME: _fa, _ssd.NAME: _ssd}


def _pool_bytes(pool) -> int:
    """The bytes of the segments the caching allocator holds for ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


@dataclasses.dataclass
class _Graph:
    """A captured forward: the key of the call it was captured from, the
    graph, its static tokens and logits, the kernel calls captured into it
    by name, the bytes of its pool and the budget that admitted them."""
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor
    logits: torch.Tensor
    launches: dict
    pool_bytes: int
    budget: object = None


class ModelContext:
    """A built GPU context: the forward callable (``ctx(p, t)``) and what
    its build did (``build_s``, the warm-up's ``launches``, the bytes the
    caching allocator reserved beyond what it held before,
    ``reserved_bytes``). With a ``stream`` (on the card) the forward runs
    there, ordered after the work queued so far on the caller's stream,
    and the caller's stream waits for it, so that its output and inputs
    are the caller's to use and free as if it had run there: a block one
    stream frees is reused by that stream's later work only, which waits
    for the other's (every caller uses the default stream).

    On the card the forward is replayed from a CUDA graph where the call
    allows it: tokens of the ``shape`` the context was built for, and
    plain tensors (no ``DTensor``). Such a call is keyed by the tokens'
    dtype and each weight leaf's address, shape and dtype. The first call
    with a key runs eagerly; the next with the same key captures the
    graph (on a stream of its own, ``capture_stream``), and every later
    one replays it: the tokens are copied into the graph's static input,
    the graph is replayed on ``stream`` and its logits are copied out, so
    a later replay never overwrites what a caller holds. The graph is kept
    only if the ``budget`` the engine binds (``bind``: the node's memory
    daemon) grants its pool's bytes at once; where it does not, the key's
    calls run eagerly until the context is released. A call with another
    key drops the graph (weights reloaded to other addresses) and runs
    eagerly. The context's lock keeps two replays from overlapping. The
    kernel calls captured into the graph (``kernels.capture.tally``) are
    added to the kernels' ``launches`` after each replay;
    ``graph_captures``, ``graph_replays`` and ``eager_forwards`` count the
    forwards by ``name``."""

    def __init__(self, fwd, build_s: float, launches: dict, reserved_bytes: int,
                 stream=None, *, name: str = "", shape=None):
        self.fwd = fwd
        self.build_s = build_s
        self.launches = launches
        self.reserved_bytes = reserved_bytes
        self.stream = stream
        self.name = name
        self.shape = shape
        self.budget = None
        # held over the graph's state and each replay, and never while
        # calling the budget: a daemon may call ``release`` under its lock
        self._lock = threading.Lock()
        self._graph: Optional[_Graph] = None
        self._seen = None  # the key of the last call that ran eagerly
        self._refused = None  # the key whose graph the budget did not grant
        self._capturing = False
        self._released = 0  # ``release`` calls, so a capture sees one made meanwhile

    def __call__(self, p, t):
        # the host issuing the forward: the invocation's ``forward`` span
        with span("forward"):
            if self.stream is None:
                return self.fwd(p, t)
            caller = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                key = self._key(p, t)
                out = self._replayed(key, p, t) if key is not None else None
                if out is None:
                    with _ctx_lock:
                        eager_forwards[self.name] += 1
                    out = self.fwd(p, t)
            caller.wait_stream(self.stream)
            return out

    def bind(self, budget) -> None:
        """Have ``budget`` (with ``try_reserve_context(nbytes) -> bool`` and
        ``release_context(nbytes)``, as ``MemoryDaemon``) admit the pools of
        the graphs captured from now on; a context bound to none keeps its
        graph unasked."""
        self.budget = budget

    def release(self) -> None:
        """Drop the graph and give its pool's bytes back, as the engine
        demotes the weights (the exit ladder's stage 2) or releases the
        context's memory (stage 3, a node's teardown); the engine may keep
        the context itself, whose next calls capture again."""
        with self._lock:
            g = self._pop()
            self._seen = self._refused = None
            self._released += 1
        _give_back(g)

    def _pop(self) -> Optional[_Graph]:
        """Take the graph out, with the context's lock held; the caller
        gives its bytes back (``_give_back``) once the lock is let go."""
        g, self._graph = self._graph, None
        if g is not None:
            self.reserved_bytes -= g.pool_bytes
        return g

    def _key(self, p, t):
        """The call's graph key, or None where it cannot replay a graph."""
        if not t.is_cuda or is_dtensor(t) or tuple(t.shape) != self.shape:
            return None
        leaves = tree_leaves(p)
        if any(is_dtensor(x) for x in leaves):
            return None
        return t.dtype, tuple((x.data_ptr(), tuple(x.shape), x.dtype) for x in leaves)

    def _replayed(self, key, p, t):
        """The logits from the graph of ``key``, captured first if this key's
        last call ran eagerly; None where this call runs eagerly (as do the
        calls made while another captures)."""
        stale = None
        try:
            with self._lock:
                g = self._graph
                if g is not None and g.key != key:  # the weights moved
                    stale, g = self._pop(), None
                if g is not None:
                    return self._replay(g, t, graph_replays)
                if self._seen != key or self._refused == key or self._capturing:
                    self._seen = key
                    return None
                self._capturing, released = True, self._released
        finally:
            _give_back(stale)
        g = self._kept(key, p, t, released)
        if g is None:
            return None
        with self._lock:
            return self._replay(g, t, graph_captures)

    def _replay(self, g: _Graph, t, counter: Counter):
        """Replay ``g`` on ``t`` and copy its logits out, with the context's
        lock held; the kernel calls captured into it count as launched."""
        g.tokens.copy_(t)
        g.graph.replay()
        for name, n in g.launches.items():
            _KERNELS[name].add_launches(n)
        out = g.logits.clone()
        with _ctx_lock:
            counter[self.name] += 1
        return out

    def _kept(self, key, p, t, released: int) -> Optional[_Graph]:
        """Capture the graph of ``key`` and keep it if the budget grants its
        pool's bytes at once; None where it is not kept: the forward cannot
        be captured (the context stays eager), the budget refuses (the key
        stays eager until ``release``) or the context was released
        meanwhile. Called without the context's lock."""
        try:
            g = self._capture(key, p, t)
        except RuntimeError:  # the forward cannot be captured: never again
            g = None
        budget = self.budget
        granted = g is not None and (budget is None or budget.try_reserve_context(g.pool_bytes))
        with self._lock:
            self._capturing = False
            if g is None:
                self.shape = None
                return None
            if not granted:
                self._refused = key  # the graph and its pool go with ``g``
                return None
            if self._released == released:
                g.budget = budget
                self._graph = g
                self.reserved_bytes += g.pool_bytes
                return g
        g.budget = budget
        _give_back(g)
        return None

    def _capture(self, key, p, t) -> _Graph:
        """Capture the forward at ``t``'s shape on the device's capture
        stream, which no other work uses, in thread-local mode (the data
        plane's threads copy beside it). Its answer is not computed: the
        caller replays it. The collector is off meanwhile: an object whose
        finaliser calls CUDA (another context's graph) collected on this
        thread would end the capture."""
        tokens = torch.empty_like(t)
        graph = torch.cuda.CUDAGraph()
        cap = capture_stream(self.stream.device)
        with _capture_lock, torch.cuda.stream(cap):
            # this thread's cuBLAS handle and its workspace on this stream,
            # made outside the capture (and the graph's pool)
            torch.cuda.current_blas_handle()
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    with _capture.tally() as launched:
                        logits = self.fwd(p, tokens)
                finally:
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        return _Graph(key, graph, tokens, logits, dict(launched), _pool_bytes(graph.pool()))


def _give_back(g: Optional[_Graph]) -> None:
    """Give a dropped graph's pool bytes back to the budget that granted
    them. The graph itself goes with the last reference to it; a replay
    still running on the card finishes first."""
    if g is not None and g.budget is not None:
        g.budget.release_context(g.pool_bytes)


_streams: dict = {}


def compute_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream that every context's warm-up and forward on ``device``
    runs on, made at first use."""
    with _ctx_lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device)
        return _streams[device]


_capture_streams: dict = {}
_capture_lock = threading.Lock()  # one capture at a time on a capture stream


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream that contexts on ``device`` capture their graphs on, made
    at first use from the high-priority streams, which nothing else takes
    (the compute stream and the database's come from the others)."""
    with _ctx_lock:
        if device not in _capture_streams:
            _capture_streams[device] = torch.cuda.Stream(device, priority=-1)
        return _capture_streams[device]


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

        return ModelContext(fwd, time.monotonic() - t0, launched, reserved, stream,
                            name=fn_name, shape=(batch, seq))

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
