"""In-memory 'database' (the paper uses MongoDB) with brokered fetch timing.

Values are real Python objects and ``torch.Tensor``s (model weight dicts,
inputs) kept on the host; fetch latency is modeled through the shared db
bandwidth broker using the *declared* A100-scale size, so contention behaves
like the paper's Fig 4 while payloads stay whatever size they really are.

The database owns the serving device: ``to_device`` is the daemon's
host -> device leg. It is ``"cuda"`` unless the caller asks for ``"cpu"``
(as the CPU tests do); asking for CUDA where there is none raises.

On a CUDA database that leg carries ``jax.device_put``'s semantics over:
``to_device`` copies from page-locked host memory on a stream of the
database's own, so no copy is queued on the stream that serves the
forwards, and the host holds no lock on that stream while the bytes move.
A model's weights are made page-locked once, where they are made
(``page_locked``: one buffer, its tensors views of it); a small pageable
payload (a request's tokens) is staged through PyTorch's caching pinned
allocator, whose blocks are reused from one copy to the next.
"""
from __future__ import annotations

import mmap
import threading
import time
import weakref
from typing import Any, Callable, Dict, List

import torch

#: each tensor's view in a page-locked buffer starts on a multiple of this
_ALIGN = 256
#: the bytes of one host -> device copy (about 5 ms on an H100's link).
#: The host keeps two queued, waiting for the older before it queues the
#: next: a lazy module load in a context build on another thread waits for
#: every copy queued, so it waits for two pieces, not for a model
_PIECE = 256 << 20


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def map_tensors(obj: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``obj`` with ``fn`` applied to every tensor in a nested
    dict/list/tuple/namedtuple, in order (the containers keep their types,
    as ``jax.device_put`` keeps a pytree's); other leaves pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        # a namedtuple takes its fields as arguments, not an iterable
        return type(obj)(*(map_tensors(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    return obj


def tensors(obj: Any) -> List[torch.Tensor]:
    """The tensors of ``obj``, in ``map_tensors``' order."""
    out: List[torch.Tensor] = []
    map_tensors(obj, out.append)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PageLocked:
    """One page-locked host buffer: anonymous pages registered with CUDA
    (``cudaHostRegister``), the bytes asked for rounded up to
    whole pages (PyTorch's pinned host allocator would round a block up to
    a power of two: 8.6 GB for a 6.2 GB model), faulted in when mapped
    (``MAP_POPULATE``). Tensors are views of it (``view``);
    each view keeps the buffer alive, and the pages are unregistered when
    the last view is gone, before they are unmapped. Registration failing
    raises."""

    def __init__(self, nbytes: int):
        self.nbytes = -(-max(nbytes, 1) // mmap.PAGESIZE) * mmap.PAGESIZE
        pages = mmap.mmap(-1, self.nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_POPULATE)
        self.bytes = torch.frombuffer(pages, dtype=torch.uint8)
        cudart = torch.cuda.cudart()
        ptr = self.bytes.data_ptr()
        torch.cuda.check_error(cudart.cudaHostRegister(ptr, self.nbytes, 0))
        weakref.finalize(self, cudart.cudaHostUnregister, ptr)

    def view(self, offset: int, like: torch.Tensor) -> torch.Tensor:
        """A contiguous tensor of ``like``'s dtype and shape at ``offset``
        bytes (a multiple of its element size), holding this buffer."""
        v = self.bytes[offset:offset + _nbytes(like)].view(like.dtype).view(like.shape)
        v._page_locked = self  # the pages stay registered while the view lives
        return v


def page_locked(obj: Any) -> Any:
    """``obj`` with its tensors (on any device) copied into one
    ``PageLocked`` buffer as views (``obj`` itself where it holds no
    tensor)."""
    srcs = tensors(obj)
    if not srcs:
        return obj
    offsets, n = [], 0
    for t in srcs:
        offsets.append(n)
        n += -(-_nbytes(t) // _ALIGN) * _ALIGN
    buf = PageLocked(n)
    at = iter(offsets)

    def place(t):
        v = buf.view(next(at), t)
        v.copy_(t)
        return v

    return map_tensors(obj, place)


class Database:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._kv: Dict[str, Any] = {}
        self._sizes: Dict[str, int] = {}
        # the host -> device copies' own stream (CUDA only)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # what ``to_device`` moved: the bytes of the host tensors it put on
        # the device, and the host seconds spent in it (the daemon's loader
        # threads call it concurrently; updated under the lock)
        self.h2d_bytes = 0
        self.h2d_s = 0.0

    @property
    def page_locked_bytes(self) -> int:
        """Bytes of the ``PageLocked`` buffers that the payloads this
        database holds are views of."""
        with self._lock:
            values = list(self._kv.values())
        bufs = {id(b): b.nbytes for v in values for t in tensors(v)
                if (b := getattr(t, "_page_locked", None)) is not None}
        return sum(bufs.values())

    def put(self, key: str, value: Any, size: int = 0) -> None:
        with self._lock:
            self._kv[key] = value
            self._sizes[key] = size

    def size_of(self, key: str) -> int:
        return self._sizes.get(key, 0)

    def fetch(self, key: str, broker=None, *, scale: float = 1.0) -> Any:
        if broker is not None:
            broker.transfer(self._sizes.get(key, 0), scale=scale)
        with self._lock:
            return self._kv.get(key)

    def to_device(self, obj: Any) -> Any:
        """Host -> device materialization: every tensor in a nested
        dict/list/tuple/namedtuple goes to ``self.device`` (``map_tensors``);
        other leaves pass through unchanged. The tensors are usable by any
        thread once this returns; a failing copy raises.

        On a CUDA database, as ``jax.device_put`` copies: each host tensor's
        destination is allocated on the calling thread's current stream
        (the default stream, whose blocks it will go back to; the
        runtime's forwards run on ``core.functions.compute_stream``, whose
        blocks it cannot take); the copies run on the database's stream,
        from page-locked memory (a pageable or non-contiguous tensor is
        first copied into a block of PyTorch's caching pinned allocator),
        in ``non_blocking`` pieces of at most ``_PIECE`` bytes, two queued
        at a time, ordered after the work queued so far on the calling
        stream (which may have used those blocks); the host returns once
        the last piece is done. Adds to ``h2d_bytes`` and ``h2d_s``."""
        t0 = time.monotonic()
        if self.device.type != "cuda":
            out = map_tensors(obj, lambda t: t.to(self.device))
            self._count(sum(_nbytes(t) for t in tensors(obj) if t.device.type == "cpu"), t0)
            return out
        copies = []

        def stage(t):
            if t.device.type != "cpu":
                return t.to(self.device)
            src = t if t.is_pinned() and t.is_contiguous() else t.contiguous().pin_memory()
            copies.append((src, torch.empty_like(src, device=self.device)))
            return copies[-1][1]

        out = map_tensors(obj, stage)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        prev = None
        with torch.cuda.stream(self._stream):
            for src, dst in copies:
                s, d = src.view(-1).view(torch.uint8), dst.view(-1).view(torch.uint8)
                for a in range(0, s.numel(), _PIECE):
                    d[a:a + _PIECE].copy_(s[a:a + _PIECE], non_blocking=True)
                    done = torch.cuda.Event()  # waited for by spinning
                    done.record()
                    if prev is not None:
                        prev.synchronize()
                    prev = done
        if prev is not None:
            prev.synchronize()
        self._count(sum(_nbytes(src) for src, _ in copies), t0)
        return out

    def _count(self, nbytes: int, t0: float) -> None:
        with self._lock:
            self.h2d_bytes += nbytes
            self.h2d_s += time.monotonic() - t0
