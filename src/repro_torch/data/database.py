"""In-memory 'database' (the paper uses MongoDB) with brokered fetch timing.

Values are real Python objects and ``torch.Tensor``s (model weight dicts,
inputs) kept on the host; fetch latency is modeled through the shared db
bandwidth broker using the *declared* A100-scale size, so contention behaves
like the paper's Fig 4 while payloads stay whatever size they really are.

The database owns the serving device: ``to_device`` is the daemon's
host -> device leg. It is ``"cuda"`` unless the caller asks for ``"cpu"``
(as the CPU tests do); asking for CUDA where there is none raises.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


class Database:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._kv: Dict[str, Any] = {}
        self._sizes: Dict[str, int] = {}

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
        dict/list/tuple goes to ``self.device``; other leaves pass through
        unchanged. The copy is blocking on the current stream, so the tensor
        is usable by any thread once this returns; a failing copy raises."""
        if isinstance(obj, torch.Tensor):
            return obj.to(self.device)
        if isinstance(obj, dict):
            return {k: self.to_device(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.to_device(v) for v in obj)
        return obj
