"""Taxon shim (paper §5.2): intercepts the function's GPU calls and
re-dispatches them by category — memory calls to the unified memory daemon,
kernel calls to the kernel executor.

TPU adaptation: the interception point is the runtime API the handler is
written against (SageLoadToGPU / SageDumpToDB / alloc / launch) rather than
the CUDA driver ABI; classification and forwarding semantics are the paper's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.daemon import Handle, MemoryDaemon
from repro_torch.core.request import Request


class TaxonShim:
    def __init__(self, daemon: MemoryDaemon, executor, request: Request,
                 handles: Dict[str, Handle]):
        self.daemon = daemon
        self.executor = executor
        self.request = request
        self._handles = handles  # pre-loaded by the engine's prepare()
        self.memory_calls = 0
        self.kernel_calls = 0

    # ---- memory calls (-> daemon) -------------------------------------
    def sage_load_to_gpu(self, key: str) -> Handle:
        """Async: returns immediately with a handle; the daemon may still be
        loading (§5.2.1: 'SageLoadToGPU is an asynchronous operation')."""
        self.memory_calls += 1
        h = self._handles.get(key)
        if h is None:
            # datum not declared in the request: load on demand (no overlap
            # benefit — this is the slow path the programming model avoids)
            for d in self.request.in_data:
                if d.key == key:
                    h = self.daemon.prepare(
                        type(self.request)(
                            function_name=self.request.function_name, in_data=[d]
                        )
                    )[key]
                    break
            else:
                raise KeyError(f"{key} not in request.in_data")
            self._handles[key] = h
        return h

    def cuda_malloc(self, key: str, nbytes: int) -> Handle:
        self.memory_calls += 1
        h = self.daemon.alloc(self.request, key, nbytes)
        self._handles[key] = h
        return h

    def sage_dump_to_db(self, key: str, value: Any, size: int = 0) -> None:
        self.memory_calls += 1
        self.daemon.db.put(key, value, size=size)

    # ---- kernel calls (-> executor) ------------------------------------
    def launch_kernel(self, fn, *args, **kwargs):
        """Forwarded to the kernel executor, which verifies with the daemon
        that every operand handle is ready before launching (§5.2.2)."""
        self.kernel_calls += 1
        return self.executor.launch(fn, args, kwargs)
