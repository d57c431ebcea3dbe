"""Kernel executor (paper §5.2.2): receives kernel calls from the taxon
shim, verifies with the memory daemon that all operand data is resident on
device, then launches. This is the correctness barrier that makes the
parallelized cold setup safe.

Failure contract: if a daemon loader failed (or was cancelled), resolving
the operand raises :class:`DataLoadError` out of ``launch`` — the launch
never blocks on an entry whose loader is already dead. ``wait_timeout``
additionally bounds waits on *live* loads (None = unbounded, the daemon's
own load deadline is the backstop)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core.daemon import DataLoadError, Handle
from repro_torch.core.telemetry import span


class KernelExecutor:
    def __init__(self, clock=None, wait_timeout: Optional[float] = None):
        self.clock = clock
        self.wait_timeout = wait_timeout

    def _resolve(self, x):
        if isinstance(x, Handle):
            return x.wait(self.wait_timeout)
        return x

    def launch(self, fn, args: Tuple, kwargs: Dict) -> Any:
        # the wait for the operands is the invocation's ``data_wait`` span
        with span("data_wait"):
            rargs = [self._resolve(a) for a in args]
            rkwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        return fn(*rargs, **rkwargs)
