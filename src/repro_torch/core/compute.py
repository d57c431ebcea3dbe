"""Shared GPU compute plane: fractional SM slicing + same-function batching
(docs/compute.md).

The memory plane already shares read-only/context bytes across invocations;
this module shares the *compute* stage the same way, behind one knob set
(``compute=``) riding the usual spec/gateway adopt-or-refuse plumbing.
Defaults off (``compute="exclusive"``) keep both drivers bit-identical to
the seed — the plane is only ever consulted when a :class:`ComputeConfig`
with ``mode="shared"`` is attached.

Two cooperating mechanisms, HAS-GPU-style (PAPERS.md):

* **Spatial slicing** — a node's SM budget is quantized into
  ``ComputeConfig.slices`` equal slices. A function needs ``k`` slices
  (from its declared ``sm_fraction``, or auto-derived from its profiled
  compute stage); the plane packs co-running invocations deterministically
  and stretches a granted-short invocation's compute span by ``k/granted``.
  Small functions co-run on one GPU instead of serializing behind the
  seed's exclusive compute FIFO.
* **Same-function batching** — concurrent invocations of one function on
  one node coalesce into a single kernel launch over stacked inputs (the
  Pallas kernels in ``src/repro/kernels/`` all grid over the batch axis).
  A batch of ``n`` costs ``compute_s * (1 + batch_marginal * (n - 1))``
  total — the marginal cost of an extra batch row is pinned by
  ``benchmarks/kernel_bench.py``'s batch-axis sweep — so the per-member
  amortized span shrinks toward ``batch_marginal * compute_s``. The
  collection window is deadline-aware: a member is never held past its
  EDF slack (``arrival + deadline - now``, charged the worst-case stacked
  span).

Both drivers consume this module byte-for-byte: the simulator attaches a
:class:`ComputePlane` per :class:`~repro_torch.core.sim.domain.GPUNode` (virtual
time, event-driven :class:`BatchCollector`), the threaded runtime attaches
a :class:`ThreadedComputePlane` per ``SageRuntime`` (condition-variable
twin with the identical slicing/amortization arithmetic).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import telemetry

__all__ = [
    "COMPUTE_MODES", "ComputeConfig", "resolve_compute", "slices_for",
    "batched_span", "batch_hold_s", "ComputePlane", "BatchCollector",
    "ThreadedComputePlane", "empty_compute_stats",
]

COMPUTE_MODES = ("exclusive", "shared")

#: number of SM slices a node's compute budget quantizes into
DEFAULT_SLICES = 8
#: default collection window before an under-full batch launches anyway
DEFAULT_WINDOW_S = 0.002
#: marginal cost of one extra batch row, as a fraction of a solo launch —
#: conservative vs the kernel_bench sweep (stacked Pallas launches measure
#: well under this on the reference path)
DEFAULT_MARGINAL = 0.3
#: auto sm_fraction: a function whose profiled compute stage is this long
#: (or longer) wants the whole GPU; shorter stages scale down linearly
DEFAULT_AUTO_FULL_MS = 40.0


@dataclass(frozen=True)
class ComputeConfig:
    """Resolved ``compute=`` knob (``resolve_compute`` normalizes the
    user-facing forms; ``None`` everywhere means exclusive/seed)."""

    mode: str = "shared"
    slices: int = DEFAULT_SLICES
    max_batch: int = 1            # 1 = slicing only, batching off
    batch_window_s: float = DEFAULT_WINDOW_S
    batch_marginal: float = DEFAULT_MARGINAL
    auto_full_ms: float = DEFAULT_AUTO_FULL_MS

    def __post_init__(self) -> None:
        if self.mode not in COMPUTE_MODES:
            raise ValueError(
                f"unknown compute mode {self.mode!r}; use one of "
                f"{COMPUTE_MODES}")
        if self.slices < 1:
            raise ValueError(f"compute slices must be >= 1, got {self.slices}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.batch_window_s < 0.0:
            raise ValueError("batch_window_s must be >= 0")
        if not 0.0 <= self.batch_marginal <= 1.0:
            raise ValueError("batch_marginal must be in [0, 1]")
        if self.auto_full_ms <= 0.0:
            raise ValueError("auto_full_ms must be > 0")


def resolve_compute(value: Any) -> Optional[ComputeConfig]:
    """Normalize the ``compute=`` knob. ``None``/``"exclusive"`` -> ``None``
    (the seed path — no plane is ever attached); ``"shared"`` -> defaults;
    a dict -> ``ComputeConfig(**dict)``; a config passes through. An
    explicit ``mode="exclusive"`` config also resolves to ``None`` so every
    consumer has exactly one off-state to test."""
    if value is None or value == "exclusive":
        return None
    if value == "shared" or value is True:
        return ComputeConfig()
    if isinstance(value, dict):
        value = ComputeConfig(**value)
    if isinstance(value, ComputeConfig):
        return None if value.mode == "exclusive" else value
    raise ValueError(
        f"compute must be 'exclusive', 'shared', a dict, or a "
        f"ComputeConfig; got {value!r}")


def slices_for(cfg: ComputeConfig, sm_fraction: Optional[float],
               compute_s: float) -> int:
    """SM slices a function needs: its declared ``sm_fraction`` quantized
    up, or (auto mode) the profiled compute stage scaled against
    ``auto_full_ms`` — a 5 ms function on the default 40 ms scale wants
    1/8 of the GPU. Always in ``[1, slices]``; deterministic."""
    frac = sm_fraction
    if frac is None:
        frac = min(1.0, compute_s / (cfg.auto_full_ms / 1e3))
    k = int(math.ceil(frac * cfg.slices - 1e-9))
    return max(1, min(cfg.slices, k))


def batched_span(compute_s: float, n: int, marginal: float) -> float:
    """Total span of one stacked launch over ``n`` inputs."""
    if n <= 1:
        return compute_s
    return compute_s * (1.0 + marginal * (n - 1))


def batch_hold_s(cfg: ComputeConfig, now: float, arrival_t: Optional[float],
                 deadline_s: Optional[float], est_compute_s: float) -> float:
    """How long this member may sit in an open batch: the window, capped by
    the member's EDF slack so batching never creates a deadline miss the
    member didn't already have. The slack is charged the WORST-CASE stacked
    span (a full ``max_batch`` launch), not the solo span — an edge-of-slack
    member would otherwise miss by exactly the batch's marginal overhead."""
    if deadline_s is None or arrival_t is None:
        return cfg.batch_window_s
    worst = batched_span(est_compute_s, cfg.max_batch, cfg.batch_marginal)
    slack = arrival_t + deadline_s - now - worst
    return max(0.0, min(cfg.batch_window_s, slack))


def empty_compute_stats(mode: str, slices: int) -> Dict[str, object]:
    """The exact key set ``compute_stats()`` reports on BOTH drivers
    (runtime<->sim key parity, like ``resilience_stats``)."""
    return {"mode": mode, "slices": slices, "grants": 0,
            "contended_grants": 0, "batches": 0, "batched": 0}


# ----------------------------------------------------------------------
# simulator side
# ----------------------------------------------------------------------
class ComputePlane:
    """Virtual-time fractional SM budget for one simulated node.

    Each slice is a FIFO of its own (``free_at``); a grant takes the
    earliest instant any slice frees, claims ``min(k, idle-then)`` slices,
    and stretches the span by ``k/granted`` when granted short. Packing is
    deterministic: ties break by slice index, so replays are exact."""

    __slots__ = ("cfg", "free_at", "grants", "contended_grants",
                 "batches", "batched")

    def __init__(self, cfg: ComputeConfig):
        self.cfg = cfg
        self.free_at = [0.0] * cfg.slices
        self.grants = 0
        self.contended_grants = 0
        self.batches = 0
        self.batched = 0

    def slices_for(self, sm_fraction: Optional[float],
                   compute_s: float) -> int:
        return slices_for(self.cfg, sm_fraction, compute_s)

    def acquire(self, now: float, k: int, span_s: float
                ) -> Tuple[float, float]:
        """Grant ``k`` slices for ``span_s``; returns ``(start, span)``
        with ``span`` stretched by ``k/granted`` under contention."""
        free_at = self.free_at
        start = max(now, min(free_at))
        idle = [i for i, t in enumerate(free_at) if t <= start + 1e-12]
        g = min(k, len(idle))
        span = span_s * (k / g)
        end = start + span
        for i in idle[:g]:
            free_at[i] = end
        self.grants += 1
        if g < k:
            self.contended_grants += 1
        return start, span

    def free_fraction(self, now: float) -> float:
        """Fraction of the SM budget idle right now (dispatch scoring)."""
        free = sum(1 for t in self.free_at if t <= now)
        return free / len(self.free_at)

    def reset(self) -> None:
        """Node teardown/crash: all in-flight grants died with the epoch."""
        for i in range(len(self.free_at)):
            self.free_at[i] = 0.0

    def stats(self) -> Dict[str, object]:
        out = empty_compute_stats("shared", self.cfg.slices)
        out.update(grants=self.grants, contended_grants=self.contended_grants,
                   batches=self.batches, batched=self.batched)
        return out


class BatchCollector:
    """One OPEN same-function batch on one simulated node.

    Members join as their setup paths finish (``SageInvocation`` hands over
    instead of creating its ``Completion``); the batch flushes when it hits
    ``max_batch`` or when the tightest member's hold expires — every join
    can only move the flush *earlier* (generation-guarded re-arm), so no
    member is ever held past its own EDF slack. ``finish`` is the driver
    callback that turns one member + the shared grant into its per-member
    completion; the node's ``epoch`` guards against flushing across a
    crash."""

    __slots__ = ("clock", "node", "fn", "cfg", "finish", "members",
                 "close_at", "closed", "epoch", "gen")

    def __init__(self, clock, node, fn, cfg: ComputeConfig,
                 finish: Callable):
        self.clock = clock
        self.node = node
        self.fn = fn
        self.cfg = cfg
        self.finish = finish
        self.members: List[Tuple[Any, float]] = []  # (invocation, ready_t)
        self.close_at: Optional[float] = None
        self.closed = False
        self.epoch = node.epoch
        self.gen = 0

    def join(self, inv) -> None:
        now = self.clock.now()
        self.members.append((inv, now))
        inv._batch = self
        rec = inv.rec
        est = self.fn.compute_s * self.node.slow_factor
        limit = now + batch_hold_s(self.cfg, now, rec.arrival_t,
                                   rec.deadline_s, est)
        if len(self.members) >= self.cfg.max_batch:
            self._flush()
            return
        if self.close_at is None or limit < self.close_at:
            self.close_at = limit
            self.gen += 1
            gen = self.gen
            self.clock.schedule_at(limit, lambda: self._fire(gen))

    def leave(self, inv) -> None:
        """A member is cancelled (hedge loser) while parked: it exits the
        batch before the stacked launch, so the flush neither counts it nor
        charges it a span — its own failure path releases its bytes."""
        self.members = [(m, t) for m, t in self.members if m is not inv]
        inv._batch = None
        if not self.members:
            self._retire()

    def _retire(self) -> None:
        self.closed = True
        batches = self.node.compute_batches
        if batches is not None and batches.get(self.fn.name) is self:
            del batches[self.fn.name]

    def _fire(self, gen: int) -> None:
        if self.closed or gen != self.gen or self.node.epoch != self.epoch:
            return
        self._flush()

    def _flush(self) -> None:
        self._retire()
        members = self.members
        size = len(members)
        if not size:
            return
        now = self.clock.now()
        plane = self.node.compute_plane
        compute_s = self.fn.compute_s * self.node.slow_factor
        total = batched_span(compute_s, size, self.cfg.batch_marginal)
        k = plane.slices_for(getattr(self.fn, "sm_fraction", None),
                             self.fn.compute_s)
        start, span = plane.acquire(now, k, total)
        if size > 1:
            plane.batches += 1
            plane.batched += size
        ids = sorted(m.rec.request_id for m, _ in members)
        for inv, ready_t in members:
            inv._batch = None
            self.finish(inv, ready_t, start, span, size,
                        tuple(i for i in ids if i != inv.rec.request_id))


# ----------------------------------------------------------------------
# threaded-runtime side
# ----------------------------------------------------------------------
class _RuntimeBatch:
    __slots__ = ("requests", "closed", "close_at", "size", "remaining",
                 "granted", "k")

    def __init__(self) -> None:
        self.requests: List[Any] = []
        self.closed = False
        self.close_at = float("inf")
        self.size = 0
        self.remaining = 0
        self.granted: Optional[int] = None
        self.k = 0


class ThreadedComputePlane:
    """Condition-variable twin of :class:`ComputePlane` for the threaded
    ``SageRuntime``: the same slice budget, grant-short stretching, and
    batch amortization arithmetic, applied to the *measured* handler wall
    time (the slow_factor sleep-to-model pattern from ``sage_run``). The
    default path never constructs one — ``compute="exclusive"`` keeps the
    seed's whole-node handler lock."""

    def __init__(self, cfg: ComputeConfig, clock):
        self.cfg = cfg
        self.clock = clock
        self._cond = threading.Condition()
        self._free = cfg.slices
        self._open: Dict[str, _RuntimeBatch] = {}
        self.grants = 0
        self.contended_grants = 0
        self.batches = 0
        self.batched = 0

    # -- introspection --------------------------------------------------
    def free_fraction(self) -> float:
        with self._cond:
            return self._free / self.cfg.slices

    def stats(self) -> Dict[str, object]:
        with self._cond:
            out = empty_compute_stats("shared", self.cfg.slices)
            out.update(grants=self.grants,
                       contended_grants=self.contended_grants,
                       batches=self.batches, batched=self.batched)
            return out

    # -- the wrapped handler path --------------------------------------
    def run(self, fn, inner: Callable, shim, request):
        """Execute ``inner`` (the function's real handler) under the shared
        plane: optionally batch with concurrent same-function arrivals,
        acquire the function's slice grant, and stretch the measured wall
        time to the modeled shared-compute span. The batch's collection
        and the grant's wait are the invocation's ``lock_wait`` span."""
        import time as _time

        from repro_torch.core.slowness import HedgedError

        est = getattr(fn, "compute_s_hint", 0.0) or 0.0
        k = slices_for(self.cfg, getattr(fn, "sm_fraction", None), est)
        batch = None
        with telemetry.span("lock_wait"):
            if self.cfg.max_batch > 1:
                batch = self._join(fn, request, est)
            ev = getattr(request, "hedge_cancel", None)
            if ev is not None and ev.is_set():
                # cancelled while parked in the collector: exit before the
                # launch so the engine's HedgedError unwind releases the
                # member's bytes exactly (no leaked device_used)
                if batch is not None:
                    self._leave(batch, request)
                raise HedgedError(f"{fn.name}: superseded by hedged twin")
            g = self._acquire(batch, k)
        t0 = _time.monotonic()
        try:
            return inner(shim, request)
        finally:
            wall = _time.monotonic() - t0
            size = batch.size if batch is not None else 1
            span = batched_span(wall, size, self.cfg.batch_marginal) * (k / g)
            if span > wall:
                self.clock.sleep(span - wall)
            if batch is not None:
                self._release_batch(batch)
            else:
                self._release_solo(g)

    # -- batching -------------------------------------------------------
    def _join(self, fn, request, est: float) -> _RuntimeBatch:
        """Park in the open batch for ``fn`` until it closes (max_batch
        reached, or the tightest member's hold expires). Symmetric: every
        member watches the close deadline, so a cancelled member never
        strands the rest."""
        cfg, clock = self.cfg, self.clock
        ev = getattr(request, "hedge_cancel", None)
        with self._cond:
            now = clock.now()
            b = self._open.get(fn.name)
            if b is None or b.closed:
                b = _RuntimeBatch()
                self._open[fn.name] = b
            b.requests.append(request)
            hold = batch_hold_s(cfg, now, getattr(request, "arrival_t", now),
                                getattr(request, "deadline_s", None), est)
            b.close_at = min(b.close_at, now + hold)
            if len(b.requests) >= cfg.max_batch:
                self._close(fn.name, b)
            self._cond.notify_all()
            while not b.closed:
                if ev is not None and ev.is_set():
                    break  # caller re-checks and leaves
                now = clock.now()
                if now >= b.close_at:
                    self._close(fn.name, b)
                    self._cond.notify_all()
                    break
                self._cond.wait(min(b.close_at - now, 0.05))
        return b

    def _close(self, name: str, b: _RuntimeBatch) -> None:
        # caller holds self._cond
        b.closed = True
        if self._open.get(name) is b:
            del self._open[name]
        b.size = b.remaining = len(b.requests)
        if b.size > 1:
            self.batches += 1
            self.batched += b.size
            ids = sorted(getattr(r, "uuid", "") for r in b.requests)
        for r in b.requests:
            r.batch_size = b.size
            r.batched_with = (tuple(i for i in ids if i != r.uuid)
                              if b.size > 1 else ())

    def _leave(self, b: _RuntimeBatch, request) -> None:
        with self._cond:
            if not b.closed:
                if request in b.requests:
                    b.requests.remove(request)
                if not b.requests:
                    b.closed = True
                    for name, cand in list(self._open.items()):
                        if cand is b:
                            del self._open[name]
            else:
                b.remaining -= 1
                if b.remaining == 0 and b.granted is not None:
                    self._free += b.granted
                    b.granted = None
            self._cond.notify_all()

    # -- slice accounting ----------------------------------------------
    def _acquire(self, batch: Optional[_RuntimeBatch], k: int) -> int:
        """One grant per solo invocation, one SHARED grant per batch (the
        stacked launch is a single kernel). Waits only when the budget is
        fully busy; otherwise takes what is free, like the sim plane."""
        with self._cond:
            if batch is not None:
                # every member re-checks ``granted`` after each wake: a
                # peer may have granted the batch while this member was
                # parked on the budget (waiting on ``_free`` alone here
                # double-grants the batch and leaks its first grant)
                while batch.granted is None and self._free <= 0:
                    self._cond.wait()
                if batch.granted is None:
                    batch.granted = min(k, self._free)
                    batch.k = k
                    self._free -= batch.granted
                    self.grants += 1
                    if batch.granted < k:
                        self.contended_grants += 1
                    self._cond.notify_all()  # wake peers parked above
                return batch.granted
            while self._free <= 0:
                self._cond.wait()
            g = min(k, self._free)
            self._free -= g
            self.grants += 1
            if g < k:
                self.contended_grants += 1
            return g

    def _release_solo(self, g: int) -> None:
        with self._cond:
            self._free += g
            self._cond.notify_all()

    def _release_batch(self, batch: _RuntimeBatch) -> None:
        """The stacked launch's shared grant frees when its LAST member's
        modeled span elapses."""
        with self._cond:
            batch.remaining -= 1
            if batch.remaining == 0 and batch.granted is not None:
                self._free += batch.granted
                batch.granted = None
            self._cond.notify_all()
