"""Preemptible chunked transfer engine (docs/dataplane.md, "Transfer
scheduling").

The db and PCIe paths used to move every load as one atomic run-to-
completion ``BandwidthBroker.transfer()``: once a loose 8 GB load owned the
link, a tight-deadline 50 MB load queued behind it, and the EDF scheduler
could only reorder *queued* work. FaaSTube (arXiv:2411.01830) shows that
reassigning the bandwidth of an **in-flight** transfer is the dominant
lever for GPU-serverless tail latency; HAS-GPU (arXiv:2505.01968) argues
the arbitration should stay SLO-class-aware.

This module is the shared policy core both drivers run:

* :class:`TransferStream` — one transfer, split into chunks, that can be
  paused between chunks and resumed later **without losing completed
  bytes**. The wall-clock driver calls :meth:`TransferStream.advance`
  (blocking); the virtual-time driver calls
  :meth:`TransferStream.sim_advance` (callback). Cancelling a stream
  freezes its byte accounting: only bytes actually moved are charged to
  the link.
* :class:`LinkArbiter` — the preemption decision. It watches the *demand*
  for the link (the tightest :data:`~repro_torch.core.daemon.AdmissionKey`
  waiting on the loader queue) and tells an in-flight stream to yield when
  a **strictly tighter** ``(priority, deadline)`` class is waiting. Under
  ``transfer="run_to_completion"`` (the default) it never yields and
  chunking collapses to a single full-size advance — bit-identical to the
  pre-stream behavior.

Preemption compares only the urgency *prefix* of an AdmissionKey —
``(-priority, absolute deadline)`` — never the arrival sequence number:
equal-urgency work must not preempt itself, or two same-class streams
would thrash the link trading chunks. Under ``scheduler="fifo"`` every key
carries the degenerate prefix ``(0, 0.0)``, so nothing is ever strictly
tighter and ``"preemptive"`` is a no-op: preemptive transfer is an EDF
feature, exactly as in the papers above.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

TRANSFER_MODES = ("run_to_completion", "preemptive")

# Preemption latency is bounded by one chunk. 32 MiB is ~6 ms on the
# paper's 5.05 GB/s effective PCIe link and ~20 ms on the 1.63 GB/s db
# path — far below the context-creation floor (285 ms) — while keeping an
# 8 GB transfer at only ~250 scheduling points.
DEFAULT_CHUNK_BYTES = 32 << 20
# floor for degradation-scaled chunks: below ~1 MiB the per-chunk
# bookkeeping dominates the modeled transfer itself
MIN_CHUNK_BYTES = 1 << 20


def key_prefix(key) -> Optional[Tuple]:
    """Urgency prefix of an AdmissionKey: ``(-priority, deadline)``. The
    arrival seq is dropped so equal-urgency work can never preempt itself."""
    if key is None:
        return None
    return tuple(key[:2])


class TransferStream:
    """One chunked, preemptible transfer over a
    :class:`~repro_torch.core.datapath.BandwidthBroker` link.

    Progress (``moved``) survives pause/resume cycles; ``cancel()``
    freezes it, so a cancelled stream charges the link only for the bytes
    it actually moved (byte-exact accounting on the release() path).
    ``stalled_s`` accumulates the wall (or virtual) time spent paused and
    ``preemptions`` counts the pauses — both roll up into per-record
    telemetry.
    """

    __slots__ = ("broker", "total", "moved", "scale", "cancelled",
                 "paused_at", "stalled_s", "preemptions")

    def __init__(self, broker, nbytes: float, *, scale: float = 1.0):
        self.broker = broker
        self.total = max(float(nbytes), 0.0)
        self.scale = scale
        self.moved = 0.0
        self.cancelled = False
        self.paused_at: Optional[float] = None  # clock stamp while paused
        self.stalled_s = 0.0
        self.preemptions = 0

    # ------------------------------------------------------------------
    @property
    def remaining(self) -> float:
        return max(self.total - self.moved, 0.0)

    @property
    def done(self) -> bool:
        return not self.cancelled and self.remaining <= 0.0

    def _next_chunk(self, chunk: Optional[float]) -> float:
        if chunk is None:
            return self.remaining
        return min(float(chunk), self.remaining)

    # ------------------------------------------------------------------
    # wall-clock mode (threaded daemon)
    # ------------------------------------------------------------------
    def advance(self, chunk: Optional[float] = None) -> float:
        """Move the next ``chunk`` bytes (all remaining when ``None``) under
        the link's fair sharing; blocks for the modeled duration and
        returns it. A no-op on a done or cancelled stream."""
        amt = self._next_chunk(chunk)
        if amt <= 0.0 or self.cancelled:
            return 0.0
        dt = self.broker.transfer(amt, scale=self.scale)
        self.moved += amt
        return dt

    # ------------------------------------------------------------------
    # virtual-time mode (simulator)
    # ------------------------------------------------------------------
    def sim_advance(self, chunk: Optional[float],
                    done: Callable[[], None]) -> None:
        """Virtual-time advance; ``done`` fires when the chunk completes.
        With ``chunk=None`` this is exactly one full-size ``sim_transfer``
        — the same event sequence the pre-stream code scheduled."""
        amt = self._next_chunk(chunk)
        if amt <= 0.0 or self.cancelled:
            done()
            return

        def fin():
            self.moved += amt
            done()

        self.broker.sim_transfer(amt, fin)

    # ------------------------------------------------------------------
    # preemption lifecycle
    # ------------------------------------------------------------------
    def pause(self, now: float) -> None:
        """Yield the link between chunks (completed bytes are kept)."""
        if self.paused_at is None:
            self.paused_at = now
            self.preemptions += 1

    def resume(self, now: float) -> None:
        """Re-take the link; the paused span lands in ``stalled_s``."""
        if self.paused_at is not None:
            self.stalled_s += max(now - self.paused_at, 0.0)
            self.paused_at = None

    def cancel(self) -> None:
        """Abort the stream: ``moved`` is frozen and further advances are
        no-ops. The link keeps only the bytes already transferred."""
        self.cancelled = True


class LinkArbiter:
    """Preemption policy for one node's transfer links.

    ``demand`` is a zero-argument callable returning the tightest
    AdmissionKey currently *waiting* for a loader slot (the loader-pool /
    loader-gate queue head), or ``None`` when nothing queues. The arbiter
    itself holds no queue — both drivers already keep one — it only
    answers, between chunks, "must this stream yield now?".
    """

    def __init__(self, mode: str = "run_to_completion",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 demand: Optional[Callable[[], Optional[Tuple]]] = None):
        if mode not in TRANSFER_MODES:
            raise ValueError(
                f"unknown transfer mode {mode!r}; use one of {TRANSFER_MODES}")
        self.mode = mode
        self.chunk_bytes = int(chunk_bytes)
        self._demand = demand
        self.preemptions = 0  # link-wide pause count (benchmark headline)

    # ------------------------------------------------------------------
    @property
    def preemptive(self) -> bool:
        return self.mode == "preemptive"

    def set_mode(self, mode: str) -> None:
        if mode not in TRANSFER_MODES:
            raise ValueError(
                f"unknown transfer mode {mode!r}; use one of {TRANSFER_MODES}")
        self.mode = mode

    def bind_demand(self, fn: Callable[[], Optional[Tuple]]) -> None:
        self._demand = fn

    # ------------------------------------------------------------------
    def chunk_hint(self, link=None) -> Optional[int]:
        """Per-advance chunk size: ``None`` (one full-size advance — the
        pre-stream behavior) unless preemption needs chunk boundaries.

        With ``link`` (a :class:`~repro_torch.core.datapath.BandwidthBroker`),
        the chunk is scaled by the link's current degradation factor so
        the per-chunk transfer TIME — the preemption latency bound — stays
        roughly constant when a fault window slows the link. Drivers call
        this per advance, so an in-flight stream adapts its pacing
        mid-stream as degradation windows open and close."""
        if not self.preemptive:
            return None
        deg = 1.0 if link is None else getattr(link, "degradation", 1.0)
        if deg >= 1.0:
            return self.chunk_bytes
        return max(MIN_CHUNK_BYTES, int(self.chunk_bytes * deg))

    def should_yield(self, key) -> bool:
        """True when a strictly tighter ``(priority, deadline)`` class is
        waiting for the link than the in-flight stream's ``key``."""
        if not self.preemptive or self._demand is None:
            return False
        head = key_prefix(self._demand())
        mine = key_prefix(key)
        return head is not None and mine is not None and head < mine

    def note_preemption(self) -> None:
        self.preemptions += 1
