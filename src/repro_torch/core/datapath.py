"""Data-loading path model: fair-share bandwidth brokers.

The paper's Fig 4 shows concurrent invocations suffer 34.9x data-loading
slowdowns because they contend on disk, network, and PCIe. We model each
path as a progressively-filled fair-share link: all active transfers split
the bandwidth equally; completion times are recomputed on every arrival/
departure (max-min fairness with identical demands).

Two drivers share this implementation:
* the threaded runtime calls :meth:`transfer` (blocking; sleeps real time),
* the discrete-event simulator calls :meth:`sim_transfer` (virtual time via
  callbacks).

Hardware constants calibrated from the paper's Table 4 (resnet50): CPU data
109.6 MB in 67.2 ms -> ~1.63 GB/s database path; GPU data 109.6 MB in
21.7 ms -> ~5.05 GB/s effective PCIe.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.core.clock import EventKind, RealClock, VirtualClock
from repro_torch.core.transfer import TransferStream

# calibrated from paper Table 4 (see module docstring)
DB_BANDWIDTH = 1.63e9     # bytes/s: database -> host (disk+network)
PCIE_BANDWIDTH = 5.05e9   # bytes/s: host -> device
# TPU adaptation: host -> HBM on v5e rides PCIe gen4-class links too; the
# same broker models it (constant overridable per deployment).


class BandwidthBroker:
    """Fair-share link. Thread-safe blocking mode + virtual-time mode.

    ``concurrency_penalty`` models sub-linear aggregate bandwidth under
    concurrent streams (HDD seek thrash on the paper's 2 TB HDD database
    path, Table 3): aggregate = bw / (1 + p*(n-1)).
    """

    def __init__(self, bandwidth: float, clock=None, name: str = "link",
                 concurrency_penalty: float = 0.0, max_streams: int = 32):
        self.bw = float(bandwidth)
        # degradation tracking (docs/resilience.md): ``bw`` is always
        # ``base_bw * degradation``, so fault windows compose and restore
        # exactly, and the transfer pacing layer (LinkArbiter.chunk_hint)
        # can read the current health factor off the link
        self.base_bw = float(bandwidth)
        self.degradation = 1.0
        self.penalty = float(concurrency_penalty)
        self.max_streams = max_streams  # connection-pool bound (FIFO queue)
        self._waitq: list = []
        self.clock = clock or RealClock()
        self.name = name
        # per-transfer contention history (bytes, observed, solo). Disable
        # for trace-scale replays: a million-invocation run would retain
        # millions of tuples nobody reads (record_mode="aggregate" flips it)
        self.keep_history = True
        self._epoch = 0
        self._lock = threading.Condition()
        self._active: Dict[int, list] = {}  # id -> [remaining_bytes]
        self._seq = 0
        self._last_t = self.clock.now()
        # stats
        self.total_bytes = 0.0
        self.total_busy_time = 0.0
        self.max_concurrency = 0

    # ------------------------------------------------------------------
    def _drain(self, now: float) -> None:
        """Advance all active transfers to ``now`` (equal split)."""
        n = len(self._active)
        if n:
            rate = self.bw / n / (1.0 + self.penalty * (n - 1))
            dt = max(now - self._last_t, 0.0)
            for ent in self._active.values():
                ent[0] -= rate * dt
            self.total_busy_time += dt
        self._last_t = now

    def _next_finish(self) -> Optional[float]:
        if not self._active:
            return None
        n = len(self._active)
        rate = self.bw / n / (1.0 + self.penalty * (n - 1))
        rem = min(ent[0] for ent in self._active.values())
        return max(rem, 0.0) / rate

    # ------------------------------------------------------------------
    # blocking (threaded runtime)
    # ------------------------------------------------------------------
    def transfer(self, nbytes: float, *, scale: float = 1.0) -> float:
        """Block until ``nbytes`` have 'moved' under fair sharing.

        ``scale`` < 1 lets tests compress modeled time. Returns the modeled
        duration."""
        if nbytes <= 0:
            return 0.0
        with self._lock:
            now = self.clock.now()
            self._drain(now)
            self._seq += 1
            tid = self._seq
            self._active[tid] = [float(nbytes) * scale]
            self.total_bytes += nbytes
            self.max_concurrency = max(self.max_concurrency, len(self._active))
            self._lock.notify_all()
            t0 = now
            while True:
                now = self.clock.now()
                self._drain(now)
                if self._active[tid][0] <= 1e-9:
                    del self._active[tid]
                    self._lock.notify_all()
                    return now - t0
                n = len(self._active)
                eta = self._active[tid][0] / (self.bw / n / (1.0 + self.penalty * (n - 1)))
                self._lock.wait(timeout=min(eta, 0.05))

    # ------------------------------------------------------------------
    # chunked streams (preemptible transfer engine, core/transfer.py)
    # ------------------------------------------------------------------
    def open_stream(self, nbytes: float, *, scale: float = 1.0) -> TransferStream:
        """Open a chunked, preemptible stream over this link. The stream's
        ``advance``/``sim_advance`` calls ride the same fair-share
        machinery as :meth:`transfer`/:meth:`sim_transfer`; ``pause`` /
        ``resume`` / ``cancel`` keep byte accounting exact (only moved
        bytes are charged). A single full-size advance is byte- and
        time-identical to one blocking :meth:`transfer` call."""
        return TransferStream(self, nbytes, scale=scale)

    # ------------------------------------------------------------------
    # virtual time (simulator)
    # ------------------------------------------------------------------
    def sim_transfer(self, nbytes: float, done: Callable[[], None]) -> None:
        """Virtual-time transfer; ``done`` fires at completion. Requires a
        VirtualClock."""
        assert isinstance(self.clock, VirtualClock)
        now = self.clock.now()
        self._drain(now)
        if self.max_streams and len(self._active) >= self.max_streams:
            # connection pool exhausted: FIFO-queue the transfer (without a
            # bound, unbounded streams + seek penalty collapse the link)
            self._waitq.append((nbytes, done))
            return
        self._seq += 1
        tid = self._seq
        t0 = now

        def done_and_record():
            if self.keep_history:
                # contention history: (bytes, observed duration, solo duration)
                self.history.append((nbytes, self.clock.now() - t0, nbytes / self.bw))
            if done is not None:
                done()
            while self._waitq and len(self._active) < self.max_streams:
                nb, cb = self._waitq.pop(0)
                self.sim_transfer(nb, cb)

        self._active[tid] = [float(nbytes), done_and_record]
        self.total_bytes += nbytes
        self.max_concurrency = max(self.max_concurrency, len(self._active))
        self._reschedule()

    @property
    def history(self):
        if not hasattr(self, "_history"):
            self._history = []
        return self._history

    def mean_slowdown(self) -> float:
        """Observed contention factor (the paper's Fig 4 metric)."""
        h = [(d / s) for _, d, s in self.history if s > 0]
        return sum(h) / len(h) if h else 1.0

    def _reschedule(self) -> None:
        """(Re)arm the next-completion event (a typed TRANSFER event with
        the epoch riding the event args — no per-reschedule closure)."""
        nf = self._next_finish()
        if nf is None:
            return
        self._epoch += 1
        self.clock.schedule(max(nf, 0.0), self._fire, self._epoch,
                            kind=EventKind.TRANSFER)

    def _fire(self, epoch: int) -> None:
        if epoch != self._epoch:  # superseded by a later arrival
            return
        now = self.clock.now()
        self._drain(now)
        # 0.5-byte slack: guarantees progress even when float error
        # leaves a sliver after the projected finish time
        finished = [t for t, ent in self._active.items() if ent[0] <= 0.5]
        if not finished and self._active:
            # force the minimum-remaining transfer out (progress guard)
            tmin = min(self._active, key=lambda t: self._active[t][0])
            if self._active[tmin][0] <= 1.0:
                finished = [tmin]
        for t in finished:
            ent = self._active.pop(t)
            if len(ent) > 1 and ent[1] is not None:
                ent[1]()
        self._reschedule()

    # ------------------------------------------------------------------
    # fault injection hooks (docs/resilience.md)
    # ------------------------------------------------------------------
    def _rerate(self) -> None:
        """Apply ``base_bw * degradation`` mid-run with exact in-flight
        accounting: active transfers are drained to now at the OLD rate
        first, so completed progress is preserved; in virtual time the
        next-completion event is re-armed at the new rate (the epoch guard
        retires the stale one). Threaded transfers recompute their rate
        every wait slice and need only a wake-up. Caller holds the lock."""
        self._drain(self.clock.now())
        self.bw = self.base_bw * self.degradation
        if isinstance(self.clock, VirtualClock):
            self._reschedule()
        else:
            self._lock.notify_all()

    def set_bandwidth(self, bandwidth: float) -> None:
        """Change the link's BASE rate mid-run (any active degradation
        factor stays applied on top)."""
        with self._lock:
            self.base_bw = float(bandwidth)
            self._rerate()

    def apply_degradation(self, factor: float) -> None:
        """Compound a degradation window onto the link (``degrade_on``):
        overlapping windows multiply, exactly like the pre-tracking
        ``set_bandwidth(bw * factor)`` chains, but the base rate is never
        lost to float drift on restore."""
        if factor <= 0.0:
            raise ValueError(f"degradation factor must be > 0, got {factor}")
        with self._lock:
            self.degradation *= float(factor)
            self._rerate()

    def clear_degradation(self, factor: Optional[float] = None) -> None:
        """End a degradation window (``degrade_off``): divide ``factor``
        back out, or reset to healthy with no argument. In-flight chunked
        streams pick the restored rate up mid-stream — completed bytes
        stay charged at the degraded rate."""
        with self._lock:
            if factor is None:
                self.degradation = 1.0
            else:
                self.degradation /= float(factor)
                if abs(self.degradation - 1.0) < 1e-12:
                    self.degradation = 1.0  # exact restore for one window
            self._rerate()

    def reset(self) -> None:
        """Drop every in-flight and queued transfer WITHOUT firing their
        completions (node crash: the invocations they belonged to are
        failed by the crash path, and a completion landing afterwards
        would resurrect freed state). The epoch bump retires any
        already-scheduled completion event. Virtual-time only: the
        threaded driver's crash path cancels loads at the daemon's
        checkpoints instead (a blocking transfer must drain its own
        active slot)."""
        assert isinstance(self.clock, VirtualClock)
        with self._lock:
            self._drain(self.clock.now())
            self._active.clear()
            self._waitq.clear()
            self._epoch += 1
            self._lock.notify_all()

    # ------------------------------------------------------------------
    def solo_time(self, nbytes: float) -> float:
        """Uncontended transfer time (the Fig-2 'solo-run' reference)."""
        return nbytes / self.bw

    def contention_factor(self) -> float:
        """Observed mean slowdown proxy: max concurrency seen."""
        return float(self.max_concurrency)


@dataclass
class DataPaths:
    """The three contended paths of §3.2.2."""

    db: BandwidthBroker
    pcie: BandwidthBroker

    @classmethod
    def make(cls, clock=None, db_bw: float = DB_BANDWIDTH, pcie_bw: float = PCIE_BANDWIDTH,
             db_seek_penalty: float = 0.06):
        return cls(
            db=BandwidthBroker(db_bw, clock, "db",
                               concurrency_penalty=db_seek_penalty),
            pcie=BandwidthBroker(pcie_bw, clock, "pcie"),
        )
