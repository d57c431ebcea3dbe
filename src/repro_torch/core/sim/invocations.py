"""Domain layer: per-policy invocation state machines.

Each platform's invocation lifecycle (SAGE's parallel ctx/data setup,
FixedGSL's serial chain, DGSF's pre-created-context pool) is one slotted
class whose bound methods are the event handlers — the direct state-machine
transcription of the pre-kernel closure chains, golden-trace-guarded in
tests/test_torch_sim.py.

A SAGE invocation finishes when all four paths (``mem``, ``ctx``, ``ro``,
``win``) have completed; the paths are tracked as a bitmask instead of a
per-invocation dict.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.compute import BatchCollector
from repro_torch.core.sim.domain import (
    CPU_CTX_S, GPU_CTX_S, RETURN_S, GPUNode, SimFunction, SimInstance,
)
from repro_torch.core.sim.kernel import EventKind
from repro_torch.core.telemetry import InvocationRecord

__all__ = ["SageInvocation", "FixedInvocation", "DgsfInvocation",
           "Completion", "CallbackCompletion", "sage_instance"]

# SAGE setup paths still outstanding (bitmask)
_MEM, _CTX, _RO, _WIN = 1, 2, 4, 8
_ALL = _MEM | _CTX | _RO | _WIN


def _schedule_compute(sim, node, fn, rec, done, timing=None):
    """Schedule the compute stage and stamp ``rec.stages["compute"]``.

    Three paths, in priority order: an explicit ``timing=(ready_t, start,
    span)`` from a flushed batch (docs/compute.md); the node's shared
    :class:`~repro_torch.core.compute.ComputePlane` (fractional-slice grant,
    span stretched under contention); or — always, at defaults — the
    seed's exclusive compute FIFO, arithmetic untouched."""
    now = sim.clock.now()
    if timing is not None:
        ready_t, start, span = timing
        rec.stages["compute"] = (start - ready_t) + span
    elif node.compute_plane is not None:
        plane = node.compute_plane
        compute_s = fn.compute_s * node.slow_factor
        k = plane.slices_for(getattr(fn, "sm_fraction", None), fn.compute_s)
        start, span = plane.acquire(now, k, compute_s)
        rec.stages["compute"] = (start - now) + span
    else:
        compute_s = fn.compute_s * node.slow_factor
        start = max(now, node.compute_free_at)
        node.compute_free_at = start + compute_s
        span = compute_s
        rec.stages["compute"] = (start - now) + compute_s
    sim.clock.schedule_at(start + span, done, kind=EventKind.COMPUTE)


def _batch_finish(inv, ready_t, start, span, size, peers):
    """Per-member epilogue of a flushed batch: stamp the batch telemetry
    and hand the member its :class:`Completion` with the shared grant's
    timing — each member keeps its OWN record and byte bookkeeping, so
    cancellation/crash accounting is unchanged."""
    rec = inv.rec
    rec.batch_size = size
    rec.batched_with = peers
    inv._completion = Completion(
        inv.sim, inv.node, inv.fn, rec, inv.inst, inv.release_bytes,
        extra_done=(inv._drop_host if inv.release_bytes else None),
        owner=inv if inv.node.fault_tracking else None,
        timing=(ready_t, start, span))


class Completion:
    """FIFO compute, then return + cleanup (the tail every non-DGSF
    invocation shares): compute queues behind ``node.compute_free_at``,
    ``done`` releases the invocation's private bytes, parks the instance
    back on its exit ladder, and kicks admission.

    The node's ``epoch`` is captured at creation: a completion scheduled
    before a crash no-ops when it fires afterwards (the bytes/instance it
    would touch died with the old epoch — releasing them would corrupt
    the restarted node's accounting). ``owner`` is the invocation to
    deregister from ``node.active`` (fault tracking only).

    ``cancel()`` flags a hedge loser mid-kernel (docs/resilience.md,
    "Gray failures"): the compute span it already claimed elapses, but
    ``_done`` then runs the *cancellation* bookkeeping — the identical
    byte-exact release/instance/kick sequence, with the record marked
    ``dropped``/``hedged`` instead of counted as a completion."""

    __slots__ = ("sim", "node", "fn", "rec", "inst", "release_bytes",
                 "extra_done", "epoch", "owner", "cancelled")

    def __init__(self, sim, node: GPUNode, fn: SimFunction,
                 rec: InvocationRecord, inst: Optional[SimInstance],
                 release_bytes: int, extra_done: Optional[Callable] = None,
                 owner=None, timing=None):
        self.sim = sim
        self.node = node
        self.fn = fn
        self.rec = rec
        self.inst = inst
        self.release_bytes = release_bytes
        self.extra_done = extra_done
        self.epoch = node.epoch
        self.owner = owner
        self.cancelled = False
        _schedule_compute(sim, node, fn, rec, self._done, timing=timing)

    def cancel(self) -> None:
        self.cancelled = True

    def _done(self) -> None:
        sim, node, rec, inst = self.sim, self.node, self.rec, self.inst
        if node.epoch != self.epoch:
            return  # node crashed mid-compute; on_node_lost owned the record
        if self.cancelled:
            # hedge loser, cancelled mid-kernel: exact same resource
            # bookkeeping as a completion, but the record is a dropped
            # "hedged" outcome — never a completion, never a breaker feed
            sim._fail_record(self.fn, rec, "superseded by hedged twin",
                             cls="hedged")
        else:
            rec.stages["return_result"] = RETURN_S
            rec.end_t = sim.clock.now() + RETURN_S
            sim.telemetry.add(rec)
            sim.completed += 1
            sim.inflight -= 1
            if sim.breakers:
                sim._note_result(self.fn.name, True)
        if self.owner is not None:
            node.active.discard(self.owner)
        if self.release_bytes:
            node.release(self.release_bytes)
        if inst is not None:
            inst.busy = False
            inst.ladder.on_complete(sim.clock.now())
        if self.extra_done is not None:
            self.extra_done()
        node.kick()  # an idle warm instance is now evictable
        if not self.cancelled and sim._slowness is not None:
            sim._tail_complete(node, self.fn, rec)
        if sim._has_drains:  # a completion is a drain's quiesce boundary
            sim._try_finalize_drains()


class CallbackCompletion:
    """DGSF variant of :class:`Completion`: the callback releases the data
    bytes and recycles the context slot itself, and there is no exit-ladder
    instance or admission kick. Epoch-guarded like :class:`Completion`."""

    __slots__ = ("sim", "node", "fn", "rec", "cb", "epoch", "owner")

    def __init__(self, sim, node: GPUNode, fn: SimFunction,
                 rec: InvocationRecord, cb: Callable, owner=None):
        self.sim = sim
        self.node = node
        self.fn = fn
        self.rec = rec
        self.cb = cb
        self.epoch = node.epoch
        self.owner = owner
        _schedule_compute(sim, node, fn, rec, self._done)

    def _done(self) -> None:
        sim, rec = self.sim, self.rec
        if self.node.epoch != self.epoch:
            return
        rec.stages["return_result"] = RETURN_S
        rec.end_t = sim.clock.now() + RETURN_S
        sim.telemetry.add(rec)
        sim.completed += 1
        sim.inflight -= 1
        if self.owner is not None:
            self.node.active.discard(self.owner)
        if sim.breakers:
            sim._note_result(self.fn.name, True)
        self.cb()
        if sim._slowness is not None:
            sim._tail_complete(self.node, self.fn, rec)
        if sim._has_drains:  # a completion is a drain's quiesce boundary
            sim._try_finalize_drains()


def sage_instance(sim, node: GPUNode, fn: SimFunction) -> SimInstance:
    """The function's live instance on ``node`` (there is at most one under
    SAGE — shared context/RO), created with its exit-ladder stage hooks on
    first use."""
    insts = node.instances[fn.name]
    for i in insts:
        if not i.dead:
            return i
    inst = SimInstance(fn)
    inst.ladder.ttls = (
        (node.exit_ttl,) * 4 if sim.policy.multi_stage_exit
        else (sim.policy.keep_warm_s, 0.0, 0.0, 0.0)
    )
    inst.ladder.on_enter = {
        2: lambda: sim._sage_demote(node, inst),
        3: lambda: sim._sage_drop_ctx(node, inst),
        4: lambda: sim._sage_drop_host(node, inst),
    }
    insts.append(inst)
    return inst


class SageInvocation:
    """SAGE lifecycle: context and data paths run in PARALLEL (the paper's
    Lesson 1) and the invocation computes once all four complete:

    * ``ctx`` — the instance's shared GPU context (one builder, concurrent
      arrivals latch on);
    * ``mem`` — the invocation's private bytes (writable + private RO under
      no-sharing), ONE atomic device reservation + host admission;
    * ``ro``  — the shared read-only data (device hit / latch onto an
      in-flight load / host promotion / cold db load);
    * ``win`` — the writable input transfer (starts once ``mem`` grants).
    """

    __slots__ = ("sim", "node", "fn", "rec", "inst", "warm", "share",
                 "release_bytes", "_pending", "_failed", "_mem_granted",
                 "_poison", "_jitter", "_completion", "_batch")

    def __init__(self, sim, node: GPUNode, fn: SimFunction,
                 rec: InvocationRecord, injected: bool = False,
                 jitter_s: float = 0.0):
        self.sim = sim
        self.node = node
        self.fn = fn
        self.rec = rec
        self._poison = injected
        self._jitter = jitter_s
        self._completion = None
        self._batch = None
        if node.fault_tracking:
            node.active.add(self)
        node._advance_ladders()
        inst = self.inst = sage_instance(sim, node, fn)
        warm = (inst.ladder.on_reuse(sim.clock.now())
                if inst.ladder.completion_t else None)
        self.warm = warm
        rec.warm_stage = warm
        inst.busy = True
        share = self.share = sim.policy.share_read_only
        self._pending = _ALL
        self._failed = False
        self._mem_granted = False
        # bytes that die with this invocation: writable + private RO (NR
        # mode), reserved ATOMICALLY up front — piecemeal ro-then-writable
        # reservation deadlocks under load (every invocation holds half its
        # memory while waiting for the other half).
        self.release_bytes = fn.w_bytes + (0 if share else fn.ro_bytes)
        self._start_ctx()
        self._start_mem()
        self._start_ro()

    # ------------------------------------------------------------------
    def _fail(self, reason: str, cls: str = "data_load") -> None:
        if self._failed:
            return
        self._failed = True
        if self.node.fault_tracking:
            self.node.active.discard(self)
        self.sim._fail_record(self.fn, self.rec, reason, cls=cls)
        inst = self.inst
        inst.busy = False
        inst.ladder.on_complete(self.sim.clock.now())
        if self._mem_granted and self.release_bytes:
            self.node.release(self.release_bytes)
            self.node.release_host(self.release_bytes)

    def on_node_lost(self) -> None:
        """The node died under this invocation (crash fault). The node's
        accounting is already reset — release NOTHING here; just mark the
        invocation failed and hand the record to the control layer, which
        re-dispatches it (eviction on, budget left) or fails it typed."""
        if self._failed:
            return
        self._failed = True
        self.sim._node_lost(self)

    def _take_poison(self) -> bool:
        """Consume the arrival's injected loader fault: exactly ONE db-leg
        load of this invocation fails (a fully-warm invocation that never
        loads simply outruns the fault)."""
        p = self._poison
        self._poison = False
        return p

    def _take_jitter(self) -> float:
        """Consume the arrival's LoaderJitter draw: exactly ONE private
        load of this invocation pays the extra delay."""
        j, self._jitter = self._jitter, 0.0
        return j

    def hedge_cancel(self) -> None:
        """Cancel this hedge loser (docs/resilience.md, "Gray failures").
        Still in setup/load: the standard failure path rolls back the
        granted device+host bytes exactly and in-flight chains release
        their loader slots as they land. Mid-kernel: the completion is
        flagged and runs the cancellation bookkeeping when it fires.
        Either way the record becomes a dropped "hedged" outcome."""
        if self._failed:
            return
        if self._pending:
            self._fail("superseded by hedged twin", cls="hedged")
        elif self._batch is not None:
            # parked in an open batch (docs/compute.md): leave before the
            # stacked launch — the standard failure path then rolls back
            # the granted device+host bytes exactly, so a cancelled member
            # never leaks device_used
            self._batch.leave(self)
            self._fail("superseded by hedged twin", cls="hedged")
        elif self._completion is not None:
            self._completion.cancel()

    def _path_done(self, bit: int) -> None:
        self._pending &= ~bit
        if self._failed:
            return
        if not self._pending:
            cfg = self.sim._compute
            if (cfg is not None and cfg.max_batch > 1
                    and self.node.compute_plane is not None):
                # same-function batching (docs/compute.md): hand over to
                # the node's open collector instead of computing solo
                coll = self.node.compute_batches.get(self.fn.name)
                if coll is None or coll.closed:
                    coll = BatchCollector(self.sim.clock, self.node,
                                          self.fn, cfg, _batch_finish)
                    self.node.compute_batches[self.fn.name] = coll
                coll.join(self)
                return
            self._completion = Completion(
                self.sim, self.node, self.fn, self.rec, self.inst,
                self.release_bytes,
                # private bytes leave the host tier with the invocation
                # (the daemon drops writable entries at release())
                extra_done=(self._drop_host if self.release_bytes else None),
                owner=self if self.node.fault_tracking else None)

    def _drop_host(self) -> None:
        self.node.release_host(self.release_bytes)

    # ------------------------------------------------------------------
    # context path (parallel with data path). The context is shared per
    # instance: exactly ONE builder reserves+creates; concurrent
    # invocations latch onto it (double-reserving 414 MB per concurrent
    # arrival leaks the device dry under load).
    # ------------------------------------------------------------------
    def _start_ctx(self) -> None:
        inst, rec, node = self.inst, self.rec, self.node
        if inst.has_ctx:
            rec.stages["gpu_ctx"] = 0.0
            self._path_done(_CTX)
        elif inst.ctx_building:
            inst.ctx_waiters.append((self._ctx_ok, self._ctx_late_fail))
        else:
            inst.ctx_building = True
            rec.stages["cpu_ctx"] = CPU_CTX_S
            node.reserve(self.fn.ctx_bytes, self._ctx_start,
                         on_fail=self._ctx_fail,
                         key=node.admission_key(rec),
                         max_retries=rec.max_retries)

    def _ctx_ok(self) -> None:
        self._path_done(_CTX)

    def _ctx_late_fail(self) -> None:
        self._fail("context memory not granted within deadline")

    def _ctx_start(self) -> None:
        # paper-faithful: a dropped GPU context costs a full re-creation
        # (Table 4 stage 3 = 309.5 ms). The beyond-paper
        # ``executable_cache`` policy (TPU: XLA executables are
        # host-cacheable objects, CUDA contexts are not) re-loads the
        # program at ~10% of a compile.
        cost = GPU_CTX_S
        if getattr(self.sim.policy, "executable_cache", False) \
                and self.warm is not None:
            cost = GPU_CTX_S * 0.1
        self.rec.stages["gpu_ctx"] = cost
        self.sim.clock.schedule(CPU_CTX_S + cost, self._ctx_done,
                                kind=EventKind.TIMER)

    def _ctx_done(self) -> None:
        inst = self.inst
        inst.has_ctx = True
        inst.ctx_building = False
        self._path_done(_CTX)
        for ok, _ in inst.ctx_waiters:
            ok()
        inst.ctx_waiters = []

    def _ctx_fail(self) -> None:
        inst = self.inst
        inst.ctx_building = False
        waiters, inst.ctx_waiters = inst.ctx_waiters, []
        self._fail("context memory not granted within deadline")
        for _, fl in waiters:
            fl()

    # ------------------------------------------------------------------
    # the invocation's private bytes, one atomic reservation; data loads
    # start only once the memory is granted. The private bytes transit
    # (and occupy) the host tier for the invocation's lifetime, so host
    # admission happens here too — the twin of the daemon's _admit_host
    # on the db->host leg.
    # ------------------------------------------------------------------
    def _start_mem(self) -> None:
        if self.release_bytes:
            self.node.reserve(
                self.release_bytes, self._mem_granted_cb,
                on_fail=self._mem_fail,
                key=self.node.admission_key(self.rec),
                max_retries=self.rec.max_retries)
        else:
            self._mem_granted_cb()

    def _mem_fail(self) -> None:
        self._fail("working-set memory not granted within deadline")

    def _mem_granted_cb(self) -> None:
        node, fn, rec = self.node, self.fn, self.rec
        if self._failed:
            # another path (ctx/ro) already failed this invocation:
            # hand the late grant straight back
            if self.release_bytes:
                node.release(self.release_bytes)
            return
        if self.release_bytes and not node.reserve_host(self.release_bytes):
            node.release(self.release_bytes)
            node.load_failures += 1
            self._fail("host memory not granted within deadline")
            return
        self._mem_granted = True  # device AND host bytes held
        self._path_done(_MEM)
        if not self.share and fn.ro_bytes:
            self._load_private(fn.ro_bytes, self._ro_ok,
                               key=node.admission_key(rec))
        if fn.w_bytes:
            self._load_private(fn.w_bytes, self._win_ok,
                               key=node.admission_key(rec))
        else:
            self._path_done(_WIN)

    def _ro_ok(self) -> None:
        self._path_done(_RO)

    def _win_ok(self) -> None:
        self._path_done(_WIN)

    def _priv_load_fail(self, reason: str) -> None:
        # private-leg fault: _fail rolls back the granted device+host
        # bytes exactly (the _mem_granted path)
        self._fail(reason)

    def _load_private(self, nbytes: int, done: Callable, *, key) -> None:
        # memory was already granted atomically; the transfer itself runs
        # on the node's bounded loader gate. cpu_data keeps the solo db
        # estimate; gpu_data is recorded by load() as the ACTUAL
        # contended+preempted PCIe span (docs/dataplane.md)
        rec, node = self.rec, self.node
        rec.stages["cpu_data"] = (rec.stages.get("cpu_data", 0.0)
                                  + nbytes / node.db.bw)
        node.load(nbytes, done, key=key, rec=rec,
                  on_fail=self._priv_load_fail, poison=self._take_poison(),
                  jitter_s=self._take_jitter())

    # ------------------------------------------------------------------
    # shared read-only data path
    # ------------------------------------------------------------------
    def _start_ro(self) -> None:
        node, fn, rec, share = self.node, self.fn, self.rec, self.share
        st = node.ro_state[fn.name] if share else "none"
        if not share or fn.ro_bytes == 0:
            if share or not fn.ro_bytes:  # nothing shared to wait for
                self._path_done(_RO)
            # (private RO load is driven from _mem_granted_cb above)
        elif st == "device":
            rec.stages["gpu_data"] = 0.0
            self._path_done(_RO)
        elif st == "loading":
            node.ro_ready_cbs[fn.name].append(
                (self._ro_ok, self._ro_inflight_fail))
        elif st == "host":
            # stage-2 hit: PCIe only (the host copy is already resident
            # and admitted — no new host reservation)
            node.ro_state[fn.name] = "loading"
            node.touch_host(fn.name)
            node.reserve(fn.ro_bytes, self._ro_promote,
                         on_fail=self._ro_host_fail,
                         key=node.admission_key(rec),
                         max_retries=rec.max_retries)
        else:
            node.ro_state[fn.name] = "loading"
            node.reserve(fn.ro_bytes, self._ro_dev_granted,
                         on_fail=self._ro_dev_fail,
                         key=node.admission_key(rec),
                         max_retries=rec.max_retries)
            rec.stages["cpu_data"] = fn.ro_bytes / node.db.bw

    def _ro_inflight_fail(self) -> None:
        self._fail("shared read-only load failed")

    def _ro_promote(self) -> None:
        node, fn, rec = self.node, self.fn, self.rec
        node.load(fn.ro_bytes, self._ro_promoted, via_db=False,
                  key=node.admission_key(rec), rec=rec)

    def _ro_promoted(self) -> None:
        node, fn, inst = self.node, self.fn, self.inst
        node.ro_state[fn.name] = "device"
        inst.has_ro_device = True
        inst.has_ro_host = False
        for ok, _ in node.ro_ready_cbs[fn.name]:
            ok()
        node.ro_ready_cbs[fn.name] = []
        self._path_done(_RO)

    def _ro_host_fail(self) -> None:
        node, fn = self.node, self.fn
        node.ro_state[fn.name] = "host"  # entry keeps its host copy
        cbs, node.ro_ready_cbs[fn.name] = node.ro_ready_cbs[fn.name], []
        self._fail("shared read-only memory not granted within deadline")
        for _, fl in cbs:
            fl()

    def _ro_dev_granted(self) -> None:
        node, fn, rec = self.node, self.fn, self.rec
        # db->host leg needs host admission (daemon._admit_host twin); the
        # host copy then stays resident alongside the device copy until
        # stage 4 drops it
        if not node.reserve_host(fn.ro_bytes):
            node.release(fn.ro_bytes)
            node.load_failures += 1
            self._ro_dev_fail()
            return
        node.host_resident[fn.name] = fn.ro_bytes
        node.touch_host(fn.name)
        node.load(fn.ro_bytes, self._ro_dev_loaded,
                  key=node.admission_key(rec), rec=rec,
                  on_fail=self._ro_load_fail, poison=self._take_poison())

    def _ro_dev_loaded(self) -> None:
        node, fn, inst = self.node, self.fn, self.inst
        node.ro_state[fn.name] = "device"
        inst.has_ro_device = True
        for ok, _ in node.ro_ready_cbs[fn.name]:
            ok()
        node.ro_ready_cbs[fn.name] = []
        self._path_done(_RO)

    def _ro_dev_fail(self) -> None:
        node, fn = self.node, self.fn
        node.ro_state[fn.name] = "none"
        node.drop_host_resident(fn.name)
        cbs, node.ro_ready_cbs[fn.name] = node.ro_ready_cbs[fn.name], []
        self._fail("shared read-only memory not granted within deadline")
        for _, fl in cbs:
            fl()

    def _ro_load_fail(self, reason: str) -> None:
        # cold-load fault AFTER the device grant (unlike _ro_dev_fail,
        # where the grant never happened): hand the ro bytes back first,
        # then tear down exactly like the no-grant path
        node, fn = self.node, self.fn
        node.release(fn.ro_bytes)
        node.ro_state[fn.name] = "none"
        node.drop_host_resident(fn.name)
        cbs, node.ro_ready_cbs[fn.name] = node.ro_ready_cbs[fn.name], []
        self._fail(f"shared read-only load failed: {reason}")
        for _, fl in cbs:
            fl()


class FixedInvocation:
    """FixedGSL lifecycle (paper §3.2.1/§7.1): only the *container* is
    pre-warmed — the coarse-grained platform re-runs every GPU setup stage
    per invocation, serially (cpu_ctx -> gpu_ctx -> db -> pcie -> compute).
    The fixed slot is held while the container instance is warm, capping
    concurrency."""

    __slots__ = ("sim", "node", "fn", "rec", "inst", "total", "_failed",
                 "_poison", "_jitter")

    def __init__(self, sim, node: GPUNode, fn: SimFunction,
                 rec: InvocationRecord, injected: bool = False,
                 jitter_s: float = 0.0):
        self.sim = sim
        self.node = node
        self.fn = fn
        self.rec = rec
        self._failed = False
        self._poison = injected
        self._jitter = jitter_s
        if node.fault_tracking:
            node.active.add(self)
        node._advance_ladders()
        insts = node.instances[fn.name]
        now = sim.clock.now()
        for cand in insts:
            if not cand.busy and not cand.dead \
                    and cand.ladder.stage_at(now) == 1:
                cand.ladder.on_reuse(now)
                cand.busy = True
                rec.warm_stage = 1  # warm *container*: skips slot wait only
                self.inst = cand
                self._setup()
                return
        inst = self.inst = SimInstance(fn)
        inst.busy = True
        inst.ladder.ttls = (sim.policy.keep_warm_s, 0.0, 0.0, 0.0)
        inst.ladder.on_enter = {2: (lambda i=inst: node._destroy(i))}
        insts.append(inst)
        # ctx + data memory live inside the fixed slot (no extra reserve)
        inst.slot = fn.slot_bytes(sim.policy.slot_granularity)
        node.reserve(inst.slot, self._setup, on_fail=self._slot_fail,
                     key=node.admission_key(rec),
                     max_retries=rec.max_retries)

    def on_node_lost(self) -> None:
        if self._failed:
            return
        self._failed = True
        self.sim._node_lost(self)

    def _setup(self) -> None:
        if self._failed:
            return
        rec, fn = self.rec, self.fn
        rec.stages["cpu_ctx"] = CPU_CTX_S
        rec.stages["gpu_ctx"] = GPU_CTX_S
        self.total = fn.ro_bytes + fn.w_bytes
        self.sim.clock.schedule(CPU_CTX_S + GPU_CTX_S, self._load,
                                kind=EventKind.TIMER)

    def _load(self) -> None:
        if self._failed:
            return
        node, rec = self.node, self.rec
        rec.stages["cpu_data"] = self.total / node.db.bw
        poison, self._poison = self._poison, False
        jitter, self._jitter = self._jitter, 0.0
        node.load(self.total, self._loaded, key=node.admission_key(rec),
                  rec=rec, on_fail=self._load_fail, poison=poison,
                  jitter_s=jitter)

    def _loaded(self) -> None:
        if self._failed:
            return
        Completion(self.sim, self.node, self.fn, self.rec, self.inst, 0,
                   owner=self if self.node.fault_tracking else None)

    def _load_fail(self, reason: str) -> None:
        # the container's GPU state is suspect after a failed load: the
        # whole slot dies with the invocation (release via _destroy)
        if self._failed:
            return
        self._failed = True
        if self.node.fault_tracking:
            self.node.active.discard(self)
        self.sim._fail_record(self.fn, self.rec, reason)
        self.inst.busy = False
        self.node._destroy(self.inst)

    def _slot_fail(self) -> None:
        # never got the slot: the instance dies without holding memory
        if self._failed:
            return
        self._failed = True
        if self.node.fault_tracking:
            self.node.active.discard(self)
        inst, insts = self.inst, self.node.instances[self.fn.name]
        slot = inst.slot
        inst.slot = 0
        inst.dead = True
        if inst in insts:
            insts.remove(inst)
        self.sim._fail_record(self.fn, self.rec,
                              f"no {slot}-byte slot within deadline")


class DgsfInvocation:
    """DGSF lifecycle: contexts are pre-created and pooled per function;
    an arrival waits (FCFS) for a free context slot, then loads its data
    and computes. Data bytes and the slot recycle after compute."""

    __slots__ = ("sim", "node", "fn", "rec", "total", "_failed", "_poison",
                 "_jitter")

    def __init__(self, sim, node: GPUNode, fn: SimFunction,
                 rec: InvocationRecord, injected: bool = False,
                 jitter_s: float = 0.0):
        self.sim = sim
        self.node = node
        self.fn = fn
        self.rec = rec
        self._failed = False
        self._poison = injected
        self._jitter = jitter_s
        if node.fault_tracking:
            node.active.add(self)
        if node.dgsf_free[fn.name] > 0:
            node.dgsf_free[fn.name] -= 1
            self._with_ctx()
        else:
            node.dgsf_queue[fn.name].append(self._dequeue)

    def on_node_lost(self) -> None:
        if self._failed:
            return
        self._failed = True
        self.sim._node_lost(self)

    def _dequeue(self) -> None:
        if self._failed:
            return
        self.node.dgsf_free[self.fn.name] -= 1
        self._with_ctx()

    def _with_ctx(self) -> None:
        node, fn, rec = self.node, self.fn, self.rec
        rec.stages["cpu_ctx"] = CPU_CTX_S
        rec.stages["gpu_ctx"] = 0.0  # pre-created
        self.total = fn.ro_bytes + fn.w_bytes
        rec.warm_stage = 1
        rec.stages["cpu_data"] = self.total / node.db.bw
        node.reserve(self.total, self._granted, on_fail=self._data_fail,
                     key=node.admission_key(rec),
                     max_retries=rec.max_retries)

    def _granted(self) -> None:
        if self._failed:
            return
        node, rec = self.node, self.rec
        poison, self._poison = self._poison, False
        jitter, self._jitter = self._jitter, 0.0
        node.load(self.total, self._computed, key=node.admission_key(rec),
                  rec=rec, on_fail=self._load_fail, poison=poison,
                  jitter_s=jitter)

    def _computed(self) -> None:
        if self._failed:
            return
        # release data + ctx slot after compute
        CallbackCompletion(self.sim, self.node, self.fn, self.rec,
                           self._release,
                           owner=self if self.node.fault_tracking else None)

    def _release(self) -> None:
        self.node.release(self.total)
        self._free_ctx_slot()

    def _free_ctx_slot(self) -> None:
        node, fn = self.node, self.fn
        node.dgsf_free[fn.name] += 1
        if node.dgsf_queue[fn.name]:
            node.dgsf_queue[fn.name].pop(0)()

    def _load_fail(self, reason: str) -> None:
        if self._failed:
            return
        self._failed = True
        if self.node.fault_tracking:
            self.node.active.discard(self)
        self.sim._fail_record(self.fn, self.rec, reason)
        self.node.release(self.total)
        self._free_ctx_slot()

    def _data_fail(self) -> None:
        if self._failed:
            return
        self._failed = True
        if self.node.fault_tracking:
            self.node.active.discard(self)
        self.sim._fail_record(self.fn, self.rec,
                              "data memory not granted within deadline")
        self._free_ctx_slot()
