"""Per-function engine (paper §4.1) and instance model.

The instance model is what separates the systems (§7):

* SAGE        — ONE shared engine per (function, device): concurrent
  invocations share the GPU context (compiled executable) and read-only
  data; lifecycle ends via the multi-stage exit ladder.
* FixedGSL/-F — one *instance* (slot + context + private data) per
  concurrent invocation; idle instances stay warm for ``keep_warm_s``;
  colds pay the full serial setup chain.
* DGSF        — ``pre_created_contexts`` context slots per function (FCFS);
  contexts are never created on the critical path, but every invocation
  loads its own data (no read-only sharing).
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.baselines import SystemPolicy
from repro_torch.core.daemon import (
    GPU_CONTEXT_BYTES, DataLoadError, Handle, MemoryDaemon, NodeLostError,
    OutOfDeviceMemory,
)
from repro_torch.core.exit_policy import ExitLadder
from repro_torch.core.request import Request
from repro_torch.core.shim import TaxonShim
from repro_torch.core.slowness import HedgedError
from repro_torch.core.telemetry import InvocationRecord


@dataclass
class GPUFunction:
    """A registered serverless GPU function."""

    name: str
    handler: Callable[[TaxonShim, Request], Any]
    context_builder: Callable[[], Any]  # expensive: kernel build/load (gpu_ctx)
    read_only: Dict[str, int] = field(default_factory=dict)  # key -> bytes
    writable_hint: int = 0
    context_bytes: int = GPU_CONTEXT_BYTES
    cpu_ctx_s: float = 0.001      # paper Table 4: ~1 ms
    container_s: float = 2.0      # only paid when containers are not prewarmed
    compute_s_hint: float = 0.0   # simulator profile (real mode measures)
    # declared SM fraction in (0, 1] for the shared compute plane
    # (docs/compute.md); None = auto, derived from compute_s_hint
    sm_fraction: Optional[float] = None

    def total_bytes(self) -> int:
        return self.context_bytes + sum(self.read_only.values()) + self.writable_hint


class Instance:
    """One container+context+private-data unit."""

    # shared across all instances; itertools.count never exhausts and its
    # __next__ is atomic under CPython
    _ids = itertools.count()

    def __init__(self, fn: GPUFunction):
        self.id = next(self._ids)
        self.fn = fn
        self.gpu_ctx: Any = None
        self.cpu_ctx_alive = False
        self.container_alive = False
        self.busy = False
        self.reaping = False  # claimed by a ladder-advance pass
        self.ladder = ExitLadder()
        self.slot_bytes = 0           # FixedGSL slot reservation
        self.private_handles: Dict[str, Handle] = {}  # baseline warm data
        self.dead = False


class FunctionEngine:
    """Engine for one (function, device) pair under a given system policy."""

    def __init__(
        self,
        fn: GPUFunction,
        policy: SystemPolicy,
        daemon: MemoryDaemon,
        executor,
        clock,
        *,
        time_scale: float = 1.0,
        exit_ttl: float = 30.0,
    ):
        self.fn = fn
        self.policy = policy
        self.daemon = daemon
        self.executor = executor
        self.clock = clock
        self.time_scale = time_scale
        self.exit_ttl = exit_ttl
        self._lock = threading.Condition()
        self.instances: List[Instance] = []
        self._dgsf_sem = (
            threading.Semaphore(policy.pre_created_contexts)
            if policy.pre_created_contexts else None
        )
        self._shared_ctx: Any = None  # SAGE / DGSF compiled executable
        self._ctx_build_lock = threading.Lock()
        if policy.pre_created_contexts:
            # DGSF: pre-create contexts at registration (off critical path);
            # memory cost is permanent (the paper's 4 x 414 MB overhead)
            for _ in range(policy.pre_created_contexts):
                self.daemon.reserve_context(fn.context_bytes)
            self._shared_ctx = fn.context_builder()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _sleep(self, dt: float) -> None:
        if dt > 0:
            self.clock.sleep(dt * self.time_scale)

    def _advance_ladders(self) -> None:
        # ladder actions call into the daemon (demote/drop/destroy), which
        # takes the daemon lock — and the daemon's eviction path calls back
        # into this engine under *its* lock. Running the actions outside
        # self._lock keeps the two locks strictly ordered (daemon -> engine)
        # and kills the ABBA deadlock the seed runtime could hit under load.
        # Each idle instance is CLAIMED (reaping) under the lock first, so a
        # concurrent invocation cannot grab it mid-action and a second
        # advance pass cannot double-run the stage callbacks.
        now = self.clock.now()
        with self._lock:
            claimed = []
            for inst in self.instances:
                if not inst.busy and not inst.dead and not inst.reaping:
                    inst.reaping = True
                    claimed.append(inst)
        for inst in claimed:
            try:
                s = inst.ladder.advance(now)
                if s >= 5:
                    self._destroy(inst)
            finally:
                with self._lock:
                    inst.reaping = False
                    self._lock.notify_all()

    def _destroy(self, inst: Instance) -> None:
        # claim the instance under the lock (ladder actions run on several
        # threads); the actual releases happen outside it to preserve the
        # daemon -> engine lock ordering
        with self._lock:
            if inst.dead:
                return
            inst.dead = True
            # claim the resources under the same lock (a crash sweep and
            # an in-flight _ensure_ctx may both try to release — exactly
            # one claimant wins, so the accounting rolls back exactly once)
            ctx, inst.gpu_ctx = inst.gpu_ctx, None
            slot, inst.slot_bytes = inst.slot_bytes, 0
            handles, inst.private_handles = inst.private_handles, {}
        if ctx is not None:
            self.daemon.release_context(self.fn.context_bytes)
        if slot:
            self.daemon.release_slot(slot)
        if handles:
            req = Request(function_name=self.fn.name)
            self.daemon.release(req, handles)
        with self._lock:
            if inst in self.instances:
                self.instances.remove(inst)

    def evictable_entries(self):
        self._advance_ladders()
        return self.daemon.evictable_entries(self.fn.name)

    # ------------------------------------------------------------------
    # transfer-scheduling attribution (docs/dataplane.md)
    # ------------------------------------------------------------------
    def _attribute_transfer(self, record: InvocationRecord,
                            handles: Dict[str, Handle]) -> None:
        """Claim the handles' not-yet-attributed preemption/stall totals
        for this record. Claim-once semantics live in the daemon: a pause
        on a shared entry lands on exactly ONE sharer's record, so
        Telemetry totals stay comparable across backends."""
        p, s = self.daemon.claim_transfer_attribution(handles)
        record.preemptions += p
        record.stalled_s += s

    def idle_memory_bytes(self) -> int:
        """Memory pinned by warm-but-idle state (Fig 12 accounting)."""
        total = 0
        with self._lock:
            for inst in self.instances:
                if not inst.busy and not inst.dead:
                    if inst.gpu_ctx is not None:
                        total += self.fn.context_bytes
                    total += inst.slot_bytes
        return total

    # ------------------------------------------------------------------
    # invocation entry point
    # ------------------------------------------------------------------
    def invoke(self, request: Request, record: InvocationRecord) -> Any:
        self._advance_ladders()
        if self.policy.name.startswith("sage"):
            return self._invoke_sage(request, record)
        if self.policy.pre_created_contexts:
            return self._invoke_dgsf(request, record)
        return self._invoke_fixed(request, record)

    # ------------------------------------------------------------------
    # SAGE: parallel setup + sharing + multi-stage exit
    # ------------------------------------------------------------------
    def _sage_instance(self) -> Instance:
        """Claim the shared instance (marking it busy atomically with the
        lookup — a ladder-advance pass mid-claim could otherwise demote or
        destroy it under the invocation's feet)."""
        with self._lock:
            while True:
                inst = next((i for i in self.instances if not i.dead), None)
                if inst is None:
                    break
                if not inst.reaping:
                    inst.busy = True
                    return inst
                self._lock.wait(timeout=0.05)  # advance pass is quick
            inst = Instance(self.fn)
            inst.ladder.ttls = (self.exit_ttl,) * 4  # paper: 30 s per stage
            inst.ladder.on_enter = {
                2: lambda: self.daemon.demote_to_host(self.fn.name),
                3: lambda: self._drop_ctx(inst),
                4: lambda: (self.daemon.drop_host(self.fn.name),
                            setattr(inst, "cpu_ctx_alive", False)),
            }
            inst.busy = True
            self.instances.append(inst)
            return inst

    def _drop_ctx(self, inst: Instance) -> None:
        if inst.gpu_ctx is not None:
            self.daemon.release_context(self.fn.context_bytes)
            inst.gpu_ctx = None

    def _ensure_ctx(self, inst: Instance,
                    request: Optional[Request] = None) -> float:
        """Create the GPU context (compile) if missing; returns seconds.
        The requesting invocation's SLO orders the context-memory admission
        wait under ``scheduler="edf"``."""
        prio, deadline_at = (self.daemon.request_slo(request)
                            if request is not None else (0, None))
        budget = request.max_retries if request is not None else None
        t0 = time.monotonic()
        with self._ctx_build_lock:
            if inst.gpu_ctx is None:
                self.daemon.reserve_context(self.fn.context_bytes,
                                            priority=prio,
                                            deadline_at=deadline_at,
                                            max_retries=budget)
                try:
                    if self._shared_ctx is not None and self.policy.share_context:
                        inst.gpu_ctx = self._shared_ctx  # executable cache hit:
                        # context *memory* must still be re-established, but the
                        # compile is amortized (stage-3 recreate is cheap on TPU
                        # when the executable is cached; we keep the conservative
                        # paper model and rebuild unless shared)
                    else:
                        inst.gpu_ctx = self.fn.context_builder()
                except BaseException:
                    self.daemon.release_context(self.fn.context_bytes)
                    raise
                if self.policy.share_context:
                    self._shared_ctx = inst.gpu_ctx
        if inst.dead or self.daemon.dead:
            # the node crashed while the context was building: the crash
            # sweep saw gpu_ctx=None and could not release it, so this
            # thread still owns the reservation — claim-and-release here
            # (same lock as _destroy, so exactly one side wins)
            with self._lock:
                ctx, inst.gpu_ctx = inst.gpu_ctx, None
            if ctx is not None:
                self.daemon.release_context(self.fn.context_bytes)
            raise NodeLostError(self.fn.name,
                                self.daemon.dead_reason or "node crashed")
        return time.monotonic() - t0

    def _hedge_check(self, request: Request) -> None:
        """Cooperative hedge-cancel checkpoint (docs/resilience.md): a
        loser aborts here and unwinds through the same finally chain as a
        failure, so handles/slots/contexts release byte-exactly."""
        ev = request.hedge_cancel
        if ev is not None and ev.is_set():
            raise HedgedError(f"{self.fn.name}: superseded by hedged twin")

    def _invoke_sage(self, request: Request, record: InvocationRecord) -> Any:
        # a loser already cancelled before it started must start nothing:
        # checked before the instance claim so no slot, load, or context
        # is ever touched and the books stay exactly zero
        self._hedge_check(request)
        inst = self._sage_instance()  # returned already claimed (busy=True)
        now = self.clock.now()
        with self._lock:
            warm = inst.ladder.on_reuse(now) if inst.ladder.completion_t else None
        record.warm_stage = warm
        record.stages["container_create"] = (
            0.0 if (self.policy.prewarmed_container or inst.container_alive)
            else self.fn.container_s
        )
        self._sleep(record.stages["container_create"])
        inst.container_alive = True
        if not inst.cpu_ctx_alive:
            record.stages["cpu_ctx"] = self.fn.cpu_ctx_s
            self._sleep(self.fn.cpu_ctx_s)
            inst.cpu_ctx_alive = True
        else:
            record.stages["cpu_ctx"] = 0.0

        # --- the parallelized setup: daemon loads while we build the ctx.
        # On any failure (DataLoadError from a handle, OOM on the context)
        # the finally block still releases the handles — which cancels any
        # still-loading writable entries — and frees the instance, so a
        # failed invocation neither leaks accounting nor wedges the engine.
        t_par0 = time.monotonic()
        handles = self.daemon.prepare(
            request, system_shares_ro=self.policy.share_read_only
        )
        try:
            self._hedge_check(request)  # before the expensive compile...
            ctx_s = self._ensure_ctx(inst, request)
            record.stages["gpu_ctx"] = ctx_s
            self._hedge_check(request)  # ...and before the kernel launches
            # compute launches resolve handles; wait = data not hidden by ctx
            result, data_wait = self._run_handler(inst, request, handles, record)
            record.stages["gpu_data"] = data_wait
            record.stages["cpu_data"] = 0.0  # folded into daemon pipeline (async)
            record.setup_wall = time.monotonic() - t_par0 - record.stages.get("compute", 0.0)
            return result
        finally:
            self._attribute_transfer(record, handles)
            self.daemon.release(request, handles)
            with self._lock:
                inst.busy = False
                inst.ladder.on_complete(self.clock.now())

    # ------------------------------------------------------------------
    # FixedGSL / FixedGSL-F: serial setup, per-invocation instances
    # ------------------------------------------------------------------
    def _acquire_instance(self, record: InvocationRecord) -> Instance:
        with self._lock:
            for inst in self.instances:
                if not inst.busy and not inst.dead and not inst.reaping \
                        and inst.ladder.stage_at(self.clock.now()) == 1:
                    inst.busy = True
                    inst.ladder.on_reuse(self.clock.now())
                    record.warm_stage = 1
                    return inst
            inst = Instance(self.fn)
            inst.busy = True
            self.instances.append(inst)
            return inst

    def _slot_bytes(self) -> int:
        need = self.fn.total_bytes()
        g = self.policy.slot_granularity
        if g:
            need = ((need + g - 1) // g) * g
        return need

    def _invoke_fixed(self, request: Request, record: InvocationRecord) -> Any:
        inst = self._acquire_instance(record)
        warm = record.warm_stage == 1
        try:
            if not warm:
                # admission: reserve the (rounded) slot; the daemon blocks
                # with backpressure and raises past its deadline instead of
                # spinning forever on OOM
                need = self._slot_bytes()
                prio, deadline_at = self.daemon.request_slo(request)
                try:
                    self.daemon.reserve_slot(need, priority=prio,
                                             deadline_at=deadline_at,
                                             max_retries=request.max_retries)
                except OutOfDeviceMemory as oom:
                    raise DataLoadError(
                        f"{self.fn.name}/slot",
                        f"no {need}-byte slot within deadline", oom,
                    ) from oom
                inst.slot_bytes = need
                record.stages["container_create"] = (
                    0.0 if self.policy.prewarmed_container else self.fn.container_s
                )
                self._sleep(record.stages["container_create"])
                inst.container_alive = True
                record.stages["cpu_ctx"] = self.fn.cpu_ctx_s
                self._sleep(self.fn.cpu_ctx_s)
                inst.cpu_ctx_alive = True
                # serial: ctx FIRST (implicit creation), then data
                t0 = time.monotonic()
                self.daemon.reserve_context(self.fn.context_bytes,
                                            priority=prio,
                                            deadline_at=deadline_at,
                                            max_retries=request.max_retries)
                try:
                    inst.gpu_ctx = self.fn.context_builder()
                except BaseException:
                    self.daemon.release_context(self.fn.context_bytes)
                    raise
                record.stages["gpu_ctx"] = time.monotonic() - t0
                t0 = time.monotonic()
                handles = self.daemon.prepare(request, system_shares_ro=False)
                inst.private_handles = handles
                for h in handles.values():  # serial wait: db->host->device
                    h.wait()
                record.stages["cpu_data"] = 0.0
                record.stages["gpu_data"] = time.monotonic() - t0
                self._attribute_transfer(record, handles)
            else:
                handles = inst.private_handles
                for s in ("container_create", "cpu_ctx", "gpu_ctx", "cpu_data", "gpu_data"):
                    record.stages[s] = 0.0
            result, _ = self._run_handler(inst, request, dict(handles), record)
            return result
        except Exception:
            # failed setup or compute: tear the instance down (releases the
            # slot, context, and private handles — cancelling in-flight
            # loads) rather than leaving a half-built warm instance around
            self._destroy(inst)
            raise
        finally:
            with self._lock:
                inst.busy = False
                inst.ladder.ttls = (self.policy.keep_warm_s, 0.0, 0.0, 0.0)
                inst.ladder.on_enter = {k: (lambda i=inst: self._destroy(i)) for k in (2,)}
                inst.ladder.on_complete(self.clock.now())

    # ------------------------------------------------------------------
    # DGSF: pre-created contexts, FCFS, no read-only sharing
    # ------------------------------------------------------------------
    def _invoke_dgsf(self, request: Request, record: InvocationRecord) -> Any:
        self._dgsf_sem.acquire()  # FCFS over the 4 contexts
        try:
            record.stages["container_create"] = 0.0
            record.stages["cpu_ctx"] = self.fn.cpu_ctx_s
            self._sleep(self.fn.cpu_ctx_s)
            record.stages["gpu_ctx"] = 0.0  # pre-created
            t0 = time.monotonic()
            handles = self.daemon.prepare(request, system_shares_ro=False)
            try:
                for h in handles.values():
                    h.wait()
                record.stages["cpu_data"] = 0.0
                record.stages["gpu_data"] = time.monotonic() - t0
                self._attribute_transfer(record, handles)
                record.warm_stage = 1
                inst = Instance(self.fn)
                inst.gpu_ctx = self._shared_ctx
                result, _ = self._run_handler(inst, request, handles, record)
                return result
            finally:
                # release on every path: a DataLoadError mid-wait must still
                # drop/cancel this invocation's private entries
                self.daemon.release(request, handles)
        finally:
            self._dgsf_sem.release()

    # ------------------------------------------------------------------
    def _run_handler(self, inst: Instance, request: Request, handles, record=None):
        """Run the user handler through the taxon shim; returns
        (result, data_wait_seconds). ``record`` gets compute/return stages."""
        shim = TaxonShim(self.daemon, self.executor, request, handles)
        shim.gpu_ctx = inst.gpu_ctx
        w0 = self.executor.wait_time
        t0 = time.monotonic()
        result = self.fn.handler(shim, request)
        wall = time.monotonic() - t0
        data_wait = self.executor.wait_time - w0
        if record is not None:
            record.stages["compute"] = max(wall - data_wait, 0.0)
            record.stages["return_result"] = 0.0001
            # batch attribution stamped on the request by the compute
            # plane's collector (docs/compute.md); defaults when off
            record.batch_size = getattr(request, "batch_size", 1)
            record.batched_with = getattr(request, "batched_with", ())
        return result, data_wait
