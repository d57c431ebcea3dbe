"""FunctionSpec: one declarative function description, two lowerings.

The spec is the single way benchmarks, examples, and tests describe a
serverless GPU function: a name, a model-zoo arch (for the real backend), a
paper Table-2 profile and/or explicit byte sizes, a compute hint, and
optional per-request SLO defaults. The gateway lowers it to

* a real ``GPUFunction`` (``core.functions.make_model_function``: the
  hand-written kernels built and loaded as the context, real weights in
  the database, on the database's device) for the threaded
  ``SageRuntime``, or
* a ``SimFunction`` (modeled bytes/durations) for the virtual-time
  ``Simulator`` twin,

so the same object can drive both drivers and their telemetry compares 1:1
(docs/api.md has the field-by-field lowering table).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.core.profiles import MB, PROFILES, FunctionProfile

# defaults when the spec neither names a paper profile nor declares bytes —
# a small function that stays fast in both backends. The real lowering
# without a profile instead declares the arch's true parameter bytes, so
# parity runs should always pin a profile or explicit sizes.
_DEFAULT_RO_MB = 16.0
_DEFAULT_W_MB = 4.0
_DEFAULT_CTX_MB = 414.0  # paper Table 2: context memory is arch-invariant
_DEFAULT_COMPUTE_MS = 10.0


@dataclass(frozen=True)
class FunctionSpec:
    """Declarative description of one serverless GPU function."""

    name: str
    arch: str = "qwen2.5-3b"  # model-zoo arch served by the real backend
    profile: Optional[Union[str, FunctionProfile]] = None  # paper Table 2 row
    read_only_bytes: Optional[int] = None  # override the profile's RO bytes
    writable_bytes: Optional[int] = None   # override writable working set
    context_bytes: Optional[int] = None    # override GPU context memory
    compute_ms: Optional[float] = None     # modeled kernel time (sim) / hint
    deadline_s: Optional[float] = None     # default SLO for every request
    priority: int = 0                      # default priority (orders "edf")
    # admission scheduling this function was validated under ("fifo"|"edf");
    # an undecided Gateway adopts it at register(), a gateway pinned to a
    # different scheduler refuses the spec (docs/api.md)
    scheduler: Optional[str] = None
    # cluster dispatch policy this function was validated under
    # ("random"|"locality"|"least_loaded"); same adopt/conflict semantics
    # as ``scheduler`` (docs/cluster.md)
    dispatch: Optional[str] = None
    # transfer scheduling this function was validated under
    # ("run_to_completion"|"preemptive"); same adopt/conflict semantics
    # as ``scheduler`` (docs/dataplane.md, "Transfer scheduling")
    transfer: Optional[str] = None
    # predictive autoscaling policy this function was validated under
    # (an ``AutoscaleConfig`` or its kwargs as a dict, normalized at
    # construction); same adopt/conflict semantics (docs/planner.md)
    autoscale: Optional[object] = None
    batch: int = 1                         # real backend request shape
    seq: int = 16
    seed: int = 0                          # real backend weight init
    # per-function circuit-breaker policy (docs/resilience.md); overrides
    # any gateway-wide ``breaker=`` for this function at register()
    breaker: Optional[object] = None
    # tail-tolerance policies this function was validated under
    # (docs/resilience.md, "Gray failures"): ``hedging`` is a
    # ``HedgeConfig``/kwargs dict/True, ``quarantine`` a
    # ``QuarantineConfig``/kwargs dict/True — normalized at construction;
    # same adopt-or-refuse semantics as ``scheduler``
    hedging: Optional[object] = None
    quarantine: Optional[object] = None
    # shared-compute-plane policy this function was validated under
    # (docs/compute.md): ``"shared"``/``ComputeConfig``/kwargs dict —
    # normalized at construction; same adopt-or-refuse semantics as
    # ``scheduler``. None/"exclusive" = the seed's exclusive FIFO.
    compute: Optional[object] = None
    # declared SM fraction in (0, 1] for the shared plane; None = auto,
    # derived from the function's profiled compute stage
    sm_fraction: Optional[float] = None

    def __post_init__(self):
        from repro_torch.core.daemon import SCHEDULERS  # the authoritative lists
        from repro_torch.core.dispatch import DISPATCH_POLICIES
        from repro_torch.core.faults import BreakerConfig
        from repro_torch.core.slowness import resolve_hedging, resolve_quarantine
        from repro_torch.core.transfer import TRANSFER_MODES

        if self.hedging is not None:
            object.__setattr__(self, "hedging", resolve_hedging(self.hedging))
        if self.quarantine is not None:
            object.__setattr__(self, "quarantine",
                               resolve_quarantine(self.quarantine))
        if self.compute is not None:
            from repro_torch.core.compute import resolve_compute

            object.__setattr__(self, "compute",
                               resolve_compute(self.compute))
        if self.sm_fraction is not None \
                and not 0.0 < self.sm_fraction <= 1.0:
            raise ValueError(
                f"spec {self.name!r}: sm_fraction must be in (0, 1], "
                f"got {self.sm_fraction}")

        if self.breaker is not None and not isinstance(self.breaker,
                                                       BreakerConfig):
            raise TypeError(
                f"spec {self.name!r}: breaker must be a BreakerConfig, "
                f"got {type(self.breaker).__name__}")

        if self.scheduler is not None and self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; use one of {SCHEDULERS}")
        if self.dispatch is not None and self.dispatch not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch {self.dispatch!r}; "
                f"use one of {DISPATCH_POLICIES}")
        if self.transfer is not None and self.transfer not in TRANSFER_MODES:
            raise ValueError(
                f"unknown transfer mode {self.transfer!r}; "
                f"use one of {TRANSFER_MODES}")
        if self.autoscale is not None:
            from repro_torch.core.placement import resolve_autoscale

            # normalize dict kwargs to a frozen AutoscaleConfig so the
            # gateway's adopt-or-refuse check is a plain equality test
            object.__setattr__(self, "autoscale",
                               resolve_autoscale(self.autoscale))

    # ------------------------------------------------------------------
    # lowering
    # ------------------------------------------------------------------
    def base_profile(self) -> Optional[FunctionProfile]:
        if self.profile is None:
            return None
        if isinstance(self.profile, FunctionProfile):
            return self.profile
        return PROFILES[self.profile]

    def resolved_profile(self) -> FunctionProfile:
        """The modeled profile after byte/compute overrides, renamed to the
        spec's name (this is what the simulator lowering runs on)."""
        base = self.base_profile() or FunctionProfile(
            self.name, "custom", _DEFAULT_CTX_MB, _DEFAULT_RO_MB,
            _DEFAULT_W_MB, _DEFAULT_COMPUTE_MS,
        )
        over: dict = {"name": self.name}
        if self.read_only_bytes is not None:
            over["read_only_mb"] = self.read_only_bytes / MB
        if self.writable_bytes is not None:
            over["writable_mb"] = self.writable_bytes / MB
        if self.context_bytes is not None:
            over["context_mb"] = self.context_bytes / MB
        if self.compute_ms is not None:
            over["compute_ms"] = self.compute_ms
        return dataclasses.replace(base, **over)

    def to_sim_function(self):
        from repro_torch.core.simulator import SimFunction

        return SimFunction(self.resolved_profile(), name=self.name,
                           sm_fraction=self.sm_fraction)

    def to_gpu_function(self, db):
        """Real lowering: a reduced ``arch`` model with its weights in ``db``
        (lazy import keeps sim-only users off torch)."""
        from repro_torch.core.functions import make_model_function

        fn = make_model_function(
            db, self.name, arch=self.arch, batch=self.batch, seq=self.seq,
            profile=self.base_profile(), declared_ro_bytes=self.read_only_bytes,
            seed=self.seed,
        )
        over: dict = {}
        if self.writable_bytes is not None:
            over["writable_hint"] = self.writable_bytes
        if self.context_bytes is not None:
            over["context_bytes"] = self.context_bytes
        if self.compute_ms is not None:
            over["compute_s_hint"] = self.compute_ms / 1e3
        if self.sm_fraction is not None:
            over["sm_fraction"] = self.sm_fraction
        return dataclasses.replace(fn, **over) if over else fn

    # ------------------------------------------------------------------
    @classmethod
    def from_profile(cls, profile_name: str, *, name: Optional[str] = None,
                     **kw) -> "FunctionSpec":
        """Spec for one paper Table-2 profile (clones pass ``name=``)."""
        return cls(name=name or profile_name, profile=profile_name, **kw)
