"""Request/Data structures (paper §5.1, Fig 8).

The key insight SAGE builds on: *the data a GPU function needs is knowable
from request metadata before execution*. ``Data`` carries the database key,
size, and read-write attribute; the engine hands the request's data list to
the memory daemon ahead of execution so loading overlaps context creation.
"""
from __future__ import annotations

import enum
import itertools
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class DataType(enum.Enum):
    READ_ONLY = "ReadOnly"   # shareable across invocations (weights, tables)
    WRITABLE = "Writable"    # per-invocation (inputs, activations, outputs)


@dataclass
class Data:
    """Positional details of one external datum (Fig 8a)."""

    key: str                 # database key
    size: int                # bytes
    dtype: DataType = DataType.READ_ONLY
    device: str = "gpu"      # destination tier
    data_hptr: Any = None    # host-side payload (filled by the daemon)
    data_dptr: Any = None    # device-side handle (filled by the daemon)

    @property
    def read_only(self) -> bool:
        return self.dtype is DataType.READ_ONLY


_seq = itertools.count()


@dataclass
class Request:
    """One function invocation (Fig 8b).

    ``arrival_t`` uses ``None`` as the not-yet-arrived sentinel so a
    legitimate arrival at t=0.0 is preserved (the runtime stamps the clock
    only when the field is ``None``). ``deadline_s``/``priority`` carry
    per-request SLO metadata end-to-end; both drivers record them on the
    ``InvocationRecord`` (scheduling on them is a ROADMAP item).
    """

    function_name: str
    in_data: List[Data] = field(default_factory=list)
    out_data: List[Data] = field(default_factory=list)
    payload: Dict[str, Any] = field(default_factory=dict)  # small inline args
    uuid: str = field(default_factory=lambda: f"req-{next(_seq)}-{uuid.uuid4().hex[:6]}")
    arrival_t: Optional[float] = None
    deadline_s: Optional[float] = None   # SLO: seconds from arrival to finish
    priority: int = 0                    # higher = more urgent; orders loads
    #                                      and admission under scheduler="edf"
    # OOM-admission retry budget: how many backpressure re-attempts the
    # daemon may make before failing typed. None (default) keeps the flat
    # load_timeout_s behavior; 0 = fail-fast on the first OOM.
    max_retries: Optional[int] = None
    # stamped by the cluster dispatcher: the function's residency tier on
    # the chosen node at dispatch time (telemetry attribution only)
    dispatch_tier: Optional[str] = None
    # times this request was re-routed after dispatch (crash re-dispatch
    # or a work-steal off a saturated planned home — docs/planner.md);
    # shares the max_retries budget and lands on the record
    redispatches: int = 0
    # fault injection (docs/resilience.md): the gateway's seeded
    # per-arrival loader-fault draw landed True — the daemon poisons the
    # entries this request creates, so its db leg fails typed after
    # consuming bandwidth. Always False on the default path.
    fault_injected: bool = False
    # gray-failure injection (docs/resilience.md, "Gray failures"): extra
    # seconds the daemon stalls this request's db load leg (the gateway's
    # seeded LoaderJitter draw). Always 0.0 on the default path.
    jitter_s: float = 0.0
    # hedged redispatch (docs/resilience.md): a ``threading.Event`` the
    # gateway sets when this request's twin wins the race. The engine
    # checks it at its setup checkpoints and aborts with HedgedError —
    # cooperative, so every abort path still runs the byte-exact release
    # chain. None (default) is never checked.
    hedge_cancel: Any = None

    def loadable(self) -> List[Data]:
        """Data the daemon can prepare *before* execution (the knowability
        property): everything listed in in_data."""
        return list(self.in_data)
