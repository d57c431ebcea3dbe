"""The unified serving API: FunctionSpec + Workload + Gateway.

This is the layer every benchmark, example, and test drives load through;
``core.runtime``/``core.simulator`` remain importable as the mechanism
layer underneath. See docs/api.md.
"""
from repro_torch.api.gateway import DEFAULT_INPUT_BYTES, Gateway, Invocation  # noqa: F401
from repro_torch.api.spec import FunctionSpec  # noqa: F401
from repro_torch.api.workload import (  # noqa: F401
    Arrival, BurstWorkload, ChaosWorkload, DiurnalWorkload,
    FlashCrowdWorkload, MAFWorkload, MixWorkload, MultiRegionWorkload,
    PoissonWorkload, TraceWorkload, Workload, maf_like_trace,
    poisson_arrivals,
)
