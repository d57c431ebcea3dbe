"""System policies: SAGE and the paper's baselines (§7.1).

* FixedGSL    — instance-fixed GPU serverless (Azure Functions / Alibaba FC
                style): 1 GiB-granularity memory slots, serial setup, no
                sharing.
* FixedGSL-F  — FixedGSL with flexible (exact-size) allocation: more
                concurrent invocations, *worse* data-path contention (the
                paper shows it underperforming FixedGSL).
* DGSF        — disaggregated GPUs for serverless (IPDPS'22): 4 pre-created
                GPU contexts per function, FCFS per-function queue, no
                read-only sharing.
* SAGE        — parallel setup + read-only & context sharing + multi-stage
                exit.
* SAGE-NR     — SAGE with read-only sharing disabled (ablation, Fig 16).
* SAGE-PS     — parallel setup only (Fig 15 ablation).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class SystemPolicy:
    name: str
    parallel_setup: bool = False       # overlap gpu_ctx with data loading
    share_read_only: bool = False      # dedupe RO data across invocations
    share_context: bool = False        # reuse live engine/executable
    pre_created_contexts: int = 0      # DGSF: contexts pinned at registration
    slot_granularity: int = 1 << 30    # FixedGSL: memory rounding (bytes); 0 = exact
    multi_stage_exit: bool = False     # SAGE ladder vs single keep-warm
    keep_warm_s: float = 30.0          # plain keep-warm TTL for baselines
    prewarmed_container: bool = True   # §7.1: all systems get pre-warmed containers
    executable_cache: bool = False     # BEYOND-PAPER (TPU): keep the compiled
    # executable in host RAM past exit stage 3, so a stage-3/4 warm hit pays
    # only program re-load (~10% of a compile), not a full context creation.
    # The paper's GPU contexts cannot be cached this way; XLA executables can.


FIXEDGSL = SystemPolicy("fixedgsl")
FIXEDGSL_F = SystemPolicy("fixedgsl-f", slot_granularity=0)
DGSF = SystemPolicy(
    "dgsf", pre_created_contexts=4, share_context=True, slot_granularity=0
)
SAGE = SystemPolicy(
    "sage", parallel_setup=True, share_read_only=True, share_context=True,
    slot_granularity=0, multi_stage_exit=True,
)
SAGE_NR = replace(SAGE, name="sage-nr", share_read_only=False)
SAGE_PS = SystemPolicy(
    "sage-ps", parallel_setup=True, slot_granularity=0
)
# beyond-paper TPU variant: executable caching across exit stage 3
SAGE_CACHE = replace(SAGE, name="sage-cache", executable_cache=True)

SYSTEMS = {p.name: p for p in (FIXEDGSL, FIXEDGSL_F, DGSF, SAGE, SAGE_NR,
                               SAGE_PS, SAGE_CACHE)}


def get_system(name: str) -> SystemPolicy:
    if name not in SYSTEMS:
        raise KeyError(f"unknown system {name!r}; known: {sorted(SYSTEMS)}")
    return SYSTEMS[name]
