"""Benchmark function profiles (paper Tables 1, 2, 4).

Memory columns are verbatim from Table 2 (MB). Compute times: resnet50 is
exactly Table 4 (24.3 ms); the others are chosen so that compute averages
~7.1% of the FixedGSL end-to-end duration (§3.2.1) with the calibrated
data-path bandwidths — they are modeling constants, recorded here once and
used by both the simulator and the real-runtime function builders.
"""
from __future__ import annotations

from dataclasses import dataclass

MB = 1024 * 1024


@dataclass(frozen=True)
class FunctionProfile:
    name: str
    task_type: str
    context_mb: float      # Table 2: context memory (414 for all)
    read_only_mb: float    # Table 2
    writable_mb: float     # Table 2
    compute_ms: float      # calibrated (resnet50 = Table 4)
    gpu_ctx_ms: float = 285.1  # Table 4 GPU context creation
    cpu_ctx_ms: float = 1.0

    @property
    def explicit_mb(self) -> float:
        return self.read_only_mb + self.writable_mb

    @property
    def read_only_ratio(self) -> float:
        return self.read_only_mb / self.explicit_mb if self.explicit_mb else 0.0


PROFILES = {
    p.name: p
    for p in [
        FunctionProfile("bert", "nlp", 414, 1282.5, 60.1, 28.0),
        FunctionProfile("deepspeech", "speech", 414, 24.8, 6.9, 12.0),
        FunctionProfile("inception3", "vision", 414, 91.1, 11.7, 18.0),
        FunctionProfile("nasnet", "vision", 414, 20.3, 11.8, 22.0),
        FunctionProfile("resnet50", "vision", 414, 97.7, 11.9, 24.3),
        FunctionProfile("seq2seq", "speech", 414, 6.1, 0.1, 6.0),
        FunctionProfile("vgg11", "vision", 414, 506.8, 38.0, 15.0),
        FunctionProfile("lbm", "sci", 414, 0.0, 330.0, 45.0),
        FunctionProfile("mrif", "sci", 414, 0.0, 22.0, 18.0),
        FunctionProfile("tpacf", "sci", 414, 0.1, 28.3, 30.0),
    ]
}

# Table 4 (resnet50) reference latencies, ms — used to validate the
# multistage benchmark against the paper.
TABLE4_RESNET50 = {
    "baseline": {"end_to_end": 399.4, "return": 0.1, "compute": 24.3,
                 "gpu_data": 21.7, "gpu_ctx": 285.1, "cpu_data": 67.2, "cpu_ctx": 1.0},
    "stage1": {"end_to_end": 28.9},
    "stage2": {"end_to_end": 49.7},
    "stage3": {"end_to_end": 309.5},
    "stage4": {"end_to_end": 309.5},
    "cold": {"end_to_end": 310.5},
}
