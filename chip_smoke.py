"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each:

1. card          the card's name and power limit (nvidia-smi), torch and
                 CUDA versions, its total memory (checked against
                 analysis/roofline.py's HBM_BYTES);
2. build         builds (or loads) the hand-written kernels from
                 src/repro_torch/kernels/csrc with nvcc, all sources at once;
3. kernels       every kernel against its plain PyTorch version on the card
                 at the reference sweep, the split-K edges (K2) and the
                 serving shapes (TF32 off), then its device time at the
                 full-width serving shape beside its plain version, one
                 PyTorch library call where one computes the same function
                 (the yardstick only) and its bound: flash attention (K1;
                 its backward kernel too, at the sweep in fp32 and bf16 and
                 at the training shape, against the plain backward, bf16
                 also against the plain version of its own roundings and
                 bit for bit against a second call, and at the training
                 shape each of the bf16 route's three kernels timed alone),
                 decode attention (K2, with its number of splits and the
                 host's cost of one call), SSD scan (K3: bf16 initial-state
                 and strided-view cases too, and at full width each of the
                 bf16 route's four kernels timed alone beside the whole) and
                 K3's backward (the SSD sweep, the edges and the reduced
                 shape in fp32 and bf16, with and without an initial state
                 and a final state's gradient, strided views, bit for bit
                 against a second call, bf16 also against the plain
                 version of its own roundings; timed at mamba2-780m's
                 training shape with each of its launches alone);
4. reduced       SageRuntime serves the reduced qwen2.5-3b cold -> warm -> warm;
5. full          SageRuntime serves the full-width qwen2.5-3b (36 layers,
                 d_model 2048, bf16, random weights from a seed), batch
                 4 x 1024 tokens: cold, warm, then a burst of 4 concurrent;
                 the cold request's compute within COLD_MAX_OVER_WARM x the
                 warm one's (its context carried the shape-only work); the
                 warm request captures the context's CUDA graph and the
                 burst replays it, its K1 and K3 calls counted from the
                 kernels in a profiler trace of the burst; every answer
                 against the direct forward;
6. mamba_reduced the same as 4 for the reduced mamba2-780m;
7. mamba_full    the same as 5 for the full-width mamba2-780m (48 layers,
                 d_model 1536, SSD heads 48 x 64, state 128, chunk 128, bf16);
8. gateway       the Gateway API on the card: examples/torch_quickstart.py
                 (register the reduced qwen2.5-3b, a cold and a warm invoke;
                 the served output against the direct forward, device
                 memory back to its base after shutdown), runtime<->sim
                 parity over one trace, a DataLoadError that resolves
                 within its load timeout, and a 2-node ClusterRuntime;
9. decode        the serving steps at full width: prefill 4 x 1024 then 32
                 greedy decode steps, for qwen2.5-3b (K1 in the prefill, K2
                 in every step), mamba2-780m (K3 in the prefill, the plain
                 recurrent step after) and olmoe-1b-7b (K1 and the MoE FFN;
                 drop-free, see DROP_FREE_CAPACITY; plus a profiled prefill
                 at the served capacity that splits the MoE FFN's time by
                 einsum); every logit checked
                 against the full forward of the same tokens, and the same
                 check in fp32 at the reduced configs; a decode step past
                 the cache's length (its write dropped) against the CPU's
                 logits;
10. moe_full     the same as 5 for the full-width olmoe-1b-7b (16 layers,
                 d_model 2048, 16 MHA heads of 128, 64 experts top-8 of
                 d_ff 1024, bf16; 6.9 B parameters);
11. whisper_decode  whisper-small at full width (12 + 12 layers, d_model
                 768, bf16) through the serving steps: 30 s of audio as
                 1500 encoder frames from seed 0, a 4 x 128 decoder prompt,
                 32 greedy steps; K1 runs the encoder, the decoder's causal
                 self attention and its cross attention (Sq 128, Sk 1500),
                 K2 the self and the cross decode; held against the full
                 forward as in 9;
12. zoo_reduced  the reduced olmoe, llama4, jamba and qwen2-vl served through
                 SageRuntime in fp32 (K1, and K3 for jamba) against the CPU
                 forward, and the reduced whisper's prefill and decode steps
                 on the card against the CPU's;
13. train        qwen2.5-3b trained at full width (36 layers, d_model 2048,
                 bf16 params and compute, fp32 AdamW state, remat
                 nothing_saveable, random weights from seed 0) on 4 x 1024
                 batches of the port's TokenPipeline: 10 steps of
                 make_train_step (lr 1e-3, warm-up 1, total 10); finite and
                 falling losses, K1 forward 72 and backward 36 launches a
                 step; step time, tokens/s, model-FLOP utilisation, peak
                 memory and a profiled step's device time by part. Then
                 the checks: every leaf's gradient with the K1 route
                 against use_kernel=False at depth 2 (fp32 and bf16), the
                 reduced train_loop with a checkpoint every 3 steps, a
                 failure at step 4 and a resume (against the uninterrupted
                 run and the CPU's), the compressed DP step on a
                 one-rank NCCL group, and the reduced jamba (K1 and K3,
                 forward and backward, and MoE) through train_loop against
                 the CPU's losses;
14. train_mamba  mamba2-780m trained at full width (48 layers, d_model
                 1536, SSD heads 48 x 64, state 128, chunk 128), the setup
                 of 13: K3 forward 96 (48 + 48 recomputed) and backward 48
                 launches a step, K1 none; K3 backward's share of the
                 profiled step's device time; then every leaf's gradient with
                 the K3 route against use_kernel=False at depth 2 (fp32
                 and bf16);
15. cells        the production cells' builders (launch/cells.py) on a 1 x 1
                 (data, model) DeviceMesh over a one-rank NCCL group, the
                 inputs DTensors placed by distributed/rules.py:
                 qwen2.5-3b's train cell (3 steps), prefill cell (4 x
                 1024) and decode cell (4 steps), mamba2-780m's train
                 cell (3 steps) and olmoe-1b-7b's prefill and decode cells
                 (the MoE FFN through distributed/local.py's moe_ffn, one
                 call a layer) at full width, and the reduced jamba's
                 train cell (fp32, 2 x 16, 3 steps: K1, K3 and both
                 backwards beside the MoE FFN), each against the same
                 model's single-device steps on the same seeded weights
                 (losses, grad norms, logits; the prefills' logits and the
                 reduced jamba's losses bit for bit), with each step's
                 wall time beside the single-device step's; all five
                 kernels launch there. Then the dry-run of qwen2.5-3b x
                 train_4k on the 16 x 16 production mesh (256 fake ranks,
                 no device; a niced subprocess started after the build):
                 its per-rank bytes, FLOPs, collective bytes and roofline
                 terms;
16. serve        launch/serve.py's serve() on the card for FixedGSL and SAGE
                 (the reduced qwen2.5-3b, 16 Poisson requests at rate 8):
                 every request served, K1 launched, no declared or real
                 device bytes left after shutdown; mean and p99 e2e, warm
                 share and shared hits of each;
17. serve_workload  examples/torch_serve_workload.py's drive() for FixedGSL
                 and SAGE, 12 requests at rate 12 over the reduced
                 qwen2.5-3b, qwen3-8b and mamba2-780m (K1 and K3);
18. exit_ladder  the multi-stage exit ladder on real device memory: the
                 full-width qwen2.5-3b through SageRuntime, one cold request,
                 then at each of stages 1-4 the declared and the real memory
                 and one hit (its warm stage, e2e, gpu_ctx, gpu_data): the
                 weights leave the card at stage 2, the context at stage 3,
                 and each hit skips what Table 4 says it skips;
19. control_plane  the cluster control plane on real memory: (a) a 2-node
                 ClusterRuntime (locality, eviction) serving the full-width
                 qwen2.5-3b, node A crashed while a request's forward (an
                 eager one, of another shape) is in flight, a request evicted to B, A restored, B drained, a
                 cold request on A: typed outcomes, logits against the
                 direct forward, >= 90 % of the weights' real bytes freed by
                 the crash and by the drain, and the time the crash took to
                 free them; (b) the JAX package's quick chaos scenario,
                 hardened, on a 4-node gateway over the reduced qwen2.5-3b
                 (K1) and mamba2-780m (K3): 3 crashes, typed failures, dead
                 nodes' books at zero; (c) hedging around a slowed node and
                 a burst of 4 batched by the shared compute plane (K1
                 launches 4 x a forward's); memory back at its base after
                 each part;
20. analysis     analysis.op_analysis on qwen2.5-3b: the kernels' reports
                 against use_kernel=False at depth 2, then the full-width
                 prefill, decode step and train step with their roofline
                 terms beside their device time;
21. cold_setup   the full-width qwen2.5-3b served cold 3 times under SAGE
                 and 3 under FixedGSL (each cold request on a new
                 SageRuntime, each followed by a warm one), each policy in
                 a fresh process (``python3 chip_smoke.py --cold-runs
                 SYSTEM``): every request's gpu_ctx, gpu_data, compute and
                 e2e, their medians, per cold run the build's time, the
                 allocator's counters, the weights' copy and the build's
                 and the compute's host account (wall and thread CPU ms,
                 new device segments, the forward's issue and its
                 unembedding span), no collection forced before any
                 request, the page-locked host bytes, SAGE / FixedGSL
                 (all colds, the first, the later ones); every cold
                 compute within
                 COLD_MAX_OVER_WARM x the warm median, the first cold's
                 ratio under 0.9, the later ones' at most 1.10;
22. rank_bodies  the 16 rank bodies of distributed/local.py's attention
                 split by query rows (one full-width phi4-mini layer: 24
                 heads do not divide by 16) and of its Mamba2 block split
                 by SSD heads (one full-width mamba2-780m block), one after
                 another on the card, against the whole layer's kernels
                 (output and every gradient);
23. the {"kernels": [...]} line, then the contract's last line.

(Phases 16-19 and 21 run after 8, phase 22 after 15 and phase 20 after
22.)

Each served path sets every kernel's launch count to 0 just before it runs
and reads the counts just after. The GPU context's build runs a warm-up
forward (core/functions.py): its launches, counted in each kernel's
count too, are read apart (``ctx_counts``) and every check holds the
requests' forwards and the context builds to their own numbers. A forward
replayed from a context's CUDA graph counts the kernel calls captured
into the graph. Any
failed check exits non-zero before the last line. The script never carries on without a card: it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; nothing was run")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.analysis.op_analysis import analyze_step  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BYTES, PEAK_FLOPS, attention_bound_ms, attention_bwd_bound_ms, decode_bound_ms, model_flops,
    roofline_from_report, ssd_bound_ms, ssd_bwd_bound_ms, train_step_flops,
)
from repro_torch.api import (  # noqa: E402
    Arrival, ChaosWorkload, FunctionSpec, Gateway, PoissonWorkload, TraceWorkload,
)
from repro_torch.configs import ARCHS, ShapeConfig  # noqa: E402
from repro_torch.core import ClusterRuntime, SageRuntime  # noqa: E402
from repro_torch.core.faults import (  # noqa: E402
    BreakerConfig, DbFlap, FaultPlan, LinkDegradation, LoaderFault, NodeCrash, SheddingConfig,
    SlowNode,
)
from repro_torch.core import functions as F  # noqa: E402
from repro_torch.core.functions import (  # noqa: E402
    _model_function, make_model_function, make_request, warmup_launches,
)
from repro_torch.core.profiles import MB  # noqa: E402
from repro_torch.core.telemetry import STAGES, classify_error  # noqa: E402
from repro_torch.data.database import Database  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as ssdb  # noqa: E402
from repro_torch.distributed import local as dlocal  # noqa: E402
from repro_torch.launch.cells import (  # noqa: E402
    CellTuning, _build_decode, _build_prefill, _build_train, get_tuning, place_batch,
)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill  # noqa: E402
from repro_torch.serving import greedy_sample, make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig, init_dp_state, init_train_state, make_dp_compressed_step, make_train_step,
)
from repro_torch.training.optimizer import adamw_update  # noqa: E402
from repro_torch.training.steps import _value_and_grad  # noqa: E402

KERNELS = {fa.NAME: fa, fab.NAME: fab, dec.NAME: dec, ssd.NAME: ssd, ssdb.NAME: ssdb}
# the CUDA functions of those kernels, as the profiler names them
K1_FWD_NAMES = ("flash_fwd_kernel", "flash_fwd_bf16_kernel")
K1_BWD_NAMES = ("flash_bwd_dot_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                *fab.PARTS)
K3_FWD_NAMES = ("ssd_kernel", "ssd_chunk_cb_kernel", "ssd_chunk_state_kernel",
                "ssd_chunk_scan_kernel")
K3_BWD_NAMES = ssdb.KERNELS
K3_PASS_NAME = "ssd_state_pass_kernel"  # launched by K3's forward and its backward
# K3's forward kernels that its bf16 backward launches too, once a call each
K3_SHARED_NAMES = ("ssd_chunk_cb_kernel", "ssd_chunk_state_kernel")
PORT_KERNEL_NAMES = (*K1_FWD_NAMES, *K1_BWD_NAMES, "decode_split_kernel",
                     "decode_combine_kernel", *K3_FWD_NAMES, K3_PASS_NAME, *K3_BWD_NAMES)
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py (attention)
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}  # tests/test_kernels.py (SSD)
# K3's bf16 backward against ref.ssd_scan_bwd_bf16 (its own roundings; a bf16
# output may round the other way): tests/test_torch_cuda.py's bound
SSD_BWD_SAME_ROUNDING_TOL = 1e-2
REF_SHAPES = [  # tests/test_kernels.py sweep: B, Sq, Sk, Hq, Hkv, Dh, causal
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 2, 32, True),
    (2, 96, 96, 4, 4, 64, True),
    (1, 128, 128, 4, 1, 128, False),
    (1, 64, 192, 2, 2, 64, False),
    (1, 512, 512, 8, 8, 64, True),
    # ragged 64-key tiles and the GQA packing of the tensor-core path:
    # G = 1, 3, 8, 16, causal Sq = Sk = 200 and non-causal Sk = 333
    (2, 200, 200, 2, 2, 64, True),
    (1, 200, 200, 6, 2, 128, True),
    (2, 200, 200, 16, 2, 128, True),
    (1, 200, 200, 16, 1, 32, True),
    (1, 200, 333, 2, 2, 64, False),
    (1, 200, 333, 6, 2, 128, False),
    (2, 200, 333, 16, 2, 128, False),
    (1, 200, 333, 16, 1, 16, False),
]
REDUCED_SHAPE = (1, 16, 16, 4, 2, 16, True)        # qwen2.5-3b reduced, fp32
FULL_SHAPE = (4, 1024, 1024, 16, 2, 128, True)     # qwen2.5-3b full, bf16
# the other served full-width shapes, all MHA: olmoe's prefill; whisper's
# encoder (1500 frames: a ragged last key tile), decoder prompt and cross
# attention
ZOO_SHAPES = [
    (4, 1024, 1024, 16, 16, 128, True),
    (4, 1500, 1500, 12, 12, 64, False),
    (4, 128, 128, 12, 12, 64, True),
    (4, 128, 1500, 12, 12, 64, False),
]
FULL_BATCH, FULL_SEQ = 4, 1024
DECODE_STEPS = 32
DECODE_REF_SHAPES = [  # tests/test_kernels.py decode sweep: B, L, Hq, Hkv, Dh
    (2, 256, 4, 2, 64),
    (3, 300, 8, 8, 32),
    (1, 1024, 16, 2, 128),
    (4, 128, 8, 1, 64),
]
# split-K edges: lengths 1, 64k, 64k + 1 and L (B, L, Hq, Hkv, Dh, lengths); on
# 132 SMs the splits are 5 of one tile, 2 of three tiles and 17 of one tile
DECODE_EDGE_CASES = [
    ((4, 300, 8, 2, 64), [1, 128, 129, 300]),
    ((16, 300, 16, 8, 64), [1, 64, 65, 128, 129, 192, 193, 256, 257, 300] + [300] * 6),
    ((4, 1056, 16, 2, 128), [64, 65, 1025, 1056]),
]
DECODE_REDUCED_SHAPE = (2, 28, 4, 2, 16)           # reduced decode check, fp32
DECODE_FULL_SHAPE = (4, 1056, 16, 2, 128)          # qwen2.5-3b decode, bf16
DECODE_FULL_LENGTHS = [1025, 1035, 1046, 1056]
DECODE_ZOO_CASES = [  # olmoe self, whisper self and whisper cross (every length L)
    ((4, 1056, 16, 16, 128), DECODE_FULL_LENGTHS),
    ((4, 160, 12, 12, 64), [129, 139, 150, 160]),
    ((4, 1500, 12, 12, 64), [1500] * 4),
]
WHISPER_PROMPT, WHISPER_FRAMES = 128, 1500  # decoder tokens; 30 s of audio
# olmoe's prefill routes 1024 tokens with C = 160 slots per expert and drops
# the overflow; its decode step routes B = 4 tokens with C = max(K, ...) = 8
# >= B and drops none (llama4's and jamba's can: C < B there). So
# a decode held against the full forward runs a drop-free copy of the config
# (tests/test_models.py does the same); the served phases keep 1.25
DROP_FREE_CAPACITY = 8.0
SSD_REF_SHAPES = [  # tests/test_kernels.py SSD sweep: B, S, H, P, N, chunk
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (2, 100, 3, 16, 32, 32),
    (1, 256, 8, 64, 128, 64),
]
# the bf16 route's edges: S < chunk, a ragged last chunk of 72 rows, jamba's
# P = 128 with S < chunk, a chunk (10) that is not a multiple of 16
SSD_EDGE_SHAPES = [
    (2, 10, 2, 16, 16, 16),
    (1, 200, 4, 64, 128, 128),
    (2, 40, 2, 128, 128, 64),
    (2, 45, 3, 32, 48, 10),
]
SSD_REDUCED_SHAPE = (1, 16, 8, 16, 16, 16)         # mamba2-780m reduced, fp32
SSD_FULL_SHAPE = (4, 1024, 48, 64, 128, 128)       # mamba2-780m prefill, bf16
# decode logits against the full forward of the same tokens, bf16 at full
# width: |err| <= DECODE_TOL_BF16 * max|logit| of that position. Measured on
# an H100 (PERF.md): at most 0.013 (qwen2.5-3b) and 0.049
# (mamba2-780m) of it; the steps' small-batch matmuls round to bf16 at other
# places than the full forward's, over 36-48 layers. fp32 at the reduced
# configs: tests/test_models.py's 2e-3 / 1e-3.
DECODE_TOL_BF16 = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    with F._ctx_lock:
        for counter in (F.context_launches, F.context_builds, F.eager_forwards,
                        F.graph_captures, F.graph_replays):
            counter.clear()


def graph_counts(fn_name: str) -> tuple:
    """(eager forwards, captures, replays) of ``fn_name`` since
    ``reset_counts``."""
    return F.eager_forwards[fn_name], F.graph_captures[fn_name], F.graph_replays[fn_name]


def traced_calls(fn):
    """Run ``fn`` under torch.profiler; returns its result and the K1 and K3
    forward calls whose kernels ran on the card meanwhile, by the kernels'
    names in the trace, a CUDA graph's nodes included: K1's forward kernel,
    and the kernel that ends each K3 call (fp32 ``ssd_kernel``, bf16
    ``ssd_chunk_scan_kernel``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    calls = dict.fromkeys(KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if any(tag in e.key for tag in K1_FWD_NAMES):
                calls[fa.NAME] += e.count
            elif "ssd_kernel" in e.key or "ssd_chunk_scan_kernel" in e.key:
                calls[ssd.NAME] += e.count
    return out, calls


def counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def ctx_counts() -> dict:
    """The launches that context builds' warm-up forwards made since
    ``reset_counts`` (``counts`` holds them too): they are counted apart
    from the requests' forwards in every check."""
    return {name: F.context_launches.get(name, 0) for name in KERNELS}


def builds(fn_name: str) -> int:
    """Context builds of ``fn_name`` since ``reset_counts``."""
    return F.context_builds.get(fn_name, 0)


def minus(a: dict, b: dict) -> dict:
    return {n: a[n] - b[n] for n in KERNELS}


def warmups(cfg, n: int) -> dict:
    """The launches of ``n`` context builds of ``cfg`` (one warm-up forward
    of one period each, ``functions.warmup_launches``)."""
    one = warmup_launches(cfg)
    return {name: n * one.get(name, 0) for name in KERNELS}


def inputs(shape, dtype, seed=0):
    B, Sq, Sk, Hq, Hkv, Dh, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
            for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh))]


def decode_inputs(shape, dtype, lengths=None, seed=0):
    B, L, Hq, Hkv, Dh = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
               for s in ((B, 1, Hq, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh)))
    if lengths is None:
        lengths = rng.integers(1, L + 1, (B,))
    return q, k, v, torch.tensor(np.asarray(lengths), dtype=torch.int32, device="cuda")


def ssd_inputs(shape, dtype, seed=0):
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)

    def t(a, d=dtype):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to("cuda", d)

    x = t(rng.standard_normal((B, S, H, P)))
    dt = t(np.log1p(np.exp(rng.standard_normal((B, S, H)))), torch.float32)  # softplus
    A = t(-np.exp(rng.standard_normal(H) * 0.3), torch.float32)
    return x, dt, A, t(rng.standard_normal((B, S, N))), t(rng.standard_normal((B, S, N)))


def compare(outs, plains, tol):
    """The tests' criterion, |out - plain| <= tol + tol * |plain|, and
    finite outputs; returns (max |err|, ok)."""
    err, ok = 0.0, True
    for out, plain in zip(outs, plains):
        d = (out.float() - plain.float()).abs()
        err = max(err, d.max().item())
        ok = ok and bool((d <= tol + tol * plain.float().abs()).all().item())
        ok = ok and bool(torch.isfinite(out.float()).all().item())
    return err, ok


def time_ms(fn, reps=5, inner=10, warmup=3) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, by CUDA events, after ``warmup`` calls. Before each rep the card
    sleeps (``torch.cuda._sleep``) for longer than the host needs to queue
    the calls, so the events time the card's work, not the host's launch
    overhead (``enqueue_ms`` measures that)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t0) / warmup  # host and device
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2 * inner * per_call_s + 1e-3)))  # cycles, <= 2 GHz
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def enqueue_ms(fn, calls=20) -> float:
    """Host time per call to queue ``fn`` (wrapper, checks, allocation,
    launch) while the card sleeps, so the queue never blocks."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * 0.05))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return host_ms


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi.splitlines()[0], flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "tf32": False, "total_memory": total,
          "hbm_bytes_constant": HBM_BYTES})
    # the sharding rules' ZeRO-decode threshold is 60 % of this constant
    check(total == HBM_BYTES, f"roofline.HBM_BYTES {HBM_BYTES} != the card's {total}")
    return smi.splitlines()[0]


def phase_build():
    t0 = time.monotonic()
    _build.build(list(KERNELS))
    for mod in KERNELS.values():
        mod.load()
    ptxas = {name: [ln.strip() for ln in _build.ptxas_log.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln] for name in KERNELS}
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "nvcc_seconds": _build.build_seconds, "flags": _build.NVCC_FLAGS,
          "ptxas": ptxas})


def phase_kernels():
    results = []
    cases = [(s, d) for s in REF_SHAPES for d in (torch.float32, torch.bfloat16)]
    cases += [(REDUCED_SHAPE, torch.float32), (REDUCED_SHAPE, torch.bfloat16),
              (FULL_SHAPE, torch.bfloat16)]
    cases += [(s, d) for s in ZOO_SHAPES for d in (torch.float32, torch.bfloat16)]
    worst = 0.0
    for shape, dtype in cases:
        q, k, v = inputs(shape, dtype)
        out = ops.flash_attention(q, k, v, causal=shape[-1], use_kernel=True)
        torch.cuda.synchronize()
        plain = ops.flash_attention(q, k, v, causal=shape[-1], use_kernel=False)
        err, ok = compare([out], [plain], TOL[dtype])
        results.append({"shape": list(shape), "dtype": str(dtype).split(".")[1],
                        "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
        check(ok, f"flash_attention kernel disagrees at {shape} {dtype}: {err}")
        worst = max(worst, err)
    emit({"phase": "kernels", "kernel": fa.NAME, "cases": results})

    q, k, v = inputs(FULL_SHAPE, torch.bfloat16)
    G = FULL_SHAPE[3] // FULL_SHAPE[4]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
    plain = ops.flash_attention(q, k, v, causal=True, use_kernel=False)
    lib_err = (lib.float() - plain.float()).abs().max().item()
    kern = lambda: ops.flash_attention(q, k, v, causal=True, use_kernel=True)  # noqa: E731
    timing = {
        "plain_ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                        use_kernel=False), reps=3, inner=3),
        "ms": time_ms(kern),
        "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
    }
    timing["ms_again"] = time_ms(kern)  # spread: same call, same inputs
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(FULL_SHAPE, torch.bfloat16)
    emit({"phase": "kernel_timing", "kernel": fa.NAME, "shape": list(FULL_SHAPE),
          "dtype": "bfloat16", **timing, "bound_ms": bound_ms, "bound_by": bound_by,
          "flops": flops, "bytes": nbytes, "library": "scaled_dot_product_attention, "
          "GQA expanded outside the timed call", "library_max_abs_err": lib_err,
          "tflops": flops / timing["ms"] / 1e9})
    return {"max_abs_err": worst, **timing, "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": list(FULL_SHAPE)}


def phase_kernels_decode():
    results, worst = [], 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(s, d, None) for s in DECODE_REF_SHAPES for d in (torch.float32, torch.bfloat16)]
    cases += [(s, d, lens) for s, lens in DECODE_EDGE_CASES
              for d in (torch.float32, torch.bfloat16)]
    cases += [(DECODE_REDUCED_SHAPE, torch.float32, None),
              (DECODE_FULL_SHAPE, torch.bfloat16, DECODE_FULL_LENGTHS)]
    cases += [(s, d, lens) for s, lens in DECODE_ZOO_CASES
              for d in (torch.float32, torch.bfloat16)]
    for shape, dtype, lengths in cases:
        q, k, v, lens = decode_inputs(shape, dtype, lengths)
        n_split = dec.num_splits(shape[0], shape[3], shape[1], sms)
        out = ops.decode_attention(q, k, v, lens, use_kernel=True)
        torch.cuda.synchronize()
        plain = ops.decode_attention(q, k, v, lens, use_kernel=False)
        err, ok = compare([out], [plain], TOL[dtype])
        results.append({"shape": list(shape), "dtype": str(dtype).split(".")[1],
                        "lengths": lens.tolist(), "n_split": n_split, "max_abs_err": err,
                        "tol": TOL[dtype], "ok": ok})
        check(ok, f"decode_attention kernel disagrees at {shape} {dtype}: {err}")
        worst = max(worst, err)
    emit({"phase": "kernels", "kernel": dec.NAME, "cases": results})

    q, k, v, lens = decode_inputs(DECODE_FULL_SHAPE, torch.bfloat16, DECODE_FULL_LENGTHS)
    B, L, Hq, Hkv, Dh = DECODE_FULL_SHAPE
    G = Hq // Hkv
    qt = q.transpose(1, 2)                                    # (B, Hq, 1, Dh)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)        # (B, Hq, L, Dh)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kt, vt, attn_mask=mask).transpose(1, 2)
    plain = ops.decode_attention(q, k, v, lens, use_kernel=False)
    lib_err = (lib.float() - plain.float()).abs().max().item()
    kern = lambda: ops.decode_attention(q, k, v, lens, use_kernel=True)  # noqa: E731
    timing = {
        "plain_ms": time_ms(lambda: ops.decode_attention(q, k, v, lens, use_kernel=False)),
        "ms": time_ms(kern),
        "library_ms": time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask)),
    }
    timing["ms_again"] = time_ms(kern)
    timing["enqueue_ms"] = enqueue_ms(kern)
    bound_ms, bound_by, flops, nbytes = decode_bound_ms(
        DECODE_FULL_SHAPE, DECODE_FULL_LENGTHS, torch.bfloat16)
    n_split = dec.num_splits(B, Hkv, L, sms)
    emit({"phase": "kernel_timing", "kernel": dec.NAME, "shape": list(DECODE_FULL_SHAPE),
          "lengths": DECODE_FULL_LENGTHS, "n_split": n_split, "ctas": n_split * B * Hkv,
          "dtype": "bfloat16", **timing,
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
          "library": "scaled_dot_product_attention with a boolean length mask, GQA "
          "expanded outside the timed call", "library_max_abs_err": lib_err,
          "gbytes_per_s": nbytes / timing["ms"] / 1e6})
    return {"max_abs_err": worst, **timing, "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": list(DECODE_FULL_SHAPE)}


def phase_kernels_ssd():
    results, worst = [], 0.0
    cases = [(s, d) for s in SSD_REF_SHAPES + SSD_EDGE_SHAPES
             for d in (torch.float32, torch.bfloat16)]
    cases += [(SSD_REDUCED_SHAPE, torch.float32), (SSD_REDUCED_SHAPE, torch.bfloat16),
              (SSD_FULL_SHAPE, torch.bfloat16)]
    for shape, dtype in cases:
        args = ssd_inputs(shape, dtype)
        out = ops.ssd_scan(*args, chunk=shape[-1], use_kernel=True)
        torch.cuda.synchronize()
        plain = ops.ssd_scan(*args, chunk=shape[-1], use_kernel=False)
        err, ok = compare(out, plain, SSD_TOL[dtype])
        results.append({"shape": list(shape), "dtype": str(dtype).split(".")[1],
                        "max_abs_err": err, "tol": SSD_TOL[dtype], "ok": ok})
        check(ok, f"ssd_scan kernel disagrees at {shape} {dtype}: {err}")
        worst = max(worst, err)
    # a scan continued from an initial state, on x/B/C as slices of one fused
    # tensor (the Mamba2 block's layout), and both at once
    B, S, H, P, N, chunk = SSD_REF_SHAPES[2]
    s0 = torch.randn((B, H, P, N), device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        args = ssd_inputs(SSD_REF_SHAPES[2], dtype)
        x, dt, A, Bm, Cm = args
        fused = torch.cat([x.reshape(B, S, H * P), Bm, Cm], dim=-1)
        xv, Bv, Cv = torch.split(fused, [H * P, N, N], dim=-1)
        views = (xv.reshape(B, S, H, P), dt, A, Bv, Cv)
        for init, strided in ((s0, False), (None, True), (s0, True)):
            out = ops.ssd_scan(*(views if strided else args), chunk=chunk, initial_state=init,
                               use_kernel=True)
            plain = ops.ssd_scan(*args, chunk=chunk, initial_state=init, use_kernel=False)
            err, ok = compare(out, plain, SSD_TOL[dtype])
            results.append({"shape": list(SSD_REF_SHAPES[2]), "dtype": str(dtype).split(".")[1],
                            "initial_state": init is not None, "strided_views": strided,
                            "max_abs_err": err, "tol": SSD_TOL[dtype], "ok": ok})
            check(ok, f"ssd_scan kernel disagrees (initial state {init is not None}, "
                  f"views {strided}, {dtype}): {err}")
            worst = max(worst, err)
    emit({"phase": "kernels", "kernel": ssd.NAME, "cases": results})

    args = ssd_inputs(SSD_FULL_SHAPE, torch.bfloat16)
    chunk = SSD_FULL_SHAPE[-1]
    kern = lambda: ops.ssd_scan(*args, chunk=chunk, use_kernel=True)  # noqa: E731
    timing = {
        "plain_ms": time_ms(lambda: ops.ssd_scan(*args, chunk=chunk, use_kernel=False),
                            reps=3, inner=3),
        "ms": time_ms(kern, inner=5),
        "library_ms": None,
    }
    timing["ms_again"] = time_ms(kern, inner=5)
    parts, scratch_bytes = ssd_part_times(args, chunk)
    bound_ms, bound_by, flops, nbytes = ssd_bound_ms(SSD_FULL_SHAPE, torch.bfloat16)
    emit({"phase": "kernel_timing", "kernel": ssd.NAME, "shape": list(SSD_FULL_SHAPE),
          "dtype": "bfloat16", **timing, "parts_ms": parts, "scratch_bytes": scratch_bytes,
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
          "library": "none: no single PyTorch call computes the chunked SSD scan",
          "tflops": flops / timing["ms"] / 1e9})
    return {"max_abs_err": worst, **timing, "parts_ms": parts, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": list(SSD_FULL_SHAPE)}


def ssd_part_times(args, chunk):
    """Device time of each of the bf16 route's four kernels alone at the
    shape of ``args``, on one call's scratch (after a whole scan filled
    it), and of the four launched together without the wrapper; returns
    (times by kernel, the scratch's bytes)."""
    x, dt, A, Bm, Cm = args
    strides = ssd.check_inputs(*args, None)
    dims = (*x.shape, Bm.shape[-1], chunk)
    cb, states, decay = ssd.bf16_scratch(*dims, x.device)
    bufs = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, y=torch.empty_like(x), cb=cb, states=states,
                decay=decay, fs=torch.empty((dims[0], *dims[2:5]), device=x.device))
    every = sum(ssd.STAGES.values())
    ssd.launch_bf16(every, dims, strides, **bufs)
    parts = {name: time_ms(lambda bit=bit: ssd.launch_bf16(bit, dims, strides, **bufs))
             for name, bit in ssd.STAGES.items()}
    parts["all_four"] = time_ms(lambda: ssd.launch_bf16(every, dims, strides, **bufs))
    return parts, sum(t.numel() * t.element_size() for t in (cb, states, decay))


def ssd_bwd_args(shape, dtype, with_init, with_dfinal, seed=0):
    """The forward's inputs (``ssd_inputs``), an initial state or None, dy
    in x's dtype and a nonzero final state's gradient or None."""
    B, S, H, P, N, _ = shape
    x, dt, A, Bm, Cm = ssd_inputs(shape, dtype, seed)
    rng = np.random.default_rng(seed + 1)

    def f32(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()

    s0 = f32(B, H, P, N) if with_init else None
    dy = f32(B, S, H, P).to(dtype)
    return x, dt, A, Bm, Cm, s0, dy, f32(B, H, P, N) if with_dfinal else None


def ssd_bwd_case(args, chunk, dtype, **tags):
    """K3's backward kernel against ref.ssd_scan_bwd on ``args``, bf16 also
    against ref.ssd_scan_bwd_bf16 (its own roundings), and against a second
    call, bit for bit; returns (the case's record, its worst |err| against
    ref.ssd_scan_bwd)."""
    got = ssdb.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    want = ref.ssd_scan_bwd(*args, chunk=chunk)
    again = ssdb.ssd_scan_bwd(*args, chunk=chunk)
    errs, rels, ok = [], [], True
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        m = w.float().abs().max().item()
        errs.append(err)
        rels.append(err / max(m, 1e-30))
        ok = ok and err <= SSD_TOL[dtype] * m and bool(torch.isfinite(g.float()).all().item())
    same = {}
    if dtype == torch.bfloat16:
        for g, w in zip(got, ref.ssd_scan_bwd_bf16(*args, chunk=chunk)):
            err = (g.float() - w.float()).abs().max().item()
            m = w.float().abs().max().item()
            same.setdefault("rel_err_vs_own_roundings", []).append(err / max(m, 1e-30))
            ok = ok and err <= SSD_BWD_SAME_ROUNDING_TOL * m
    bits = all(torch.equal(a, b) for a, b in zip(got, again))
    case = {**tags, "dtype": str(dtype).split(".")[1], "max_abs_err": errs,
            "rel_err": rels, **same, "bit_equal_second_call": bits, "ok": ok and bits}
    check(case["ok"], f"ssd_scan_bwd disagrees: {case}")
    return case, max(errs)


def phase_kernels_ssd_bwd():
    """K3's backward kernel against the plain backward (ref.ssd_scan_bwd) at
    the SSD sweep, the edges and the reduced shape, fp32 and bf16, with and
    without an initial state and a final state's gradient; strided views of
    one fused tensor; the training shape (bf16); each bit for bit against
    a second call, bf16 also against the plain version of its own
    roundings (ref.ssd_scan_bwd_bf16). Then device time at the training
    shape (no initial state, no final state's gradient: the train step's
    case), the whole and each of its launches alone (``ssdb.PARTS``)."""
    results, worst, t0 = [], 0.0, time.monotonic()
    for shape in (*SSD_REF_SHAPES, *SSD_EDGE_SHAPES, SSD_REDUCED_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            for with_init in (False, True):
                for with_dfinal in (False, True):
                    case, err = ssd_bwd_case(
                        ssd_bwd_args(shape, dtype, with_init, with_dfinal), shape[-1], dtype,
                        shape=list(shape), initial_state=with_init, dfinal_state=with_dfinal)
                    results.append(case)
                    worst = max(worst, err)
    B, S, H, P, N, chunk = SSD_REF_SHAPES[2]
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, Bm, Cm, s0, dy, dfs = ssd_bwd_args(SSD_REF_SHAPES[2], dtype, True, True)
        fused = torch.cat([x.reshape(B, S, H * P), Bm, Cm], dim=-1)
        xv, Bv, Cv = torch.split(fused, [H * P, N, N], dim=-1)
        case, err = ssd_bwd_case((xv.reshape(B, S, H, P), dt, A, Bv, Cv, s0, dy, dfs), chunk,
                                 dtype, shape=list(SSD_REF_SHAPES[2]), initial_state=True,
                                 dfinal_state=True, strided_views=True)
        results.append(case)
        worst = max(worst, err)
    dtype = torch.bfloat16
    args = ssd_bwd_args(SSD_FULL_SHAPE, dtype, False, False)
    case, err = ssd_bwd_case(args, SSD_FULL_SHAPE[-1], dtype, shape=list(SSD_FULL_SHAPE),
                             initial_state=False, dfinal_state=False)
    results.append(case)
    worst = max(worst, err)
    emit({"phase": "kernels", "kernel": ssdb.NAME, "cases": results,
          "tol": "1e-3 * max|g| fp32, 3e-2 * max|g| bf16, per gradient (the SSD tolerances "
          "of tests/test_kernels.py); bf16 also 1e-2 * max|g| of ref.ssd_scan_bwd_bf16; and "
          "bit-equal across two calls",
          "seconds": time.monotonic() - t0})
    t0 = time.monotonic()

    x, dt, A, Bm, Cm, _, dy, _ = args
    chunk = SSD_FULL_SHAPE[-1]
    kern = lambda: ssdb.ssd_scan_bwd(*args, chunk=chunk)  # noqa: E731
    plain = lambda: ref.ssd_scan_bwd(*args, chunk=chunk)  # noqa: E731
    # each launch alone, on one call's buffers (the first calls below run
    # them in order, so each reads what the ones before it wrote)
    bufs = ssdb.new_buffers(x, Bm, chunk)
    parts = {}
    for name in ssdb.PARTS[dtype]:
        if name == ssdb.PASS:
            parts[f"{name} (states)"] = lambda: ssd.pass_states(
                bufs["states"], bufs["decay"], None, bufs["fs"])
            parts[f"{name} (gradients, reversed)"] = lambda: ssd.pass_states(
                bufs["adj"], bufs["decay_rev"], None, bufs["dinit"])
        else:
            parts[name] = functools.partial(ssdb.launch_parts, name, x, dt, A, Bm, Cm, dy, bufs,
                                            chunk=chunk)
    for fn in (kern, plain, *parts.values()):
        fn()
    torch.cuda.synchronize()
    timing = {"plain_ms": time_ms(plain, reps=3, inner=3), "ms": time_ms(kern, inner=5),
              "library_ms": None}
    timing["ms_again"] = time_ms(kern, inner=5)
    timing["parts_ms"] = {name: time_ms(fn, inner=5) for name, fn in parts.items()}
    bound_ms, bound_by, flops, nbytes = ssd_bwd_bound_ms(SSD_FULL_SHAPE, dtype)
    emit({"phase": "kernel_timing", "kernel": ssdb.NAME, "shape": list(SSD_FULL_SHAPE),
          "dtype": "bfloat16", **timing, "bound_ms": bound_ms, "bound_by": bound_by,
          "flops": flops, "bytes": nbytes, "scratch_bytes": sum(
              t.numel() * t.element_size() for k, t in bufs.items()
              if k in ("cb", "states", "adj", "decay", "decay_rev", "dBp", "dCp", "dAp", "fs")),
          "heads_per_block": x.shape[2] // bufs["dBp"].shape[0],
          "library": "none: no single PyTorch call computes the SSD scan's backward, and "
          "autograd of the plain version is that version again",
          "tflops": flops / timing["ms"] / 1e9, "seconds": time.monotonic() - t0})
    del args, x, dt, A, Bm, Cm, dy, bufs, parts
    return {"max_abs_err": worst, **timing, "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": list(SSD_FULL_SHAPE)}


def freed_memory() -> tuple:
    """Device bytes allocated after a collection, before and after the
    per-thread cuBLAS workspaces are cleared (each thread that ran a cuBLAS
    call keeps one for the life of the process; those are not the port's)."""
    gc.collect()
    raw = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return raw, torch.cuda.memory_allocated()


def record(r) -> dict:
    return {"e2e_s": r.e2e, "warm_stage": r.warm_stage,
            "stages_s": dict(r.stages), "error": r.error}


def forward_launches(cfg) -> dict:
    """Kernel launches of one forward of ``cfg``: K1 once per attention
    layer (and per encoder layer and cross attention), K3 once per Mamba2
    layer."""
    enc = cfg.encoder_layers + cfg.num_layers if cfg.is_encoder_decoder else 0
    return {**dict.fromkeys(KERNELS, 0), fa.NAME: cfg.num_attn_layers + enc,
            ssd.NAME: cfg.num_mamba_layers}


def phase_reduced(phase, arch):
    """SageRuntime serves the reduced ``arch`` cold -> warm -> warm; every
    request launches each kernel as ``forward_launches`` says and nothing
    else. Returns the launches by kernel."""
    rt = SageRuntime("sage", time_scale=0.02, exit_ttl=5.0, device="cuda")
    rt.sage_init()
    fn = make_model_function(rt.db, "f", arch=arch, seed=3)
    rt.register_function(fn)
    reqs = [make_request(rt.db, fn, seed=s) for s in (0, 1, 2)]
    served, per_request, ctx_per_request = [], [], []
    reset_counts()  # -- the main path (reduced) starts here
    for req in reqs:
        before, ctx_before = counts(), ctx_counts()
        served.append(rt.db.fetch(rt.sage_run(req)))
        ctx_per_request.append(minus(ctx_counts(), ctx_before))
        per_request.append(minus(minus(counts(), before), ctx_per_request[-1]))
    launches = counts()  # -- and ends here
    recs = rt.telemetry.records
    warm = [r.warm_stage for r in recs]
    stats = dict(rt.daemon.stats)
    usage = rt.drain()
    rt.shutdown()

    cfg = ARCHS[arch].reduced()
    weights = rt.db.fetch("f/weights")  # the host copy
    errs = []
    for req, out in zip(reqs, served):
        toks = rt.db.fetch(req.in_data[1].key)
        plain, _ = forward(cfg, weights, {"tokens": toks})  # CPU: plain versions
        errs.append(float(np.abs(out - plain[:, -1, :8].numpy()).max()))
    want = forward_launches(cfg)
    emit({"phase": phase, "arch": cfg.name, "warm_stage": warm,
          "shared_hits": stats["shared_hits"], "loads": stats["loads"],
          "launches": launches, "launches_per_request": per_request,
          "context_launches_per_request": ctx_per_request,
          "max_abs_err_vs_cpu_plain": max(errs), "tol": 1e-4,
          "requests": [record(r) for r in recs], "usage_after": usage})
    check(warm == [None, 1, 1], f"{arch}: warm_stage {warm}")
    check(stats["shared_hits"] >= 1, f"{arch}: no shared hit")
    check(per_request == [want] * 3, f"{arch}: launches per request's forward {per_request} "
          f"!= {want}")
    want_ctx = [warmups(cfg, 1), warmups(cfg, 0), warmups(cfg, 0)]
    check(ctx_per_request == want_ctx, f"{arch}: the context build's warm-up launched "
          f"{ctx_per_request} per request, want {want_ctx} (one build, on the cold request)")
    check(max(errs) <= 1e-4, f"{arch}: served logits differ from the CPU forward: {errs}")
    check(usage["device_used"] == usage["host_used"] == 0, f"{arch}: teardown {usage}")
    return launches


def phase_full(phase, arch, fn_name):
    """SageRuntime serves the unreduced ``arch`` (published widths and
    depth, bf16, random weights from seed 0), batch 4 x 1024: cold, warm,
    then a burst of 4 concurrent requests. The cold request runs eagerly,
    the warm one captures the context's CUDA graph and the burst replays
    it: the K1 and K3 calls whose kernels a profiler trace of the burst
    shows are 4 forwards' and match the counters, and every answer equals
    the direct forward's. Returns the launches by kernel."""
    cfg = ARCHS[arch]
    check(cfg.param_dtype == cfg.compute_dtype == "bfloat16", "full width is bf16")
    base_alloc = torch.cuda.memory_allocated()
    time_scale, load_timeout_s = 1.0, 120.0
    rt = SageRuntime("sage", time_scale=time_scale, load_timeout_s=load_timeout_s,
                     exit_ttl=60.0, device="cuda")
    rt.sage_init()
    t0 = time.monotonic()
    fn = _model_function(rt.db, fn_name, cfg, batch=FULL_BATCH, seq=FULL_SEQ, seed=0)
    init_s = time.monotonic() - t0
    rt.register_function(fn)
    ro_bytes = rt.db.size_of(f"{fn_name}/weights")
    modelled_s = (ro_bytes / rt.paths.db.base_bw + ro_bytes / rt.paths.pcie.base_bw) * time_scale
    reqs = [make_request(rt.db, fn, batch=FULL_BATCH, seq=FULL_SEQ,
                         vocab=cfg.vocab_size, seed=s) for s in range(6)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # -- the main path (full width) starts here
    t0 = time.monotonic()
    out_keys = [rt.sage_run(reqs[0])]
    cold_ctx = ctx_counts()
    cold_launches = minus(counts(), cold_ctx)  # the cold request's forward
    out_keys.append(rt.sage_run(reqs[1]))
    before_burst = counts()

    def burst():  # submitted inside the trace: the profiler takes a while to start
        futs = [rt.submit(r) for r in reqs[2:]]
        return [f.result(timeout=600) for f in futs]

    burst_keys, traced = traced_calls(burst)
    out_keys += burst_keys
    wall_s = time.monotonic() - t0
    launches = counts()  # -- and ends here
    burst_launches = minus(launches, before_burst)
    routes = graph_counts(fn_name)
    ctx, n_builds = ctx_counts(), builds(fn_name)
    peak = torch.cuda.max_memory_allocated()
    recs = rt.telemetry.records
    ctx_obj = rt.engines[fn_name]._shared_ctx
    context = {"context_build_s": ctx_obj.build_s,
               "context_reserved_bytes": ctx_obj.reserved_bytes,
               "context_declared_bytes": fn.context_bytes}
    del ctx_obj
    warm_compute = [r.stages["compute"] for r in recs[1:2]]
    stats = dict(rt.daemon.stats)
    served = [rt.db.fetch(k) for k in out_keys]

    # every served request (eager, captured and replayed) against the
    # direct forward of the same weights and tokens on the card (these
    # launches are a comparison, not the path)
    weights = rt.db.to_device(rt.db.fetch(f"{fn_name}/weights"))
    direct_errs = []
    for req, got in zip(reqs, served):
        toks = rt.db.fetch(req.in_data[1].key).cuda()
        with torch.inference_mode():
            direct = forward(cfg, weights, {"tokens": toks})[0][:, -1, :8].float().cpu().numpy()
        direct_errs.append(float(np.abs(got - direct).max()))
    direct_err = max(direct_errs)
    del weights, toks
    usage = rt.drain()
    rt.shutdown()
    del rt, fn
    after_raw, after = freed_memory()
    want = forward_launches(cfg)
    emit({"phase": phase, "arch": cfg.name, "params": cfg.param_count(),
          "ro_bytes": ro_bytes, "batch": FULL_BATCH, "seq": FULL_SEQ,
          "init_s": init_s, "time_scale": time_scale, "load_timeout_s": load_timeout_s,
          "modelled_load_s": modelled_s, "wall_s": wall_s,
          "requests": [record(r) for r in recs], "shared_hits": stats["shared_hits"],
          "loads": stats["loads"], "launches": launches, "cold_launches": cold_launches,
          "context_launches": ctx, "context_builds": n_builds,
          **context,
          "cold_compute_over_warm": recs[0].stages["compute"] / warm_compute[0],
          "max_memory_allocated": peak, "memory_allocated_before": base_alloc,
          "memory_allocated_after_shutdown": after_raw,
          "memory_allocated_after_cublas_workspaces_cleared": after, "usage_after": usage,
          "eager_captured_replayed": routes, "burst_launches": burst_launches,
          "burst_traced_calls": traced,
          "direct_max_abs_err": direct_err, "direct_max_abs_err_by_request": direct_errs,
          "served_sample": [float(x) for x in served[0][0]]})
    check(all(r.error is None for r in recs), f"{arch}: a request failed")
    check(len(recs) == 6 and recs[0].warm_stage is None, f"{arch}: cold request")
    check(cold_launches == want, f"{arch}: cold request's forward launched {cold_launches} "
          f"!= {want}")
    check(n_builds == 1 and cold_ctx == ctx == warmups(cfg, 1),
          f"{arch}: {n_builds} context builds launched {cold_ctx} (cold) and {ctx} (all), "
          f"want one build's {warmups(cfg, 1)}")
    check(minus(launches, ctx) == {n: 6 * c for n, c in want.items()},
          f"{arch}: {launches} launches for 6 requests and the context's {ctx}, "
          f"want 6 x {want} besides the context's")
    check(routes == (1, 1, 4), f"{arch}: (eager, captured, replayed) forwards {routes}, "
          f"want the cold one eager, the warm one captured and the burst replayed")
    burst_want = {n: 4 * c for n, c in want.items() if n in (fa.NAME, ssd.NAME)}
    check({n: traced[n] for n in burst_want} == {n: burst_launches[n] for n in burst_want}
          == burst_want, f"{arch}: the burst's replays ran {traced} K1/K3 calls by the "
          f"trace and counted {burst_launches}, want {burst_want}")
    over = recs[0].stages["compute"] / warm_compute[0]
    check(arch != "qwen2.5-3b" or over <= COLD_MAX_OVER_WARM,
          f"{arch}: the cold request's compute is {over} x the warm one's: the context "
          f"build did not carry the first forward's shape-only work")
    check(stats["shared_hits"] >= 5, f"{arch}: shared_hits {stats['shared_hits']}")
    check(all(np.isfinite(s).all() and s.shape == (FULL_BATCH, 8) for s in served),
          f"{arch}: served logits not finite")
    check(direct_err <= 1e-3, f"{arch}: served differs from the direct forward: "
          f"{direct_errs}")
    check(usage["device_used"] == usage["host_used"] == 0, f"{arch}: teardown {usage}")
    check(after <= base_alloc, f"{arch}: device memory not freed: {after} > {base_alloc} bytes")
    return launches


def load_example(name: str):
    """A script of examples/ as a module (its ``main`` is what a user runs)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ms(seconds) -> float:
    return seconds * 1e3


def phase_gateway():
    """The Gateway API on the card, through the entry points a user calls:
    examples/torch_quickstart.py's ``main(device="cuda")`` (the reduced
    qwen2.5-3b, as the JAX package's gateway serves it), runtime<->sim
    parity over one trace, a working set that never fits (DataLoadError
    within the load timeout) and a 2-node cluster. Each path sets the
    counts to 0 just before it and reads them just after; returns K1's
    launches over the four. The direct forward that the served output is
    held against is a comparison and is not counted."""
    cfg = ARCHS["qwen2.5-3b"].reduced()
    layers = cfg.num_layers
    quickstart = load_example("torch_quickstart")
    gc.collect()
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated()

    # 1. the quickstart: cold + warm invoke, then shutdown
    reset_counts()  # -- the quickstart path starts here
    t0 = time.monotonic()
    res = quickstart.main(device="cuda")
    wall_s = time.monotonic() - t0
    qs, qs_ctx = counts(), ctx_counts()  # -- and ends here
    cold, warm, db = res["cold"], res["warm"], res["gateway"].runtime.db
    device = str(db.device)
    errs = []
    with torch.inference_mode():
        weights = db.to_device(db.fetch("demo-llm/weights"))
        for rec in (cold, warm):
            toks = db.fetch(f"demo-llm/in/{rec.request_id}").cuda()
            direct = forward(cfg, weights, {"tokens": toks})[0][:, -1, :8].float().cpu().numpy()
            errs.append(float(np.abs(db.fetch(rec.result) - direct).max()))
    sample = [float(x) for x in db.fetch(cold.result)[0]]
    hits, usage = res["shared_hits"], res["memory"]
    del weights, toks, db, res
    after_raw, after = freed_memory()
    emit({"phase": "gateway", "check": "quickstart", "arch": cfg.name, "device": device,
          "time_scale": 0.2, "wall_s": wall_s,
          "cold_e2e_ms": ms(cold.e2e), "warm_e2e_ms": ms(warm.e2e),
          "cold_stages_ms": {k: ms(v) for k, v in cold.stages.items()},
          "warm_stages_ms": {k: ms(v) for k, v in warm.stages.items()},
          "warm_stage": [cold.warm_stage, warm.warm_stage], "shared_hits": hits,
          "memory_usage_before_shutdown": usage, "launches": qs, "context_launches": qs_ctx,
          "direct_max_abs_err": errs, "served_sample": sample,
          "memory_allocated_before": base_alloc, "memory_allocated_after_shutdown": after_raw,
          "memory_allocated_after_cublas_workspaces_cleared": after})
    check(device.startswith("cuda"), f"the gateway's database is on {device}")
    check(cold.error is None and warm.error is None, f"{cold.error} {warm.error}")
    check(cold.warm_stage is None and warm.warm_stage == 1,
          f"warm_stage {cold.warm_stage}, {warm.warm_stage}")
    check(hits >= 1, f"shared_hits {hits}")
    check(qs_ctx == warmups(cfg, 1), f"quickstart: the context launched {qs_ctx}, want one "
          f"build's {warmups(cfg, 1)}")
    fwd = minus(qs, qs_ctx)
    check(fwd[fa.NAME] == 2 * layers and sum(fwd.values()) == fwd[fa.NAME],
          f"quickstart launches {qs}, want {2 * layers} of {fa.NAME} besides the context's")
    check(max(errs) == 0.0, f"served output differs from the direct forward: {errs}")
    check(after <= base_alloc, f"device memory not freed: {after} > {base_alloc} bytes")

    # 2. runtime<->sim parity over one trace (tests/test_torch_api.py's)
    spec = FunctionSpec(name="par", deadline_s=30.0, arch="qwen2.5-3b", profile="seq2seq")
    workload = TraceWorkload([(0.0, "par"), (2.5, "par"), (5.0, "par")])
    gw_sim = Gateway(backend="sim", policy="sage")
    gw_sim.register(spec)
    tel_sim = gw_sim.replay(workload, until_pad=60.0)
    t0 = time.monotonic()
    reset_counts()  # -- the parity path starts here
    with Gateway(backend="runtime", policy="sage", time_scale=0.05, device="cuda") as gw:
        gw.register(spec)
        tel_rt = gw.replay(workload, pace=0.4)  # arrivals 1 s apart on the wall clock
    par, par_ctx = counts(), ctx_counts()  # -- and ends here
    wall_s = time.monotonic() - t0
    recs = {name: sorted(tel.records, key=lambda r: r.arrival_t)
            for name, tel in (("sim", tel_sim), ("runtime", tel_rt))}
    cold_flags = {name: [r.warm_stage is None for r in rs] for name, rs in recs.items()}
    emit({"phase": "gateway", "check": "parity", "wall_s": wall_s, "launches": par,
          "context_launches": par_ctx, "cold": cold_flags,
          "e2e_ms": {name: [ms(r.e2e) for r in rs] for name, rs in recs.items()},
          "errors": {name: [r.error for r in rs] for name, rs in recs.items()}})
    for name, rs in recs.items():
        check(len(rs) == 3 and all(r.error is None for r in rs), f"{name}: {rs}")
        check(all(set(r.stages) == set(STAGES) for r in rs), f"{name}: stage keys")
        check(all(r.deadline_s == 30.0 for r in rs), f"{name}: deadlines")
    check(cold_flags["sim"] == cold_flags["runtime"] == [True, False, False],
          f"warm classification {cold_flags}")
    check(par_ctx == warmups(cfg, 1) and minus(par, par_ctx)[fa.NAME] == 3 * layers,
          f"parity launches {par}, the context's {par_ctx}")

    # 3. a working set that never fits: DataLoadError, within the load timeout
    load_timeout_s = 0.5
    reset_counts()  # -- the failing path starts here
    with Gateway(backend="runtime", policy="sage", device_capacity=600 * MB,
                 time_scale=0.02, load_timeout_s=load_timeout_s, device="cuda") as gw:
        gw.register(FunctionSpec(name="big", arch="qwen2.5-3b", profile="bert"))
        t0 = time.monotonic()
        rec = gw.invoke_async("big").wait(timeout=60.0, strict=False)
        fail_s = time.monotonic() - t0
    failing, failing_ctx = counts(), ctx_counts()  # -- and ends here
    emit({"phase": "gateway", "check": "data_load_error", "device_capacity": 600 * MB,
          "load_timeout_s": load_timeout_s, "resolved_after_s": fail_s, "launches": failing,
          "context_launches": failing_ctx,
          "error": rec.error,
          "error_class": rec.error_class})
    check(rec.error is not None and "DataLoadError" in rec.error, f"error {rec.error!r}")
    check(fail_s <= load_timeout_s + 1.0, f"resolved after {fail_s} s")
    check(failing == failing_ctx, f"the failing request launched {failing} besides the "
          f"context's {failing_ctx}")

    # 4. a 2-node ClusterRuntime replaying 4 arrivals
    reset_counts()  # -- the cluster path starts here
    t0 = time.monotonic()
    with Gateway(backend="runtime", policy="sage", n_nodes=2, time_scale=0.02, seed=0,
                 device="cuda") as gw:
        gw.register(FunctionSpec(name="f", arch="qwen2.5-3b", profile="seq2seq"))
        tel = gw.replay(TraceWorkload([(0.02 * i, "f") for i in range(4)]))
        devices = sorted({str(n.db.device) for n in gw.runtime.nodes})
        found = gw.report().find(tel.records[0].request_id) is tel.records[0]
    clu, clu_ctx, clu_builds = counts(), ctx_counts(), builds("f")  # -- and ends here
    emit({"phase": "gateway", "check": "cluster", "n_nodes": 2, "devices": devices,
          "wall_s": time.monotonic() - t0, "launches": clu, "context_launches": clu_ctx,
          "context_builds": clu_builds, "nodes": [r.node_id for r in tel.records], "e2e_ms": [ms(r.e2e) for r in tel.records],
          "errors": tel.error_count()})
    check(len(tel.records) == 4 and tel.error_count() == 0, f"cluster records {tel.records}")
    check(found, "the merged cluster view lost its lookup index")
    check(all(d.startswith("cuda") for d in devices), f"cluster nodes on {devices}")
    check(1 <= clu_builds <= 2 and clu_ctx == warmups(cfg, clu_builds)
          and minus(clu, clu_ctx)[fa.NAME] == 4 * layers,
          f"cluster launches {clu}, the context's {clu_ctx} in {clu_builds} builds")
    freed_memory()
    return sum(c[fa.NAME] for c in (qs, par, failing, clu))


# ---------------------------------------------------------------------------
# the serving launcher, the serving example and the exit ladder
# ---------------------------------------------------------------------------

SERVE_REQUESTS, SERVE_RATE = 16, 8.0
SERVE_WORKLOAD_REQUESTS, SERVE_WORKLOAD_RATE = 12, 12.0
# the modelled db and PCIe legs at 1/20 of their time (the launchers'
# defaults are 0.2 and 0.05); the real copies and forwards are unscaled
SERVE_TIME_SCALE = 0.05
LADDER_TTL = 10.0          # seconds per exit stage on the engine's clock
LADDER_SEEDS = {"cold": 0, 1: 1, 2: 0, 3: 3, 4: 4}  # the stage-2 hit repeats the cold input
LADDER_SKIP_S = 5e-3       # a skipped setup stage: its measured time is below this


def phase_serve():
    """``launch/serve.py``'s ``serve`` on the card, as a user calls it: the
    reduced qwen2.5-3b behind the gateway, 16 Poisson requests at rate 8,
    for FixedGSL and for SAGE. Each run sets the counts to 0 just before
    and reads them just after. Every request served, K1 launched once per
    attention layer of each request and nothing else, and after shutdown
    the gateway declares no device bytes and the card's allocated bytes are
    back to their value before. Returns the launches over both runs."""
    from repro_torch.launch.serve import serve

    layers = ARCHS["qwen2.5-3b"].reduced().num_attn_layers
    base_alloc = freed_memory()[1]
    total, runs = dict.fromkeys(KERNELS, 0), {}
    for system in ("fixedgsl", "sage"):
        reset_counts()  # -- the serve path starts here
        t0 = time.monotonic()
        served = serve("qwen2.5-3b", system, requests=SERVE_REQUESTS, rate=SERVE_RATE,
                       time_scale=SERVE_TIME_SCALE, device="cuda")
        wall_s = time.monotonic() - t0
        launches, ctx = counts(), ctx_counts()  # -- and ends here
        after_raw, after = freed_memory()
        tel, usage = served.telemetry, served.usage
        n_builds = sum(F.context_builds.values())
        runs[system] = {
            "device": served.device, "wall_s": wall_s, "requests": len(tel.records),
            "errors": tel.error_count(), "mean_e2e_ms": ms(tel.mean_e2e()),
            "p99_e2e_ms": ms(tel.p99_e2e()), "warm_share": tel.warm_fraction(),
            "shared_hits": served.stats["shared_hits"], "launches": launches,
            "context_launches": ctx, "context_builds": n_builds,
            "memory_usage_after_shutdown": usage,
            "memory_allocated_after_shutdown": after_raw,
            "memory_allocated_after_cublas_workspaces_cleared": after}
        check(served.device.startswith("cuda"), f"serve {system}: the database is on "
              f"{served.device}")
        check(len(tel.records) == SERVE_REQUESTS and tel.error_count() == 0,
              f"serve {system}: {len(tel.records)} records, {tel.error_count()} errors")
        want = {**dict.fromkeys(KERNELS, 0), fa.NAME: SERVE_REQUESTS * layers}
        rcfg = ARCHS["qwen2.5-3b"].reduced()
        check(n_builds >= 1 and ctx == warmups(rcfg, n_builds) and minus(launches, ctx) == want,
              f"serve {system}: launches {launches}, want {want} besides the context's "
              f"{ctx} ({n_builds} builds)")
        check(usage["device_used"] == 0, f"serve {system}: after shutdown {usage}")
        check(after <= base_alloc, f"serve {system}: device memory not freed: "
              f"{after} > {base_alloc} bytes")
        for name, n in launches.items():
            total[name] += n
    emit({"phase": "serve", "arch": "qwen2.5-3b (reduced)", "requests": SERVE_REQUESTS,
          "rate": SERVE_RATE, "time_scale": SERVE_TIME_SCALE, "runs": runs,
          "memory_allocated_before": base_alloc,
          "fixedgsl_over_sage_mean_e2e": runs["fixedgsl"]["mean_e2e_ms"]
          / runs["sage"]["mean_e2e_ms"]})
    return total


def phase_serve_workload():
    """examples/torch_serve_workload.py's ``drive`` on the card for FixedGSL
    and SAGE, 12 Poisson requests at rate 12 over the reduced qwen2.5-3b,
    qwen3-8b (K1) and mamba2-780m (K3). Every request served without error,
    and each launched its function's kernels as ``forward_launches`` says,
    and nothing else. Returns the launches over both."""
    example = load_example("torch_serve_workload")
    per_fn = {s.name: forward_launches(ARCHS[s.arch].reduced()) for s in example.SPECS}
    total, runs = dict.fromkeys(KERNELS, 0), {}
    for system in ("fixedgsl", "sage"):
        reset_counts()  # -- the serve_workload path starts here
        t0 = time.monotonic()
        tel = example.drive(system, SERVE_WORKLOAD_REQUESTS, SERVE_WORKLOAD_RATE,
                            device="cuda")
        wall_s = time.monotonic() - t0
        launches, ctx = counts(), ctx_counts()  # -- and ends here
        n_builds = dict(F.context_builds)
        runs[system] = {"requests": len(tel.records), "errors": tel.error_count(),
                        "mean_e2e_ms": ms(tel.mean_e2e()), "p99_e2e_ms": ms(tel.p99_e2e()),
                        "wall_s": wall_s, "launches": launches, "context_launches": ctx,
                        "context_builds": n_builds}
        check(len(tel.records) == SERVE_WORKLOAD_REQUESTS and tel.error_count() == 0,
              f"serve_workload {system}: {len(tel.records)} records, "
              f"{tel.error_count()} errors")
        want = {k: sum(per_fn[r.function][k] for r in tel.records) for k in KERNELS}
        want_ctx = {k: sum(warmups(ARCHS[s.arch].reduced(), n_builds.get(s.name, 0))[k]
                           for s in example.SPECS) for k in KERNELS}
        check(ctx == want_ctx and minus(launches, ctx) == want,
              f"serve_workload {system}: launches {launches}, want {want} besides the "
              f"context's {ctx} (want {want_ctx} for builds {n_builds})")
        for name, n in launches.items():
            total[name] += n
    freed_memory()
    emit({"phase": "serve_workload", "requests": SERVE_WORKLOAD_REQUESTS,
          "rate": SERVE_WORKLOAD_RATE, "functions": [s.arch for s in example.SPECS],
          "runs": runs, "fixedgsl_over_sage_mean_e2e":
              runs["fixedgsl"]["mean_e2e_ms"] / runs["sage"]["mean_e2e_ms"]})
    check(total[fa.NAME] > 0 and total[ssd.NAME] > 0,
          f"serve_workload: K1 and K3 must both launch: {total}")
    return total


class PinnedClock:
    """An engine's clock pinned at ``t`` (the exit ladder reads it); its
    sleeps do not wait (the modelled container and CPU-context stages are
    still recorded), as tests/test_runtime.py's clock does."""

    def __init__(self, t):
        self.t = t

    def now(self):
        return self.t

    def sleep(self, dt):
        pass


def memory_now(rt) -> dict:
    torch.cuda.synchronize()
    gc.collect()
    return {**rt.memory_usage(), "allocated": torch.cuda.memory_allocated()}


def phase_exit_ladder():
    """The multi-stage exit ladder (paper §6.3, Table 4) on real device
    memory: the full-width qwen2.5-3b (bf16, random weights from seed 0,
    6.17 GB) through SageRuntime, batch 4 x 1024, one cold request, then at
    the middle of each of stages 1-4 (the engine's clock pinned there, as
    tests/test_runtime.py does; each hit restarts the ladder, as the demo's
    waits do) the declared and the real memory, then one hit. Checks: real
    memory falls by >= 90 % of the weights at stage 2 and the declared
    device bytes fall at stages 2 and 3; each hit lands in its stage; the
    stage-1 hit skips the context and the data, the stage-2 hit skips the
    context and pays a real host -> device copy, the stage-3 hit rebuilds
    the context (``stage_skips``); the stage-2 hit's logits equal the cold
    request's. Returns the launches."""
    cfg = ARCHS["qwen2.5-3b"]
    check(cfg.param_dtype == cfg.compute_dtype == "bfloat16", "full width is bf16")
    base_alloc = freed_memory()[1]
    rt = SageRuntime("sage", time_scale=SERVE_TIME_SCALE, load_timeout_s=120.0,
                     exit_ttl=LADDER_TTL, device="cuda")
    rt.sage_init()
    t0 = time.monotonic()
    fn = _model_function(rt.db, "ladder", cfg, batch=FULL_BATCH, seq=FULL_SEQ, seed=0)
    init_s = time.monotonic() - t0
    rt.register_function(fn)
    weights = rt.db.size_of("ladder/weights")
    pcie_s = weights / rt.paths.pcie.base_bw * SERVE_TIME_SCALE  # the modelled PCIe leg
    reqs = {k: make_request(rt.db, fn, batch=FULL_BATCH, seq=FULL_SEQ, vocab=cfg.vocab_size,
                            seed=s) for k, s in LADDER_SEEDS.items()}
    eng = rt.engines["ladder"]
    reset_counts()  # -- the exit-ladder path starts here
    t0 = time.monotonic()
    served = {"cold": rt.db.fetch(rt.sage_run(reqs["cold"]))}
    cold = rt.telemetry.records[-1]
    stages = []
    for k in (1, 2, 3, 4):
        pre = memory_now(rt)
        eng.clock = PinnedClock(eng.instances[0].ladder.completion_t + (k - 0.5) * LADDER_TTL)
        eng._advance_ladders()
        post = memory_now(rt)
        served[k] = rt.db.fetch(rt.sage_run(reqs[k]))
        rec = rt.telemetry.records[-1]
        stages.append({"stage": k, "before_advance": pre, "after_advance": post,
                       "after_hit": memory_now(rt), "warm_stage": rec.warm_stage,
                       "e2e_ms": ms(rec.e2e), "gpu_ctx_ms": ms(rec.stages["gpu_ctx"]),
                       "gpu_data_ms": ms(rec.stages["gpu_data"]), "error": rec.error})
    wall_s = time.monotonic() - t0
    launches, ctx, n_builds = counts(), ctx_counts(), builds("ladder")  # -- and ends here
    usage = rt.drain()
    rt.shutdown()
    del rt, fn, eng
    after_raw, after = freed_memory()
    drop2 = stages[1]["before_advance"]["allocated"] - stages[1]["after_advance"]["allocated"]
    copy2 = stages[1]["after_hit"]["allocated"] - stages[1]["after_advance"]["allocated"]
    same = bool(np.array_equal(served[2], served["cold"]))
    emit({"phase": "exit_ladder", "arch": cfg.name, "params": cfg.param_count(),
          "weights_bytes": weights, "batch": FULL_BATCH, "seq": FULL_SEQ, "ttl_s": LADDER_TTL,
          "time_scale": SERVE_TIME_SCALE, "init_s": init_s, "wall_s": wall_s,
          "modelled_pcie_leg_ms": ms(pcie_s),
          "cold": {"e2e_ms": ms(cold.e2e), "stages_ms": {s: ms(v) for s, v in cold.stages.items()}},
          "stages": stages, "stage2_real_drop_bytes": drop2,
          "stage2_drop_share_of_weights": drop2 / weights, "stage2_hit_real_copy_bytes": copy2,
          "stage2_logits_equal_cold": same, "launches": launches, "context_launches": ctx,
          "context_builds": n_builds, "usage_after": usage,
          "memory_allocated_before": base_alloc, "memory_allocated_after_shutdown": after_raw,
          "memory_allocated_after_cublas_workspaces_cleared": after})
    check(cold.error is None and cold.warm_stage is None, f"cold request {cold.error}")
    for s in stages:
        check(s["error"] is None and s["warm_stage"] == s["stage"],
              f"the stage-{s['stage']} hit landed in {s['warm_stage']} ({s['error']})")
    check(drop2 >= 0.9 * weights, f"stage 2 freed {drop2} real bytes of {weights}")
    st = {s["stage"]: s for s in stages}
    check(st[2]["after_advance"]["device_used"] < st[2]["before_advance"]["device_used"]
          and st[3]["after_advance"]["device_used"] < st[2]["after_advance"]["device_used"],
          "the declared device bytes did not fall at stages 2 and 3")
    for k in (1, 2):  # the context held: no reservation, no build
        check(st[k]["after_advance"]["context_bytes"] > 0
              and st[k]["gpu_ctx_ms"] < ms(LADDER_SKIP_S),
              f"the stage-{k} hit did not skip gpu_ctx: {st[k]}")
    check(st[1]["after_advance"]["device_used"] >= weights
          and st[1]["gpu_data_ms"] < ms(LADDER_SKIP_S),
          f"the stage-1 hit did not skip gpu_data: {st[1]}")
    check(st[2]["gpu_data_ms"] >= ms(pcie_s) and copy2 >= 0.9 * weights,
          f"the stage-2 hit paid no host -> device copy: {st[2]}, {copy2} bytes")
    check(st[3]["after_advance"]["context_bytes"] == 0 and st[3]["gpu_ctx_ms"] > 0
          and st[3]["after_hit"]["context_bytes"] > 0,
          f"the stage-3 hit did not rebuild the context: {st[3]}")
    check(same, "the stage-2 hit's logits differ from the cold request's")
    want = {**dict.fromkeys(KERNELS, 0), fa.NAME: 5 * cfg.num_attn_layers}
    # SAGE keeps its compiled context across stage 3 (the stage-3 and
    # stage-4 hits re-reserve its memory but reuse it), so one build
    check(n_builds == 1 and ctx == warmups(cfg, 1) and minus(launches, ctx) == want,
          f"exit ladder launches {launches}, want {want} besides {n_builds} context builds' "
          f"{ctx}")
    check(usage["device_used"] == usage["host_used"] == 0, f"exit ladder teardown {usage}")
    check(after <= base_alloc, f"exit ladder: device memory not freed: {after} > {base_alloc}")
    return launches


# ---------------------------------------------------------------------------
# cold set-up: SAGE's parallel setup against FixedGSL's serial one
# ---------------------------------------------------------------------------

COLD_RUNS = 3
COLD_MAX_OVER_WARM = 1.15  # a cold request's compute stage over the warm median
# SAGE / FixedGSL e2e: a fresh process's first cold request under the
# reference's own bound (tests/test_system.py), the later colds' median
COLD_MAX_FIRST_RATIO, COLD_MAX_LATER_RATIO = 0.9, 1.10
COLD_MAX_PAGE_LOCKED = 1.1  # page-locked host bytes over the weights'
# the caching allocator's counters whose change over a cold request cold_runs
# reports (num_device_alloc only where this torch counts it)
ALLOC_STATS = ("segment.all.allocated", "num_alloc_retries", "num_device_alloc")


def alloc_stats() -> dict:
    s = torch.cuda.memory_stats()
    return {k: s[k] for k in ALLOC_STATS if k in s}


def log_loads(db, fn) -> list:
    """Wrap ``db.to_device``, ``db.fetch`` and ``fn.context_builder`` (on
    these objects only) so that each host -> device copy, each end of a
    modelled database leg and each context build is logged with its host
    clock span and native thread id; returns the log, which grows as
    requests run."""
    log = []

    def logged(kind, call, size=lambda *a: 0):
        def run(*args, **kw):
            t0 = time.monotonic()
            out = call(*args, **kw)
            log.append({"kind": kind, "t0": t0, "t1": time.monotonic(),
                        "bytes": size(*args), "thread": threading.get_native_id()})
            return out
        return run

    db.to_device = logged("copy", db.to_device,
                          lambda obj: sum(t.numel() * t.element_size() for t in T.leaves(obj)
                                          if isinstance(t, torch.Tensor)))
    db.fetch = logged("fetch", db.fetch)
    fn.context_builder = logged("build", fn.context_builder)
    return log


def log_collections() -> tuple:
    """Log each garbage collection from now on as (start, seconds, its
    generation) on the host clock; returns the log, which grows, and the
    callback (to remove from ``gc.callbacks``). A full collection scans
    every object of a process that has imported the port: one landing in
    a request would be counted as the request's."""
    log, start = [], [0.0]

    def note(phase, info):
        if phase == "start":
            start[0] = time.monotonic()
        else:
            log.append((start[0], time.monotonic() - start[0], info["generation"]))

    gc.callbacks.append(note)
    return log, note


_TICK_MS = 1e3 / os.sysconf("SC_CLK_TCK")


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def task_cpu() -> dict:
    """Each native thread of this process: {tid: [name, CPU ms, run-queue
    wait ms]} from /proc/self/task/*/schedstat (ns; where it is missing,
    utime + stime of stat at the clock tick's resolution and no wait)."""
    py = {t.native_id: t.name for t in threading.enumerate()}
    out = {}
    for tid in os.listdir("/proc/self/task"):
        stat = _read(f"/proc/self/task/{tid}/stat")
        if not stat:
            continue  # the thread ended
        fields = stat[stat.rindex(")") + 2:].split()
        cpu, wait = (int(fields[11]) + int(fields[12])) * _TICK_MS, None
        sched = _read(f"/proc/self/task/{tid}/schedstat").split()
        if len(sched) == 3:
            cpu, wait = int(sched[0]) / 1e6, int(sched[1]) / 1e6
        out[int(tid)] = [py.get(int(tid), stat[stat.index("(") + 1:stat.rindex(")")]), cpu, wait]
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in b if k in a and b[k] != a[k]}


@contextlib.contextmanager
def host_window(out: dict, collections: list):
    """Fill ``out`` with what the host did over the ``with`` block (a whole
    request: these reads cost milliseconds, so they stay outside the
    stages): its start (``t``, host clock), wall ms, the calling thread's
    CPU ms and ``RUSAGE_THREAD`` deltas (``clocks``), every native
    thread's CPU and run-queue wait ms (``task_cpu``; those that ran), the
    garbage collections inside it (ms from its start, ms, generation) and
    the caching allocators' counter deltas."""
    tasks0, a0 = task_cpu(), alloc_stats()
    h0 = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    c0 = clocks()
    yield out
    span = between(c0, clocks())
    a1 = alloc_stats()
    h1 = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    tasks1, ran = task_cpu(), []
    for tid, (name, cpu, wait) in tasks1.items():
        _, cpu0, wait0 = tasks0.get(tid, (name, 0.0, 0.0 if wait is not None else None))
        if cpu - cpu0 > 0:
            ran.append([name, tid, cpu - cpu0, None if wait is None else wait - wait0])
    out.update({
        **span, "thread": threading.get_native_id(),
        "threads_ms": sorted(ran, key=lambda r: -r[2]),
        "collections": [(ms(t - c0[0]), ms(dt), g) for t, dt, g in collections if c0[0] <= t],
        "alloc_deltas": _delta(a0, a1),
        "host_alloc_deltas": {k: v for k, v in _delta(h0, h1).items()
                              if k.startswith("num_") or "bytes.current" in k}})


RUSAGE_KEYS = ("ru_minflt", "ru_majflt", "ru_nvcsw", "ru_nivcsw")


def clocks() -> tuple:
    """The host clock, the calling thread's CPU clock (s) and its
    ``RUSAGE_THREAD`` faults and context switches: cheap enough to read
    inside a stage."""
    import resource

    r = resource.getrusage(resource.RUSAGE_THREAD)
    return (time.monotonic(), time.thread_time(), *(getattr(r, k) for k in RUSAGE_KEYS))


def between(a: tuple, b: tuple) -> dict:
    """``clocks`` ``a`` to ``b``: start, wall and thread CPU ms, rusage deltas."""
    return {"t": a[0], "wall_ms": ms(b[0] - a[0]), "thread_cpu_ms": ms(b[1] - a[1]),
            "rusage": {k: y - x for k, x, y in zip(RUSAGE_KEYS, a[2:], b[2:])}}


def layer_marks():
    """Marks at each period boundary of a forward: the model's residual
    ``constrain`` after every period is wrapped (in this process) so that,
    while ``marks.on`` holds a list on the calling thread, each call adds
    its host clock and a CUDA event recorded on the current stream.
    Returns ``marks`` (a ``threading.local``)."""
    from repro_torch.models import model as M

    marks, plain = threading.local(), M.constrain
    marks.on = None

    def constrain(h, name):
        h = plain(h, name)
        on = getattr(marks, "on", None)
        if on is not None:
            on.append(mark())
        return h

    M.constrain = constrain
    return marks


def mark() -> tuple:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return time.monotonic(), ev


def probe_host(fn) -> list:
    """Wrap ``fn.handler`` and ``fn.context_builder`` (on this object only)
    so that each build and each compute (the handler) logs its ``clocks``
    span and the caching allocator's counters' change over it, and each
    compute the start and end of its forward's issue with a mark after
    every period of layers (``layer_marks``; none for a forward captured
    into the context's CUDA graph or replayed from it); returns the log of
    ``{"kind": "build" | "compute", ...}``, which grows as requests run
    (``probe_record`` reads an entry once its work is done)."""
    log, marks = [], layer_marks()
    build, handler = fn.context_builder, fn.handler

    def probed_build():
        a0, c0 = alloc_stats(), clocks()
        ctx = build()
        log.append({"kind": "build", **between(c0, clocks()),
                    "alloc_deltas": _delta(a0, alloc_stats())})
        plain = ctx.fwd

        def fwd(p, t):
            if torch.cuda.is_current_stream_capturing():
                return plain(p, t)  # a CUDA graph's capture: no event would run
            rec = log[-1]
            marks.on = rec["marks"] = [mark()]
            try:
                return plain(p, t)
            finally:
                marks.on = None
                rec["marks"].append(mark())

        ctx.fwd = fwd
        return ctx

    def probed_handler(shim, request):
        rec, a0, c0 = {"kind": "compute"}, alloc_stats(), clocks()
        log.append(rec)
        try:
            return handler(shim, request)
        finally:
            rec.update(between(c0, clocks()), alloc_deltas=_delta(a0, alloc_stats()))

    fn.context_builder, fn.handler = probed_build, probed_handler
    return log


def probe_record(rec: dict, t0: float) -> dict:
    """A ``probe_host`` entry with its times in ms from ``t0``, and its
    marks as per span (embedding and period 0, each later period, the
    final norm and unembedding) the host's ms to issue it and the device's
    ms to run it."""
    out = {k: v for k, v in rec.items() if k not in ("marks", "t")}
    out["start_ms"] = ms(rec["t"] - t0)
    marks = rec.get("marks")
    if marks:
        out.update(issue_start_ms=ms(marks[0][0] - rec["t"]),
                   issue_end_ms=ms(marks[-1][0] - rec["t"]),
                   host_ms=[ms(b[0] - a[0]) for a, b in zip(marks, marks[1:])],
                   device_ms=[a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])])
    return out


def cold_run_loads(log, t0, cold, rt, weights_key) -> dict:
    """What the log holds of the cold request that started at ``t0``: the
    weights' copy (its seconds and thread), the span from the end of their
    modelled database leg to the copy's start (the modelled PCIe leg and
    the device admission), the modelled legs' seconds from the brokers'
    rates, and the context build's seconds and thread."""
    mine = [e for e in log if t0 <= e["t0"] and e["t1"] <= t0 + cold.e2e + 1.0]
    copy = max((e for e in mine if e["kind"] == "copy"), key=lambda e: e["bytes"])
    fetch = max((e for e in mine if e["kind"] == "fetch" and e["t1"] <= copy["t0"]),
                key=lambda e: e["t1"])
    build = [e for e in mine if e["kind"] == "build"]
    declared = rt.db.size_of(weights_key)
    legs = declared * SERVE_TIME_SCALE * (1 / rt.paths.db.base_bw + 1 / rt.paths.pcie.base_bw)
    return {"copy_ms": ms(copy["t1"] - copy["t0"]), "copy_bytes": copy["bytes"],
            "copy_gb_per_s": copy["bytes"] / (copy["t1"] - copy["t0"]) / 1e9,
            "copy_thread": copy["thread"], "modelled_legs_ms": ms(legs),
            "fetch_end_to_copy_ms": ms(copy["t0"] - fetch["t1"]),
            "build_ms": [ms(e["t1"] - e["t0"]) for e in build],
            "build_thread": [e["thread"] for e in build],
            "copy_overlaps_build_ms": sum(
                max(0.0, min(copy["t1"], e["t1"]) - max(copy["t0"], e["t0"])) * 1e3
                for e in build)}


def cold_runs(system: str, settle=None) -> dict:
    """In this process (``chip_smoke.py --cold-runs SYSTEM``): COLD_RUNS cold
    requests of the full-width qwen2.5-3b (6.17 GB, bf16, seed 0, 4 x 1024)
    under ``system``, each on a new SageRuntime over one database (a new
    engine, so its context is built anew), each followed by one warm
    request. The first is the process's first forward at full width.
    Nothing runs between the requests but the probes' reads, outside the
    requests' spans; ``settle(slot)``, where given, runs before each
    (``scripts/torch_cold_compare.py``'s arms: a garbage collection or a
    sleep). Returns the records, the context builds' reserved bytes, per
    cold request the device bytes allocated at its start, the allocator's
    counters' change over it, its loads (``cold_run_loads``), the garbage
    collections that ran in it and per request the host's account
    (``host_window``, with the build's and the compute's ``probe_host``
    spans inside), the page-locked host bytes and the launches. No
    collection is forced before a request. One was, because without it a
    fresh process's first FixedGSL forward ran up to 2.11 x a warm one (3
    of 8 runs on an H100 80GB HBM3 at 700 W); the attribution (PERF.md
    §6) found that forward calling cudaMalloc for a new 2.49 GB segment
    for its logits, the weights' copy having taken the blocks the
    context's warm-up left for them, and the collection did not prevent
    it (2 slow of 12 with it, 0 of 12 without). Contexts now run their warm-ups and forwards on a compute
    stream whose blocks the copy cannot take
    (``core.functions.compute_stream``). Each request runs inside a
    ``torch.profiler.record_function`` range named ``cold/<run>/<kind>``
    (``scripts/torch_cold_trace.py`` reads them)."""
    cfg = ARCHS["qwen2.5-3b"]
    db = Database(device="cuda")
    fn = _model_function(db, "cold", cfg, batch=FULL_BATCH, seq=FULL_SEQ, seed=0)
    log = log_loads(db, fn)
    collections, note = log_collections()
    probes = probe_host(fn)
    runs = []
    reset_counts()  # -- the cold-setup path starts here
    for i in range(COLD_RUNS):
        rt = SageRuntime(system, time_scale=SERVE_TIME_SCALE, load_timeout_s=120.0,
                         exit_ttl=600.0, device="cuda", database=db)
        rt.sage_init()
        rt.register_function(fn)
        alloc0 = {"allocated": torch.cuda.memory_allocated(),
                  "reserved": torch.cuda.memory_reserved(), **alloc_stats()}
        settled, windows = {}, {}
        for s, kind in ((0, "cold"), (1, "warm")):  # a request's e2e counts from its making
            if settle is not None:
                t = time.monotonic()
                settle(2 * i + s)
                settled[kind] = ms(time.monotonic() - t)
            n_probes, windows[kind] = len(probes), {}
            with host_window(windows[kind], collections):
                if kind == "cold":
                    t0 = time.monotonic()
                with torch.profiler.record_function(f"cold/{i}/{kind}"):
                    rt.sage_run(make_request(db, fn, batch=FULL_BATCH, seq=FULL_SEQ,
                                             vocab=cfg.vocab_size, seed=s))
            if kind == "cold":
                alloc1 = alloc_stats()
            windows[kind]["inside"] = [probe_record(r, windows[kind]["t"])
                                       for r in probes[n_probes:]]
        eng = rt.engines["cold"]
        ctx = eng._shared_ctx or next(i.gpu_ctx for i in eng.instances if i.gpu_ctx)
        cold = rt.telemetry.records[0]
        runs.append({"cold": record(cold), "warm": record(rt.telemetry.records[1]),
                     "context_reserved_bytes": ctx.reserved_bytes,
                     "context_build_ms": ms(ctx.build_s),
                     "allocated_at_start": alloc0["allocated"],
                     "reserved_at_start": alloc0["reserved"],
                     "alloc_deltas": {k: alloc1[k] - alloc0[k] for k in alloc1},
                     "loads": cold_run_loads(log, t0, cold, rt, "cold/weights"),
                     "collections_in_cold": [(ms(dt), g) for t, dt, g in collections
                                             if t0 <= t <= t0 + cold.e2e],
                     **({"settle_ms": settled} if settle is not None else {}),
                     "account": cold_account(windows), "host": windows})
        del eng, ctx
        rt.drain()
        rt.shutdown()
        del rt
    gc.callbacks.remove(note)
    return {"system": system, "runs": runs, "launches": counts(),
            "context_launches": ctx_counts(), "context_builds": builds("cold"),
            "declared_context_bytes": fn.context_bytes,
            "weights_bytes": sum(t.numel() * t.element_size()
                                 for t in T.leaves(db.fetch("cold/weights"))),
            **host_pinned(db)}


def cold_account(windows: dict) -> dict:
    """What named the slow first forwards, for one cold request of
    ``cold_runs`` (its ``host_window``s): its build's and its compute's
    wall and thread CPU ms and new device segments (the allocator's
    ``segment.all.allocated`` change), and the forward's host ms to issue
    it whole and its last span (the final norm and the unembedding, where
    a new segment for the logits lands)."""
    out = {}
    for w in windows["cold"]["inside"]:
        out[w["kind"]] = {"wall_ms": w["wall_ms"], "thread_cpu_ms": w["thread_cpu_ms"],
                          "new_segments": w["alloc_deltas"].get("segment.all.allocated", 0)}
        if "host_ms" in w:
            out[w["kind"]].update(issue_ms=w["issue_end_ms"] - w["issue_start_ms"],
                                  unembed_host_ms=w["host_ms"][-1])
    return out


def host_pinned(db) -> dict:
    """Page-locked host bytes: those the database's payloads are views of
    (the weights), the counters of PyTorch's caching pinned allocator
    (which stages the requests' tokens) where it has them, and the sum of
    the first and the allocator's blocks."""
    stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    held = db.page_locked_bytes
    return {"db_page_locked_bytes": held,
            "host_allocator": {k: v for k, v in stats.items()
                               if "bytes" in k or k.startswith("num_host")},
            "page_locked_bytes": held + stats.get("allocated_bytes.current", 0)}


def phase_cold_setup():
    """The full-width qwen2.5-3b served cold COLD_RUNS times under SAGE and
    under FixedGSL (``cold_runs``), each policy in a fresh process of its
    own, so that its first cold request pays what a new worker process
    pays. Prints each cold request's gpu_ctx, gpu_data, compute and e2e,
    their medians, per cold run the context build's time, the device bytes
    allocated at its start, the caching allocator's counters' change over
    it and the weights' copy beside the modelled legs (``cold_run_loads``),
    the build's and the compute's host account (``cold_account``: a new
    device segment inside a compute is what made a fresh process's first
    FixedGSL forward slow), the page-locked host bytes, and SAGE /
    FixedGSL: over all the colds,
    for the first and for the later ones. Checks: every request served,
    cold then warm; one context build and its launches per cold run,
    counted apart from the requests' forwards; every cold request's compute
    within COLD_MAX_OVER_WARM x the policy's warm median (the context
    carries the first forward's shape-only work); the page-locked host
    bytes within COLD_MAX_PAGE_LOCKED x the weights'; the first cold's
    SAGE / FixedGSL under COLD_MAX_FIRST_RATIO and the later colds' median
    at most COLD_MAX_LATER_RATIO. Returns the launches."""
    out, total = {}, dict.fromkeys(KERNELS, 0)
    cfg = ARCHS["qwen2.5-3b"]
    for system in ("sage", "fixedgsl"):
        t0 = time.monotonic()
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--cold-runs", system],
                             capture_output=True, text=True, timeout=600, cwd=str(ROOT))
        check(res.returncode == 0, f"cold_setup {system}: {res.stdout[-2000:]} "
              f"{res.stderr[-4000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        got["seconds"] = time.monotonic() - t0
        out[system] = got
        for name, n in got["launches"].items():
            total[name] += n
    stages = ("gpu_ctx", "gpu_data", "compute")
    summary = {}
    for system, got in out.items():
        colds = [r["cold"] for r in got["runs"]]
        warm = statistics.median(r["warm"]["stages_s"]["compute"] for r in got["runs"])
        summary[system] = {
            "cold_ms": [{**{k: ms(c["stages_s"][k]) for k in stages}, "e2e": ms(c["e2e_s"])}
                        for c in colds],
            "median_ms": {**{k: ms(statistics.median(c["stages_s"][k] for c in colds))
                             for k in stages},
                          "e2e": ms(statistics.median(c["e2e_s"] for c in colds))},
            "warm_compute_median_ms": ms(warm),
            "cold_compute_over_warm": [c["stages_s"]["compute"] / warm for c in colds],
            "context_reserved_bytes": [r["context_reserved_bytes"] for r in got["runs"]],
            "declared_context_bytes": got["declared_context_bytes"],
            "context_builds": got["context_builds"], "launches": got["launches"],
            "context_launches": got["context_launches"], "seconds": got["seconds"],
            "build_ms": [r["context_build_ms"] for r in got["runs"]],
            "collections_in_cold": [r["collections_in_cold"] for r in got["runs"]],
            "cold_account": [r["account"] for r in got["runs"]],
            "allocated_at_start": [r["allocated_at_start"] for r in got["runs"]],
            "alloc_deltas": [r["alloc_deltas"] for r in got["runs"]],
            "loads": [r["loads"] for r in got["runs"]],
            "weights_bytes": got["weights_bytes"],
            "db_page_locked_bytes": got["db_page_locked_bytes"],
            "page_locked_bytes": got["page_locked_bytes"],
            "host_allocator": got["host_allocator"]}
    ratio = summary["sage"]["median_ms"]["e2e"] / summary["fixedgsl"]["median_ms"]["e2e"]
    first = (summary["sage"]["cold_ms"][0]["e2e"] / summary["fixedgsl"]["cold_ms"][0]["e2e"])
    later = (statistics.median(c["e2e"] for c in summary["sage"]["cold_ms"][1:])
             / statistics.median(c["e2e"] for c in summary["fixedgsl"]["cold_ms"][1:]))
    emit({"phase": "cold_setup", "arch": cfg.name, "batch": FULL_BATCH, "seq": FULL_SEQ,
          "time_scale": SERVE_TIME_SCALE, "runs": COLD_RUNS, "systems": summary,
          "sage_over_fixedgsl_median_e2e": ratio,
          "sage_over_fixedgsl_first_cold_e2e": first,
          "sage_over_fixedgsl_later_colds_median_e2e": later})
    for system, got in out.items():
        sm = summary[system]
        check(all(r["cold"]["error"] is None and r["warm"]["error"] is None
                  and r["cold"]["warm_stage"] is None and r["warm"]["warm_stage"] == 1
                  for r in got["runs"]), f"cold_setup {system}: {got['runs']}")
        check(got["context_builds"] == COLD_RUNS
              and got["context_launches"] == warmups(cfg, COLD_RUNS)
              and minus(got["launches"], got["context_launches"])
              == {**dict.fromkeys(KERNELS, 0), fa.NAME: 2 * COLD_RUNS * cfg.num_attn_layers},
              f"cold_setup {system}: launches {got['launches']}, want {2 * COLD_RUNS} "
              f"forwards' besides {got['context_builds']} context builds' "
              f"{got['context_launches']}")
        check(max(sm["cold_compute_over_warm"]) <= COLD_MAX_OVER_WARM,
              f"cold_setup {system}: a cold request's compute is "
              f"{sm['cold_compute_over_warm']} x the warm median")
        check(min(c["gpu_ctx"] for c in sm["cold_ms"]) > 0, f"cold_setup {system}: no context")
        check(0 < sm["page_locked_bytes"] <= COLD_MAX_PAGE_LOCKED * sm["weights_bytes"],
              f"cold_setup {system}: {sm['page_locked_bytes']} page-locked host bytes for "
              f"{sm['weights_bytes']} bytes of weights")
    check(first < COLD_MAX_FIRST_RATIO,
          f"cold_setup: a fresh process's first cold SAGE / FixedGSL e2e is {first}")
    check(later <= COLD_MAX_LATER_RATIO,
          f"cold_setup: the later colds' median SAGE / FixedGSL e2e is {later}")
    return total


# ---------------------------------------------------------------------------
# the rank bodies of the sharded attention and Mamba2 block, on one card
# ---------------------------------------------------------------------------

RANK_TP = 16
RANK_ATTN_ARCH = "phi4-mini-3.8b"   # 24 query heads: they do not divide by 16
RANK_MAMBA_ARCH = "mamba2-780m"     # 48 SSD heads: 3 a rank at 16


def rank_attention():
    """``distributed.local``'s attention split by query rows, as each of
    RANK_TP ranks runs it, one after another on this card: one full-width
    phi4-mini attention layer's q, k, v (bf16, 4 x 1024, causal). The
    ranks' rows put together are held against K1 run whole, their
    gradients (``rank_rows_bwd``, summed) against K1's backward run whole.
    Returns the record and the rank bodies' launches."""
    cfg = ARCHS[RANK_ATTN_ARCH]
    shape = (FULL_BATCH, FULL_SEQ, FULL_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             True)
    q, k, v, _, _, do = attention_bwd_inputs(shape, torch.bfloat16)
    scale = cfg.head_dim ** -0.5
    out = torch.empty_like(q)
    grads = [torch.zeros(t.shape, dtype=torch.float32, device="cuda") for t in (q, k, v)]
    torch.cuda.synchronize()
    reset_counts()  # -- the rank bodies' path starts here
    t0 = time.monotonic()
    for r in range(RANK_TP):
        mine = dlocal.rank_rows(q, k, v, causal=True, scale=scale, use_kernel=True, rank=r,
                                t=RANK_TP)
        for first, rows, o, _ in mine:
            out[:, first:first + rows] = o
        for acc, g in zip(grads, dlocal.rank_rows_bwd(q, k, v, mine, do, causal=True,
                                                      scale=scale, use_kernel=True)):
            acc += g.float()
    torch.cuda.synchronize()
    ranks_s = time.monotonic() - t0
    launches = counts()  # -- and ends here
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    t0 = time.monotonic()
    whole = ops.flash_attention(*ins, causal=True, scale=scale, use_kernel=True)
    whole.backward(do)
    torch.cuda.synchronize()
    whole_s = time.monotonic() - t0
    out_err, out_ok = compare([out], [whole], TOL[torch.bfloat16])
    grad_errs = [(g - t.grad.float()).abs().max().item() for g, t in zip(grads, ins)]
    grad_tols = [grad_tol(torch.bfloat16, t.grad) for t in ins]
    calls = sum(len(dlocal.key_parts(f, c, FULL_SEQ, True))
                for r in dlocal.row_chunks(FULL_SEQ, RANK_TP, True) for f, c in r if c)
    rec = {"arch": cfg.name, "tp": RANK_TP, "shape": list(shape), "dtype": "bfloat16",
           "out_max_abs_err": out_err, "tol": TOL[torch.bfloat16],
           "grad_max_abs_err": dict(zip(("dq", "dk", "dv"), grad_errs)),
           "grad_tol": dict(zip(("dq", "dk", "dv"), grad_tols)), "launches": launches,
           "k1_calls": calls, "ranks_s": ranks_s, "whole_s": whole_s}
    check(out_ok, f"rank attention: the ranks' rows differ from K1 whole by {out_err}")
    check(all(e <= t for e, t in zip(grad_errs, grad_tols)),
          f"rank attention: gradients {grad_errs} past {grad_tols}")
    check(launches == {**dict.fromkeys(KERNELS, 0), fa.NAME: calls, fab.NAME: calls},
          f"rank attention: launches {launches}, want {calls} K1 and K1 backward calls")
    return rec, launches


def rank_mamba():
    """``distributed.local.mamba_mixer``'s rank bodies, one after another on
    this card: one full-width mamba2-780m block (bf16, 4 x 1024), each of
    RANK_TP ranks multiplying its stored in_proj columns, all of them put
    together as the all-gather does, each rank's ``mamba2.gated`` on its
    heads, the sum of squares summed over ranks, each rank's
    ``norm_out``; the partial outputs summed and their gradients held
    against the block run whole (K3 and its backward on all 48 heads).
    Returns the record and the rank bodies' launches."""
    from repro_torch.models import mamba2 as M

    cfg = ARCHS[RANK_MAMBA_ARCH]
    t = RANK_TP
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = M.init_mamba(cfg, gen, "cuda")
    x = torch.randn((FULL_BATCH, FULL_SEQ, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    ct = torch.bfloat16
    dr = cfg.ssm_d_inner // t

    def leaves():
        return {k: v.detach().clone().requires_grad_() for k, v in p.items()}, \
            x.detach().clone().requires_grad_()

    pr, xr = leaves()
    torch.cuda.synchronize()
    reset_counts()  # -- the rank bodies' path starts here
    t0 = time.monotonic()
    w = pr["in_proj"].to(ct)
    c = w.shape[1] // t
    full = torch.cat([xr.to(ct) @ w[:, r * c:(r + 1) * c] for r in range(t)], dim=-1)
    gs = [M.gated(cfg, pr, xr, rank=r, ranks=t,
                  proj=M._take(full, M.own_columns(cfg, r, t), -1))[0] for r in range(t)]
    sumsq = sum(M.sum_squares(g) for g in gs)
    out = sum(M.norm_out(cfg, {**pr, "out_proj": pr["out_proj"][r * dr:(r + 1) * dr]}, g,
                         sumsq, rank=r, ranks=t).float() for r, g in enumerate(gs))
    out.backward(dy.float())
    torch.cuda.synchronize()
    ranks_s = time.monotonic() - t0
    launches = counts()  # -- and ends here
    pw, xw = leaves()
    t0 = time.monotonic()
    whole = M.mixer(cfg, pw, xw)
    whole.backward(dy)
    torch.cuda.synchronize()
    whole_s = time.monotonic() - t0
    out_err, out_ok = compare([out], [whole], TOL[torch.bfloat16])
    names = ["x", *p]
    got = [xr.grad, *(pr[k].grad for k in p)]
    want = [xw.grad, *(pw[k].grad for k in p)]
    grad_errs = {n: (a.float() - b.float()).abs().max().item() for n, a, b in zip(names, got, want)}
    grad_tols = {n: grad_tol(torch.bfloat16, b) for n, b in zip(names, want)}
    rec = {"arch": cfg.name, "tp": t, "shape": [FULL_BATCH, FULL_SEQ, cfg.d_model],
           "dtype": "bfloat16", "out_max_abs_err": out_err,
           "tol": TOL[torch.bfloat16], "grad_max_abs_err": grad_errs, "grad_tol": grad_tols,
           "launches": launches, "ranks_s": ranks_s, "whole_s": whole_s}
    check(out_ok, f"rank mamba: the ranks' summed outputs differ from the block by {out_err}")
    check(all(grad_errs[n] <= grad_tols[n] for n in names),
          f"rank mamba: gradients {grad_errs} past {grad_tols}")
    check(launches == {**dict.fromkeys(KERNELS, 0), ssd.NAME: t, ssdb.NAME: t},
          f"rank mamba: launches {launches}, want {t} K3 and K3 backward calls")
    return rec, launches


def phase_rank_bodies():
    """The rank bodies of the attention split by query rows and of the
    Mamba2 block split by heads (``rank_attention``, ``rank_mamba``).
    Returns their launches."""
    total = dict.fromkeys(KERNELS, 0)
    recs = {}
    for name, fn in (("attention", rank_attention), ("mamba", rank_mamba)):
        t0 = time.monotonic()
        recs[name], launches = fn()
        recs[name]["seconds"] = time.monotonic() - t0
        for k, n in launches.items():
            total[k] += n
    emit({"phase": "rank_bodies", **recs, "launches": total})
    return total


# ---------------------------------------------------------------------------
# the cluster control plane on real memory: crash, drain, chaos, hedging,
# batching
# ---------------------------------------------------------------------------

# the chaos scenario of the JAX package's benchmarks/chaos.py (:42-150),
# word for word: its seed, nodes, breaker, shedding, classes and fault plan
CHAOS_SEED, CHAOS_NODES, CHAOS_WINDOW_S = 29, 4, 5.0
CHAOS_BREAKER = BreakerConfig(failure_threshold=0.5, window=16, min_requests=8,
                              cooldown_s=5.0, half_open_probes=2)
CHAOS_SHEDDING = SheddingConfig(watermark=0.75, hard_watermark=0.97,
                                loose_priority_max=0, saturation=8.0)
CHAOS_CLASSES = {"tight": (6.0, 3.0, 2), "loose": (6.0, 20.0, 0), "flaky": (1.0, None, 0)}
CHAOS_ARCHS = {"tight": "qwen2.5-3b", "loose": "qwen2.5-3b", "flaky": "mamba2-780m"}
TYPED_ERRORS = ("node_lost", "shed", "breaker", "hedged", "data_load", "timeout")
CRASH_AT_LAYER = 12     # crash once K1 has launched for this many of the 36 layers
HEDGE_SLOW_FACTOR, HEDGE_RATE, HEDGE_WINDOW_S = 30.0, 20.0, 3.0


def chaos_plan(duration_s: float, seed: int = CHAOS_SEED) -> FaultPlan:
    """3 of 4 nodes crash early (gpu1 rejoins near the end), the db link
    browns out mid-window, gpu0's db flaps at warm-up, and the ``flaky``
    function's db leg fails half the time."""
    d = duration_s
    return FaultPlan([
        NodeCrash("gpu1", at_s=0.08 * d, restart_after_s=0.87 * d),
        NodeCrash("gpu2", at_s=0.10 * d),
        NodeCrash("gpu3", at_s=0.12 * d),
        LoaderFault("flaky", probability=0.5),
        LinkDegradation(at_s=0.30 * d, duration_s=0.20 * d, factor=0.5, link="db"),
        DbFlap(at_s=0.02 * d, duration_s=0.02 * d, node="gpu0"),
    ], seed=seed)


def settle(cond, timeout=30.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def outcome(fut, rec) -> dict:
    """One request's end: served, or the class of its typed error."""
    exc = fut.exception()
    return {"node": rec.node_id, "warm_stage": rec.warm_stage, "e2e_ms": ms(rec.e2e),
            "stages_ms": {k: ms(v) for k, v in rec.stages.items()},
            "error": rec.error, "error_class": classify_error(rec.error),
            "raised": None if exc is None else type(exc).__name__}


def served_err(db, cfg, rec, weights) -> float:
    """Max |served logits - the direct forward of the same tokens| on the
    card (the served output is the last position's first 8 logits)."""
    toks = db.fetch(f"{rec.function}/in/{rec.request_id}").cuda()
    with torch.inference_mode():
        direct = forward(cfg, weights, {"tokens": toks})[0][:, -1, :8].float().cpu().numpy()
    return float(np.abs(db.fetch(rec.result) - direct).max())


def retire(gw) -> list:
    """Drain every node of a runtime gateway (the exact teardown); returns
    each node's declared usage after it."""
    for n in gw._nodes:
        settle(n.is_idle)
    return [n.drain() for n in gw._nodes]


def control_crash_drain():
    """Part (a): a 2-node ClusterRuntime (locality, eviction) serving the
    full-width qwen2.5-3b, one seed-0 host copy of the weights in the
    nodes' shared database and a device copy per node. A cold and a warm
    request on A (the warm one captures the context's CUDA graph); a third,
    of half the sequence so that its forward runs eagerly, whose forward
    A's crash lands in (K1 has launched for CRASH_AT_LAYER layers); one
    that eviction routes to B; A restored, B drained, one that lands cold on A. Real and declared bytes at every
    step, and the time from the crash until the card's allocated bytes
    fell by 90 % of the weights. Returns the launches and the report."""
    cfg = ARCHS["qwen2.5-3b"]
    base_alloc = freed_memory()[1]
    db = Database(device="cuda")
    cluster = ClusterRuntime(n_nodes=2, dispatch="locality", eviction=True, database=db,
                             time_scale=SERVE_TIME_SCALE, load_timeout_s=120.0,
                             exit_ttl=600.0, device="cuda")
    cluster.sage_init()
    t0 = time.monotonic()
    fn = _model_function(db, "cp", cfg, batch=FULL_BATCH, seq=FULL_SEQ, seed=0)
    init_s = time.monotonic() - t0
    cluster.register_function(lambda i: fn)
    weights = db.size_of("cp/weights")
    pcie_s = weights / cluster.nodes[0].paths.pcie.base_bw * SERVE_TIME_SCALE
    a, b = cluster.nodes
    layers = cfg.num_attn_layers
    steps, runs = [], []

    def mem(step):
        torch.cuda.synchronize()
        gc.collect()
        steps.append({"step": step, "allocated": torch.cuda.memory_allocated(),
                      "A": a.memory_usage(), "B": b.memory_usage()})
        return steps[-1]["allocated"]

    def request(step, seed, seq=FULL_SEQ):
        req = make_request(db, fn, batch=FULL_BATCH, seq=seq, vocab=cfg.vocab_size,
                           seed=seed)
        return req, cluster.submit(req)

    def finish(step, req, fut):
        settle(fut.done, 600.0)
        settle(lambda: a.is_idle() and b.is_idle())
        rec = cluster.telemetry.find(req.uuid)
        runs.append({"step": step, **outcome(fut, rec)})
        return rec

    mem("registered")
    reset_counts()  # -- the crash-and-drain path starts here
    t_path = time.monotonic()
    served = []
    for step, seed in (("cold_on_A", 0), ("warm_on_A", 1)):
        rec = finish(step, *request(step, seed))
        served.append(rec)
        mem(step)

    # the crash, while the third request's forward is in flight: of another
    # shape than the context's, so eager, K1 launched layer by layer
    req, fut = request("crash", 2, seq=FULL_SEQ // 2)
    k1 = fa.launches - F.context_launches[fa.NAME]  # a context build's are not the forward's
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)  # let this thread watch the forward's launches closely
    try:
        check(settle(lambda: fa.launches - F.context_launches[fa.NAME] - k1 >= CRASH_AT_LAYER
                     or fut.done(), 600.0), "the third request never reached its forward")
        at_layer = fa.launches - F.context_launches[fa.NAME] - k1
        done_at_crash = fut.done()
        pre_crash = torch.cuda.memory_allocated()
        t_crash = time.monotonic()
        a.crash("crashed in mid-forward")
        freed = settle(lambda: pre_crash - torch.cuda.memory_allocated() >= 0.9 * weights)
        freed_s = time.monotonic() - t_crash
    finally:
        sys.setswitchinterval(switch)
    crashed = finish("crash", req, fut)
    crash_drop = pre_crash - mem("crash_settled")
    usage_a = a.memory_usage()

    rec = finish("evicted_to_B", *request("evicted_to_B", 3))
    served.append(rec)
    before_drain = mem("evicted_to_B")
    a.restore()
    cluster.drain_node(b.node_id)
    settle(lambda: b.retired)
    drain_drop = before_drain - mem("B_drained")
    rec = finish("cold_on_A_again", *request("cold_on_A_again", 4))
    served.append(rec)
    rise = mem("cold_on_A_again") - (before_drain - drain_drop)
    wall_s = time.monotonic() - t_path
    launches, ctx, n_builds = counts(), ctx_counts(), builds("cp")  # -- and ends here
    usage = a.drain()
    cluster.shutdown()
    after_raw, after = freed_memory()

    on_card = db.to_device(db.fetch("cp/weights"))
    errs = [served_err(db, cfg, r, on_card) for r in served if r.error is None]
    if crashed.error is None:
        errs.append(served_err(db, cfg, crashed, on_card))
    del on_card, cluster, fn, db
    final_raw, final = freed_memory()
    report = {
        "arch": cfg.name, "weights_bytes": weights, "init_s": init_s, "wall_s": wall_s,
        "time_scale": SERVE_TIME_SCALE, "modelled_pcie_leg_ms": ms(pcie_s),
        "requests": runs, "memory": steps,
        "crash": {"k1_layers_launched": at_layer, "of_layers": layers,
                  "landed_in": ("forward" if 0 < at_layer < layers else
                                "setup" if at_layer == 0 else "after the forward's launches"),
                  "request_done_at_crash": done_at_crash,
                  "allocated_before": pre_crash, "freed_bytes": crash_drop,
                  "freed_share_of_weights": crash_drop / weights,
                  "seconds_to_free_90pct": freed_s if freed else None,
                  "A_usage_after": usage_a},
        "drain": {"freed_bytes": drain_drop, "freed_share_of_weights": drain_drop / weights},
        "cold_on_A_again": {"real_copy_bytes": rise, "gpu_data_ms": runs[-1]["stages_ms"]["gpu_data"]},
        "direct_max_abs_err": errs, "launches": launches, "context_launches": ctx,
        "context_builds": n_builds, "usage_after": usage,
        "memory_allocated_before": base_alloc, "memory_allocated_after_shutdown": after_raw,
        "memory_allocated_after_cublas_workspaces_cleared": after,
        "memory_allocated_after_comparisons": final}
    for r in runs:
        check(r["error"] is None or r["error_class"] in TYPED_ERRORS,
              f"control_plane: {r['step']} failed untyped: {r['error']}")
    check([r["error"] for r in runs if r["step"] != "crash"] == [None] * 4,
          f"control_plane: a request off the crash failed: {runs}")
    check(0 < at_layer < layers, f"control_plane: the crash landed after {at_layer} of "
          f"{layers} layers' K1 launches, not in mid-forward")
    check(usage_a == dict.fromkeys(usage_a, 0), f"control_plane: A after the crash {usage_a}")
    check(crash_drop >= 0.9 * weights and freed,
          f"control_plane: the crash freed {crash_drop} of {weights} bytes")
    check([r["node"] for r in runs] == ["gpu0", "gpu0", "gpu0", "gpu1", "gpu0"],
          f"control_plane: nodes {[r['node'] for r in runs]}")
    check(drain_drop >= 0.9 * weights, f"control_plane: draining B freed {drain_drop} bytes")
    check(runs[-1]["warm_stage"] is None and runs[-1]["stages_ms"]["gpu_data"] >= ms(pcie_s)
          and rise >= 0.9 * weights,
          f"control_plane: A's cold request paid no host -> device copy: {runs[-1]}, {rise}")
    check(max(errs) <= 1e-3, f"control_plane: served differs from the direct forward: {errs}")
    check(usage == dict.fromkeys(usage, 0), f"control_plane: teardown {usage}")
    check(after <= base_alloc and final <= base_alloc,
          f"control_plane: device memory not freed: {after}, {final} > {base_alloc}")
    want = {**dict.fromkeys(KERNELS, 0), fa.NAME: 5 * layers}
    check(n_builds >= 2 and ctx == warmups(cfg, n_builds) and minus(launches, ctx) == want,
          f"control_plane: crash-and-drain launches {launches}, want {want} besides "
          f"{n_builds} context builds' {ctx} (A's and B's at least)")
    return launches, report


def control_chaos():
    """Part (b): the reference's quick chaos scenario, hardened, on a
    4-node runtime gateway on the card; tight and loose serve the reduced
    qwen2.5-3b (K1), flaky the reduced mamba2-780m (K3), each keeping the
    scenario's declared bytes. Returns the launches and the report."""
    base_alloc = freed_memory()[1]
    gw = Gateway(backend="runtime", n_nodes=CHAOS_NODES, seed=CHAOS_SEED,
                 faults=chaos_plan(CHAOS_WINDOW_S), eviction=True, breaker=CHAOS_BREAKER,
                 shedding=CHAOS_SHEDDING, device="cuda")
    for name in sorted(CHAOS_CLASSES):
        gw.register(FunctionSpec(name=name, arch=CHAOS_ARCHS[name], read_only_bytes=24 << 20,
                                 writable_bytes=4 << 20, context_bytes=16 << 20,
                                 compute_ms=10.0))
    scale = 120.0 / CHAOS_WINDOW_S / 10.0
    classes = {f: (r * scale, dl, pr) for f, (r, dl, pr) in CHAOS_CLASSES.items()}
    workload = ChaosWorkload(classes, CHAOS_WINDOW_S, seed=CHAOS_SEED)
    reset_counts()  # -- the chaos path starts here
    t0 = time.monotonic()
    tel = gw.replay(workload, pace=1.0, timeout=120.0)
    wall_s = time.monotonic() - t0
    launches, ctx = counts(), ctx_counts()  # -- and ends here
    stats = gw.resilience_stats()
    recs = [r for r in tel.snapshot() if not r.dropped]
    dead = {n.node_id: n.memory_usage() for n in gw._nodes if not n.healthy}
    errs = {}
    for name in sorted(CHAOS_CLASSES):
        rec = next((r for r in recs if r.function == name and r.error is None
                    and r.redispatches == 0), None)
        if rec is None:
            continue
        node = next(n for n in gw._nodes if n.node_id == rec.node_id)
        cfg = ARCHS[CHAOS_ARCHS[name]].reduced()
        weights = node.db.to_device(node.db.fetch(f"{name}/weights"))
        errs[name] = served_err(node.db, cfg, rec, weights)
        del weights
    usage = retire(gw)
    gw.shutdown()
    del gw
    after_raw, after = freed_memory()
    report = {
        "window_s": CHAOS_WINDOW_S, "wall_s": wall_s, "arrivals": len(recs),
        "served": sum(r.error is None for r in recs),
        "goodput": 1.0 - tel.slo_miss_rate(), "error_counts": tel.error_counts(),
        "slo_by_priority": {p: c["attainment"] for p, c in sorted(tel.slo_by_priority().items())},
        "resilience": stats, "dead_nodes_usage": dead, "direct_max_abs_err": errs,
        "launches": launches, "context_launches": ctx, "usage_after": usage, "memory_allocated_before": base_alloc,
        "memory_allocated_after_shutdown": after_raw,
        "memory_allocated_after_cublas_workspaces_cleared": after}
    check(stats["node_crashes"] == 3, f"chaos: {stats['node_crashes']} node crashes")
    untyped = [r.error for r in recs
               if r.error is not None and classify_error(r.error) not in TYPED_ERRORS]
    check(not untyped, f"chaos: untyped failures {untyped[:3]}")
    check(all(u == dict.fromkeys(u, 0) for u in dead.values()), f"chaos: dead nodes {dead}")
    check(set(errs) == set(CHAOS_CLASSES) and max(errs.values()) <= TOL[torch.float32],
          f"chaos: served outputs against the direct forward {errs}")
    fwd = minus(launches, ctx)
    check(fwd[fa.NAME] > 0 and fwd[ssd.NAME] > 0,
          f"chaos: launches {launches}, the context's {ctx}")
    check(after <= base_alloc, f"chaos: device memory not freed: {after} > {base_alloc}")
    return launches, report


def control_hedge_batch():
    """Part (c): two 2-node runtime gateways on the card over the reduced
    qwen2.5-3b. Hedging: gpu1 slowed HEDGE_SLOW_FACTOR times (SlowNode),
    random dispatch, Poisson arrivals at HEDGE_RATE for HEDGE_WINDOW_S;
    every loser ends hedged, never as an error. Batching: shared compute, max_batch 4, a burst of 4
    simultaneous arrivals forms one batch (one grant of the modelled
    stacked launch) while each member runs its own forward, so K1 launches
    4 x the forward's. Returns the launches and the report."""
    cfg = ARCHS["qwen2.5-3b"].reduced()
    spec = FunctionSpec(name="h", arch="qwen2.5-3b", profile="seq2seq")
    base_alloc = freed_memory()[1]
    gw = Gateway(backend="runtime", n_nodes=2, seed=6, time_scale=SERVE_TIME_SCALE,
                 dispatch="random", faults=FaultPlan([SlowNode("gpu1", at_s=0.0,
                                                               factor=HEDGE_SLOW_FACTOR)], seed=6),
                 hedging=dict(min_samples=6, hedge_quantile=0.9), device="cuda")
    gw.register(spec)
    reset_counts()  # -- the hedging path starts here
    t0 = time.monotonic()
    tel = gw.replay(PoissonWorkload("h", HEDGE_RATE, HEDGE_WINDOW_S, seed=6), timeout=60.0)
    hedge_s = time.monotonic() - t0
    hedge_launches, hedge_ctx = counts(), ctx_counts()  # -- and ends here
    stats = gw.resilience_stats()
    recs = tel.snapshot()
    losers = [r for r in recs if r.dropped]
    kept = [r for r in recs if not r.dropped]
    hedge_usage = retire(gw)
    gw.shutdown()
    del gw
    hedge_after = freed_memory()[1]
    check(stats["hedges_launched"] >= 1, f"hedging: no hedge fired {stats}")
    check(len(losers) == stats["hedges_won"] + stats["hedges_wasted"]
          == stats["hedges_launched"], f"hedging: {len(losers)} losers for {stats}")
    check(all(r.error_class == "hedged" for r in losers), "hedging: a loser is not 'hedged'")
    check(all(r.error is None for r in kept), f"hedging: {[r.error for r in kept if r.error]}")
    check(all(u == dict.fromkeys(u, 0) for u in hedge_usage), f"hedging: leaked {hedge_usage}")
    check(hedge_after <= base_alloc, f"hedging: device memory not freed: {hedge_after}")

    gw = Gateway(backend="runtime", n_nodes=2, seed=3, time_scale=SERVE_TIME_SCALE,
                 dispatch="locality", compute={"mode": "shared", "max_batch": 4,
                                               "batch_window_s": 0.5}, device="cuda")
    gw.register(FunctionSpec(name="b", arch="qwen2.5-3b", profile="seq2seq"))
    reset_counts()  # -- the batching path starts here
    t0 = time.monotonic()
    tel = gw.replay(TraceWorkload([Arrival(0.0, "b") for _ in range(4)]), timeout=60.0)
    batch_s = time.monotonic() - t0
    batch_launches, batch_ctx, batch_builds = counts(), ctx_counts(), builds("b")  # -- and ends here
    cstats = gw.compute_stats()
    recs = [r for r in tel.snapshot() if not r.dropped]
    node = next(n for n in gw._nodes if n.node_id == recs[0].node_id)
    weights = node.db.to_device(node.db.fetch("b/weights"))
    errs = [served_err(node.db, cfg, r, weights) for r in recs if r.error is None]
    del weights
    batch_usage = retire(gw)
    gw.shutdown()
    del gw
    after_raw, after = freed_memory()
    per_forward = forward_launches(cfg)
    report = {
        "hedging": {"slow_factor": HEDGE_SLOW_FACTOR, "arrivals": len(kept), "wall_s": hedge_s,
                    "stats": stats, "losers": [{"node": r.node_id, "error": r.error}
                                               for r in losers],
                    "e2e_p99_ms": ms(max(r.e2e for r in kept)), "launches": hedge_launches,
                    "context_launches": hedge_ctx,
                    "usage_after": hedge_usage, "memory_allocated_after": hedge_after},
        "batching": {"wall_s": batch_s, "compute_stats": cstats,
                     "batch_sizes": [r.batch_size for r in recs],
                     "nodes": [r.node_id for r in recs], "direct_max_abs_err": errs,
                     "launches": batch_launches, "context_launches": batch_ctx,
                     "context_builds": batch_builds,
                     "k1_per_forward": per_forward[fa.NAME], "usage_after": batch_usage},
        "memory_allocated_before": base_alloc, "memory_allocated_after_shutdown": after_raw,
        "memory_allocated_after_cublas_workspaces_cleared": after}
    ids = {r.request_id for r in recs}
    check(len(recs) == 4 and all(r.error is None and r.batch_size == 4
                                 and set(r.batched_with) == ids - {r.request_id}
                                 for r in recs), f"batching: records {report['batching']}")
    check(cstats["batches"] == 1 and cstats["batched"] == 4 and cstats["grants"] == 1,
          f"batching: compute_stats {cstats}")
    check(len(errs) == 4 and max(errs) <= TOL[torch.float32],
          f"batching: served against the direct forward {errs}")
    check(batch_builds == 1 and batch_ctx == warmups(cfg, 1)
          and minus(batch_launches, batch_ctx) == {n: 4 * c for n, c in per_forward.items()},
          f"batching: launches {batch_launches}, want 4 x {per_forward} besides "
          f"{batch_builds} context builds' {batch_ctx}")
    check(all(u == dict.fromkeys(u, 0) for u in batch_usage), f"batching: leaked {batch_usage}")
    check(after <= base_alloc, f"batching: device memory not freed: {after} > {base_alloc}")
    return {n: hedge_launches[n] + batch_launches[n] for n in KERNELS}, report


def phase_control_plane():
    """The cluster control plane on the card with real tensors: (a) crash
    and drain at full width on real memory, (b) the hardened chaos
    scenario over reduced model functions, (c) hedging and shared-compute
    batching over the reduced qwen2.5-3b. Each part sets the counts to 0
    just before it drives its path and reads them just after; returns the
    launches over the three."""
    t0 = time.monotonic()
    total, parts = dict.fromkeys(KERNELS, 0), {}
    for part, fn in (("crash_drain", control_crash_drain), ("chaos", control_chaos),
                     ("hedge_batch", control_hedge_batch)):
        t = time.monotonic()
        launches, parts[part] = fn()
        parts[part]["seconds"] = time.monotonic() - t
        for name, n in launches.items():
            total[name] += n
    emit({"phase": "control_plane", **parts, "launches": total,
          "seconds": time.monotonic() - t0})
    return total


def profiled(fn, by_op=False):
    """Run ``fn`` once under torch.profiler; returns (its result, the
    device-busy ms summed over kernels and copies, the host wall ms of the
    profiled run and the six largest device-time entries; with ``by_op``
    also the operators of ``BY_OP`` by input shapes, with the device time
    of the kernels each launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_op) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # kernels, copies and sets run on the device; CPU ops only launch them
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    ours = {}  # the port's kernels by their CUDA function names
    for e in events:
        for tag in PORT_KERNEL_NAMES:
            if tag in e.key:
                ours[tag] = ours.get(tag, 0.0) + e.self_device_time_total / 1e3
    res = {"device_busy_ms": busy_ms, "profiled_wall_ms": wall_ms,
           "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
           "port_kernels_ms": ours}
    if by_op:
        rows = [[e.key, str(e.input_shapes)[:200], e.device_time_total / 1e3, e.count]
                for e in prof.key_averages(group_by_input_shape=True) if e.key in BY_OP]
        res["by_op"] = sorted(rows, key=lambda r: -r[2])[:16]
    return out, res


# the operators whose device time the MoE breakdown reads, by input shapes:
# the batched products under the FFN's einsums (dispatch, combine, the
# expert GEMMs, the one-hot products), the dense projections (``@``), the
# router's sort and the slot count's scan
BY_OP = ("aten::bmm", "aten::matmul", "aten::sort", "aten::cumsum")


def generate(cfg, params, prompt, steps, profile_it=False, extra=None, enc_len=0):
    """Prefill then ``steps`` greedy decode steps through the serving step
    factories (``extra``: batch entries besides the tokens, such as
    whisper's encoder embeddings, whose length is ``enc_len``). Returns
    (the logits of the prefill and of every step, the fed-back tokens,
    per-step ms, prefill ms, launch counts of the prefill and of the decode
    loop, and with ``profile_it`` a profiler breakdown of a repeated
    prefill (it rewrites the same cache entries) and of the last step)."""
    B, S = prompt.shape
    batch = {"tokens": prompt, **(extra or {})}
    prefill_step, decode = make_prefill_step(cfg), make_decode_step(cfg)
    cache = init_cache(cfg, B, S + steps, enc_len)
    torch.cuda.synchronize()
    reset_counts()  # -- the prefill path starts here
    t0 = time.monotonic()
    logits, cache = prefill_step(params, batch, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    prefill_counts = counts()  # -- and ends here
    prof = {}
    if profile_it:
        _, prof["prefill"] = profiled(lambda: prefill_step(params, batch, cache))
    outs, fed, step_ms = [logits], [], []
    positions = torch.full((B,), S, dtype=torch.int32, device=prompt.device)
    reset_counts()  # -- the decode path starts here
    for i in range(steps):
        nxt = greedy_sample(outs[-1])
        fed.append(nxt)
        step = lambda: decode(params, nxt[:, None], positions, cache)  # noqa: E731
        if profile_it and i == steps - 1:
            (logits, cache), prof["decode_step"] = profiled(step)
        else:
            t0 = time.monotonic()
            logits, cache = step()
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
        outs.append(logits)
        positions = positions + 1
    decode_counts = counts()  # -- and ends here
    return (outs, torch.stack(fed, dim=1), step_ms, prefill_ms, prefill_counts,
            decode_counts, prof)


def decode_errors(cfg, params, prompt, outs, fed, extra=None):
    """Each logit row of ``generate`` against the full forward over the
    prompt plus the fed-back tokens at that position (causal: one forward
    gives every position). Returns per-position max |err| and max |logit|."""
    tokens = torch.cat([prompt, fed], dim=1)
    full = forward(cfg, params, {"tokens": tokens, **(extra or {})})[0]
    S = prompt.shape[1]
    errs, scale = [], []
    for i, lg in enumerate(outs):
        ref = full[:, S - 1 + i]
        errs.append((lg.float() - ref).abs().max().item())
        scale.append(ref.abs().max().item())
    del full
    return errs, scale


def encoder_embeds(cfg, batch, frames, seed=0):
    """Frame embeddings (B, frames, d_model) in the compute dtype, standing
    in for whisper's stride-2 conv frontend (which the repo stubs)."""
    x = np.random.default_rng(seed).standard_normal((batch, frames, cfg.d_model),
                                                    dtype=np.float32)
    return torch.from_numpy(x).to("cuda", getattr(torch, cfg.compute_dtype))


def phase_decode(arch, kernel_paths, phase="decode", path="", prompt_len=FULL_SEQ):
    """The serving steps of ``arch`` at full width (bf16, seed 0): prefill
    4 x ``prompt_len`` (whisper: with 1500 encoder frames), then 32 greedy
    steps; then the same check in fp32 at the reduced config (B 2, prompt
    16, 8 steps: tests/test_models.py's). MoE configs run drop-free
    (DROP_FREE_CAPACITY), and a profiled prefill at the served capacity
    splits the time by operator. Launches add to ``kernel_paths`` under
    ``path + "prefill"`` and ``path + "decode"``."""
    cfg = served = ARCHS[arch]
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=DROP_FREE_CAPACITY)
    enc_len = WHISPER_FRAMES if cfg.is_encoder_decoder else 0
    gc.collect()
    base_alloc = torch.cuda.memory_allocated()
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        rng = np.random.default_rng(5)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FULL_BATCH, prompt_len),
                                               dtype=np.int32)).cuda()
        extra = {"encoder_embeds": encoder_embeds(cfg, FULL_BATCH, enc_len)} if enc_len else {}
        outs, fed, step_ms, prefill_ms, pre_counts, dec_counts, prof = generate(
            cfg, params, prompt, DECODE_STEPS, profile_it=True, extra=extra, enc_len=enc_len)
        errs, scale = decode_errors(cfg, params, prompt, outs, fed, extra)
        if cfg.num_experts:  # the prefill as served: capacity 1.25, drops and all
            cache = init_cache(served, FULL_BATCH, prompt_len)
            _, prof["prefill_served_capacity"] = profiled(
                lambda: prefill(served, params, {"tokens": prompt}, cache), by_op=True)
            del cache
        del params, outs
        rcfg = cfg.reduced()
        rparams = init_params(rcfg, torch.Generator("cuda").manual_seed(1), "cuda")
        rtoks = torch.from_numpy(np.random.default_rng(2).integers(
            0, rcfg.vocab_size, (2, 24), dtype=np.int32)).cuda()
        rextra = {"encoder_embeds": encoder_embeds(rcfg, 2, 12)} if enc_len else {}
        routs, rfed = generate(rcfg, rparams, rtoks[:, :16], 8, extra=rextra,
                               enc_len=12 if enc_len else 0)[:2]
        rfull = forward(rcfg, rparams, {"tokens": torch.cat([rtoks[:, :16], rfed], 1),
                                        **rextra})[0]
        r_ok, r_err = True, 0.0
        for i, lg in enumerate(routs):
            ref = rfull[:, 15 + i]
            d = (lg - ref).abs()
            r_err = max(r_err, d.max().item())
            r_ok = r_ok and bool((d <= 2e-3 + 1e-3 * ref.abs()).all().item())
        del rparams, rfull, extra
    gc.collect()
    torch.cuda.empty_cache()
    rel = [e / s for e, s in zip(errs, scale)]
    want_pre = forward_launches(cfg)
    cross = cfg.num_layers if cfg.is_encoder_decoder else 0
    want_dec = {**dict.fromkeys(KERNELS, 0),
                dec.NAME: DECODE_STEPS * (cfg.num_attn_layers + cross)}
    emit({"phase": phase, "arch": cfg.name, "batch": FULL_BATCH, "prompt": prompt_len,
          "encoder_frames": enc_len, "moe_capacity_factor": cfg.moe_capacity_factor,
          "steps": DECODE_STEPS, "prefill_ms": prefill_ms, "step_ms": step_ms,
          "step_ms_median": statistics.median(step_ms), "profile": prof,
          "decode_step_device_idle_share":
              1 - prof["decode_step"]["device_busy_ms"] / statistics.median(step_ms),
          "prefill_launches": pre_counts, "decode_launches": dec_counts,
          "decode_launches_per_step": {n: c / DECODE_STEPS for n, c in dec_counts.items()},
          "max_abs_err_vs_forward": errs, "max_abs_logit": scale,
          "max_rel_err": max(rel), "tol_rel_bf16": DECODE_TOL_BF16,
          "reduced_fp32_max_abs_err": r_err, "reduced_fp32_tol": [2e-3, 1e-3],
          "memory_allocated_after": torch.cuda.memory_allocated(),
          "memory_allocated_before": base_alloc})
    check(pre_counts == want_pre, f"{arch} prefill launches {pre_counts} != {want_pre}")
    check(dec_counts == want_dec, f"{arch} decode launches {dec_counts} != {want_dec}")
    check(all(np.isfinite(e) for e in errs), f"{arch} decode logits not finite")
    check(max(rel) <= DECODE_TOL_BF16, f"{arch} decode differs from the forward: {max(rel)}")
    check(r_ok, f"{arch} reduced fp32 decode differs from the forward: {r_err}")
    for name in KERNELS:
        kernel_paths[name][path + "prefill"] += pre_counts[name]
        kernel_paths[name][path + "decode"] += dec_counts[name]


def whisper_reduced():
    """The reduced whisper (fp32) through prefill and 8 greedy decode steps
    on the card against the same steps on the CPU (plain versions), within
    1e-4; the CPU's greedy tokens feed both. Returns the card's launches."""
    cfg = ARCHS["whisper-small"].reduced()
    B, S, steps, enc_len = 2, 16, 8, 12
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    on_card = Database(device="cuda").to_device(params)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                                     dtype=np.int32)),
             "encoder_embeds": torch.from_numpy(
                 rng.standard_normal((B, enc_len, cfg.d_model), dtype=np.float32))}
    errs = []
    with torch.inference_mode():
        cpu_cache = init_cache(cfg, B, S + steps, enc_len, device="cpu")
        cache = init_cache(cfg, B, S + steps, enc_len, device="cuda")
        want, _, _ = prefill(cfg, params, batch, cpu_cache)
        reset_counts()  # -- the reduced whisper's path starts here
        got, _, _ = prefill(cfg, on_card, {k: v.cuda() for k, v in batch.items()}, cache)
        errs.append((got.cpu() - want).abs().max().item())
        for t in range(S, S + steps):
            nxt = greedy_sample(want)[:, None]
            pos = torch.full((B,), t, dtype=torch.int32)
            want, _ = decode_step(cfg, params, nxt, pos, cpu_cache)
            got, _ = decode_step(cfg, on_card, nxt.cuda(), pos.cuda(), cache)
            errs.append((got.cpu() - want).abs().max().item())
        launches = counts()  # -- and ends here
    want_launches = {**forward_launches(cfg), dec.NAME: steps * 2 * cfg.num_layers}
    emit({"phase": "zoo_reduced", "arch": cfg.name, "check": "prefill_decode_vs_cpu",
          "steps": steps, "encoder_frames": enc_len, "launches": launches,
          "max_abs_err_vs_cpu": errs, "tol": 1e-4})
    check(launches == want_launches, f"reduced whisper launches {launches} != {want_launches}")
    check(max(errs) <= 1e-4, f"reduced whisper on the card differs from the CPU: {errs}")
    return launches


def phase_zoo_reduced():
    """The five families new to the port, reduced and in fp32 on the card:
    MoE, hybrid and M-RoPE served through SageRuntime, whisper through the
    serving steps. Returns the launches by kernel, summed."""
    total = dict.fromkeys(KERNELS, 0)
    for arch in ("olmoe-1b-7b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
                 "qwen2-vl-72b"):
        for name, n in phase_reduced("zoo_reduced", arch).items():
            total[name] += n
    for name, n in whisper_reduced().items():
        total[name] += n
    return total


def decode_past_cache():
    """A decode step at a position past the cache's length (reduced
    qwen2.5-3b, fp32, max_len 4): the write is dropped on the card with no
    device-side assert, the logits are the CPU path's within 3e-5 and the
    cache is unchanged; a normal step afterwards agrees too. A comparison,
    not a path: its launches are not counted."""
    cfg = ARCHS["qwen2.5-3b"].reduced()
    B, max_len = 2, 4
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    on_card = Database(device="cuda").to_device(params)
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, max_len), dtype=np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32))
    with torch.inference_mode():
        _, cpu_cache, _ = prefill(cfg, params, {"tokens": prompt},
                                  init_cache(cfg, B, max_len, device="cpu"))
        _, cache, _ = prefill(cfg, on_card, {"tokens": prompt.cuda()},
                              init_cache(cfg, B, max_len, device="cuda"))
        before = {k: {n: t.clone() for n, t in e.items()} for k, e in cache.items()}
        errs = []
        for pos in ([max_len] * B, [max_len - 1, 1]):  # dropped, then written
            pos = torch.tensor(pos, dtype=torch.int32)
            want, _ = decode_step(cfg, params, nxt, pos, cpu_cache)
            got, _ = decode_step(cfg, on_card, nxt.cuda(), pos.cuda(), cache)
            torch.cuda.synchronize()
            errs.append((got.cpu() - want).abs().max().item())
            if len(errs) == 1:
                unchanged = all(torch.equal(t, before[k][n])
                                for k, e in cache.items() for n, t in e.items())
    emit({"phase": "decode", "check": "past_cache", "arch": cfg.name, "max_len": max_len,
          "positions": [[max_len] * B, [max_len - 1, 1]], "max_abs_err_vs_cpu": errs,
          "tol": 3e-5, "cache_unchanged_by_dropped_write": unchanged})
    check(unchanged, "a decode step past the cache wrote into it")
    check(max(errs) <= 3e-5, f"decode past the cache differs from the CPU: {errs}")



# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2.5-3b"
MAMBA_TRAIN_ARCH = "mamba2-780m"
JAMBA_ARCH = "jamba-1.5-large-398b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 10
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 2, 128, True)  # K1 at the train step
# the JAX train_loop's schedule for 10 steps: warm-up max(steps // 10, 1)
TRAIN_OPT = OptimizerConfig(lr=1e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                            total_steps=TRAIN_STEPS)
GEMM_TAGS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")  # cuBLAS's kernel names


# the bf16 kernels against ref.flash_attention_bwd_bf16 (the same roundings
# of P and dS), per output: tests/test_torch_cuda.py's BF16_SAME_ROUNDING_TOL
# * max|g|, one bf16 ulp of the largest gradient (2^-7) and the sums' order
BF16_SAME_ROUNDING_TOL = 1e-2


def grad_tol(dtype, want):
    """The gradient tolerance, per output: 1e-4 * max(1, max|g|) in fp32,
    2e-2 * max|g| in bf16 (bf16 rounds the inputs of every product)."""
    m = want.float().abs().max().item()
    return 2e-2 * m if dtype == torch.bfloat16 else 1e-4 * max(1.0, m)


def attention_bwd_inputs(shape, dtype, seed=0):
    """q, k, v, dO from a seed, and the forward kernel's output and
    log-sum-exp for them."""
    B, Sq, Sk, Hq, Hkv, Dh, causal = shape
    q, k, v = inputs(shape, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal((B, Sq, Hq, Dh), dtype=np.float32)).to(
        "cuda", dtype)
    o, lse = fa._forward(q, k, v, causal, 1.0 / Dh ** 0.5, with_lse=True)
    return q, k, v, o, lse, do


def phase_kernels_bwd():
    """K1's backward kernel against the plain backward (the same q, k, v,
    output and dO; the plain log-sum-exp) at the sweep and the serving and
    training shapes, fp32 and bf16; bf16 also against the plain version of
    its own roundings and bit for bit against a second call; the forward
    kernel's log-sum-exp against the plain one; then device time at the
    training shape, the whole and each bf16 kernel alone."""
    results, worst, t0 = [], 0.0, time.monotonic()
    cases = [(s, d) for s in (*REF_SHAPES, REDUCED_SHAPE, TRAIN_SHAPE, *ZOO_SHAPES)
             for d in (torch.float32, torch.bfloat16)]
    for shape, dtype in cases:
        causal = shape[-1]
        args = attention_bwd_inputs(shape, dtype)
        q, k, v, o, lse, do = args
        grads = fab.flash_attention_bwd(*args, causal=causal)
        torch.cuda.synchronize()
        plain_lse = ref.attention_lse(q, k, causal=causal)
        lse_err = (lse - plain_lse).abs().max().item()
        plains = ref.flash_attention_bwd(q, k, v, o, plain_lse, do, causal=causal)
        errs, ok = [], lse_err <= 1e-4 * (1 + plain_lse.abs().max().item())
        for g, w in zip(grads, plains):
            err = (g.float() - w.float()).abs().max().item()
            errs.append(err)
            ok = ok and err <= grad_tol(dtype, w) and bool(torch.isfinite(g).all().item())
        case = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
                "max_abs_err_dq_dk_dv": errs, "lse_max_abs_err": lse_err}
        if dtype == torch.bfloat16:
            same = ref.flash_attention_bwd_bf16(*args, causal=causal)
            rel = [(g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                   for g, w in zip(grads, same)]
            again = fab.flash_attention_bwd(*args, causal=causal)
            bits = all(torch.equal(a, b) for a, b in zip(grads, again))
            case.update(rel_err_vs_bf16_plain=rel, bit_equal_second_call=bits)
            ok = ok and max(rel) <= BF16_SAME_ROUNDING_TOL and bits
            del same, again
        case["ok"] = ok
        results.append(case)
        check(ok, f"flash_attention_bwd disagrees at {shape} {dtype}: {case}")
        worst = max(worst, *errs)
        del args, q, k, v, o, lse, do, grads, plains
    emit({"phase": "kernels", "kernel": fab.NAME, "cases": results,
          "tol": "1e-4 * max(1, max|g|) fp32, 2e-2 * max|g| bf16, per output; bf16 "
          f"against its own roundings {BF16_SAME_ROUNDING_TOL} * max|g|, and bit-equal "
          "across two calls", "seconds": time.monotonic() - t0})
    t0 = time.monotonic()

    dtype = torch.bfloat16
    args = attention_bwd_inputs(TRAIN_SHAPE, dtype)
    q, k, v, o, lse, do = args
    G = TRAIN_SHAPE[3] // TRAIN_SHAPE[4]
    # the yardstick: SDPA's forward+backward minus its forward, GQA expanded
    # outside the timed calls
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot)

    def lib_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, is_causal=True)

    kern = lambda: fab.flash_attention_bwd(*args, causal=True)  # noqa: E731
    plain = lambda: ref.flash_attention_bwd(*args, causal=True)  # noqa: E731
    # each bf16 kernel alone, on one call's scratch and outputs (filled first)
    bufs = (fab.new_scratch(q), torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    fab.launch_parts(sum(fab.PARTS.values()), *args, *bufs, causal=True)
    parts = {name: functools.partial(fab.launch_parts, bit, *args, *bufs, causal=True)
             for name, bit in fab.PARTS.items()}
    for fn in (kern, plain, lib_fwd_bwd, lib_fwd, *parts.values()):  # first calls (SDPA's
        fn()                                   # backward sets itself up) before time_ms
    torch.cuda.synchronize()                   # sizes its sleep
    timing = {
        "plain_ms": time_ms(plain, reps=3, inner=3),
        "ms": time_ms(kern),
        "library_fwd_bwd_ms": time_ms(lib_fwd_bwd),
        "library_fwd_ms": time_ms(lib_fwd),
    }
    timing["library_ms"] = timing["library_fwd_bwd_ms"] - timing["library_fwd_ms"]
    timing["ms_again"] = time_ms(kern)
    timing["parts_ms"] = {name: time_ms(fn) for name, fn in parts.items()}
    bound_ms, bound_by, flops, nbytes = attention_bwd_bound_ms(TRAIN_SHAPE, dtype)
    fwd_flops = attention_bound_ms(TRAIN_SHAPE, dtype)[2]
    emit({"phase": "kernel_timing", "kernel": fab.NAME, "shape": list(TRAIN_SHAPE),
          "dtype": "bfloat16", **timing, "bound_ms": bound_ms, "bound_by": bound_by,
          "flops": flops, "bytes": nbytes, "executed_flops": 3.5 * fwd_flops,
          "library": "scaled_dot_product_attention forward+backward minus its forward, "
          "GQA expanded outside the timed call", "tflops": flops / timing["ms"] / 1e9,
          "seconds": time.monotonic() - t0})
    del args, q, k, v, o, lse, do, qt, kt, vt, bufs, parts
    return {"max_abs_err": worst, **timing, "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": list(TRAIN_SHAPE)}


def step_breakdown(cfg, state, batch):
    """One step's device time by part: the forward and backward
    (``_value_and_grad``) profiled, split by kernel name into K1 forward,
    K1 backward, K3 forward, K3 backward, K3's state pass (which both
    launch), GEMMs and the rest (elementwise, reductions, copies), then the
    AdamW update profiled alone. K3's C B^T and chunk-state kernels run once
    in each forward call and once in each bf16 backward call, at the same
    shapes, so their time is split between the two by calls; the state
    pass runs once in a forward and twice in a backward, which gives K3
    backward's share of the device time with its passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    parts = dict.fromkeys(("k1_forward", "k1_backward", "k3_forward", "k3_backward",
                           "k3_state_pass", "gemm", "elementwise_other", "optimizer"), 0.0)
    shared = 0.0
    torch.cuda.synchronize()
    calls = (ssd.launches, ssdb.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        metrics, grads = _value_and_grad(cfg, state["params"], batch)
        torch.cuda.synchronize()
        fb_wall = time.monotonic() - t0
    n_fwd, n_bwd = ssd.launches - calls[0], ssdb.launches - calls[1]
    events = [e for e in prof.key_averages()  # one pass over the trace: it is long
              if e.device_type == DeviceType.CUDA]
    for e in events:
        if e.self_device_time_total <= 0:
            continue
        t = e.self_device_time_total / 1e3
        name = e.key.lower()
        if any(tag in e.key for tag in K1_FWD_NAMES):
            parts["k1_forward"] += t
        elif any(tag in e.key for tag in K1_BWD_NAMES):
            parts["k1_backward"] += t
        elif any(tag in e.key for tag in K3_BWD_NAMES):
            parts["k3_backward"] += t
        elif any(tag in e.key for tag in K3_SHARED_NAMES) and n_bwd:
            shared += t
        elif K3_PASS_NAME in e.key:
            parts["k3_state_pass"] += t
        elif any(tag in e.key for tag in K3_FWD_NAMES):
            parts["k3_forward"] += t
        elif any(tag in name for tag in GEMM_TAGS):
            parts["gemm"] += t
        else:
            parts["elementwise_other"] += t
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    grads = T.unflatten(state["params"], grads)
    _, opt_prof = profiled(lambda: adamw_update(TRAIN_OPT, grads, state["opt"], state["params"]))
    parts["optimizer"] = opt_prof["device_busy_ms"]
    if n_bwd:
        parts["k3_forward"] += shared * n_fwd / (n_fwd + n_bwd)
        parts["k3_backward"] += shared * n_bwd / (n_fwd + n_bwd)
    k3_bwd_all = parts["k3_backward"] + (
        parts["k3_state_pass"] * 2 * n_bwd / (n_fwd + 2 * n_bwd) if n_bwd else 0.0)
    busy = sum(parts.values())
    del grads
    return {"device_ms": parts, "device_busy_ms": busy, "k3_calls": [n_fwd, n_bwd],
            "k3_backward_with_passes_ms": k3_bwd_all,
            "k3_backward_share_of_device": k3_bwd_all / busy if busy else 0.0,
            "forward_backward_wall_ms": fb_wall * 1e3,
            "optimizer_wall_ms": opt_prof["profiled_wall_ms"],
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
            "loss": float(metrics["loss"])}


def phase_train(arch, phase):
    """``arch`` trained at full width: 10 steps of ``make_train_step`` on
    the pipeline's 4 x 1024 batches (the main path: counts reset just
    before, read just after), then one more step profiled by part.
    Returns the launches by kernel."""
    cfg = ARCHS[arch]
    check(cfg.param_dtype == cfg.compute_dtype == "bfloat16", "full width is bf16")
    check(cfg.remat_policy == "nothing_saveable", f"remat {cfg.remat_policy}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    state = init_train_state(cfg, TRAIN_OPT, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    state_bytes = sum(t.numel() * t.element_size() for t in
                      (*T.leaves(state["params"]), *T.leaves(state["opt"])))
    data = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    step = make_train_step(cfg, TRAIN_OPT)
    losses, gnorms, step_s, per_step = [], [], [], []
    torch.cuda.synchronize()
    reset_counts()  # -- the train path starts here
    for i in range(TRAIN_STEPS):
        before = counts()
        t0 = time.monotonic()
        state, met = step(state, batches[i])
        losses.append(float(met["loss"]))  # waits for the step
        step_s.append(time.monotonic() - t0)
        gnorms.append(float(met["grad_norm"]))
        per_step.append({n: c - before[n] for n, c in counts().items()})
    launches = counts()  # -- and ends here
    peak = torch.cuda.max_memory_allocated()
    breakdown = step_breakdown(cfg, state, batches[TRAIN_STEPS])
    step_med = statistics.median(step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dense, attn, ssm = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    del state, batches, met
    gc.collect()
    torch.cuda.empty_cache()
    # forward and remat recompute, then one backward, per layer
    want = {**dict.fromkeys(KERNELS, 0), fa.NAME: 2 * cfg.num_attn_layers,
            fab.NAME: cfg.num_attn_layers, ssd.NAME: 2 * cfg.num_mamba_layers,
            ssdb.NAME: cfg.num_mamba_layers}
    emit({"phase": phase, "arch": cfg.name, "params": cfg.param_count(),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "optimizer": dataclasses.asdict(TRAIN_OPT), "remat": cfg.remat_policy,
          "init_s": init_s, "state_bytes": state_bytes, "losses": losses,
          "grad_norms": gnorms, "step_s": step_s, "step_s_median_2_10": step_med,
          "tokens_per_s": tokens / step_med, "model_flops_dense": dense,
          "model_flops_attention": attn, "model_flops_ssd": ssm,
          "mfu_vs_989_tflops": (dense + attn + ssm) / step_med / PEAK_FLOPS[torch.bfloat16],
          "max_memory_allocated": peak, "memory_allocated_before": base_alloc,
          "launches": launches, "launches_per_step": per_step, "profiled_step": breakdown})
    check(all(np.isfinite(x) for x in losses + gnorms), f"{phase}: not finite {losses} {gnorms}")
    check(losses[-1] < losses[0], f"{phase}: the loss did not fall: {losses}")
    check(per_step == [want] * TRAIN_STEPS, f"{phase}: launches per step {per_step} != {want}")
    check(peak < 80e9, f"{phase}: peak memory {peak}")
    return launches


# the cells phase: card-sized ShapeConfigs for the production cells' builders
CELL_TRAIN_STEPS, CELL_DECODE_STEPS = 3, 4
CELL_TOL = {"attention": 2e-2, "ssd": 3e-2}  # tests/test_kernels.py's bf16 tolerances
MOE_CELL_ARCH = "olmoe-1b-7b"  # its fp32 AdamW state (~110 GB) fits no card: no train cell
REDUCED_CELL_BATCH, REDUCED_CELL_SEQ = 2, 16  # the reduced jamba's train cell
DRYRUN_CELL = ("qwen2.5-3b", "train_4k")
DRYRUN_TIMEOUT_S = 300


def start_dryrun(tmp: str):
    """The production dry-run of one cell (256 fake ranks, meta tensors,
    no device: CUDA hidden) in a subprocess of its own, started after the
    build so it runs beside the card's phases; ``finish_dryrun`` collects
    it."""
    out = Path(tmp) / "dryrun.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_CELL[0],
           "--shape", DRYRUN_CELL[1], "--json-out", str(out)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    # niced, so that the host-bound phases it runs beside keep their cores
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            preexec_fn=lambda: os.nice(10))
    return proc, out, time.monotonic()


def finish_dryrun(job) -> dict:
    proc, out, t0 = job
    try:
        log, _ = proc.communicate(timeout=max(DRYRUN_TIMEOUT_S - (time.monotonic() - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"the dry-run took more than {DRYRUN_TIMEOUT_S} s")
    check(proc.returncode == 0 and out.exists(), f"the dry-run failed: {log[-3000:]}")
    rec = json.loads(out.read_text())
    an = rec["analysis"]
    return {"cell": list(DRYRUN_CELL), "status": rec["status"], "mesh": rec["mesh"],
            "chips": rec["chips"], "trace_s": rec["trace_s"],
            "wall_s": time.monotonic() - t0, "memory": an["memory"],
            "flops": an["flops"], "dot_flops": an["dot_flops"], "hbm_bytes": an["hbm_bytes"],
            "collective_bytes": an["collective_bytes"],
            "collective_traffic_bytes": an["collective_traffic_bytes"],
            "collectives": an["collectives"], "collective_counts": an["collective_counts"],
            "by_kernel": an["by_kernel"], "roofline": rec["roofline"]}


def rel_err(got, want) -> float:
    """max |got - want| / (1 + max |want|), over tensors or floats."""
    if isinstance(got, float):
        return abs(got - want) / (1 + abs(want))
    return ((got.float() - want.float()).abs().max() / (1 + want.float().abs().max())).item()


def moe_layers(cfg) -> int:
    return sum(s.ffn == "moe" for s in cfg.period_spec()) * cfg.num_periods


@contextlib.contextmanager
def counting_moe_ffn():
    """``distributed.local.moe_ffn`` (the MoE FFN on a mesh, which
    ``layers.moe_forward`` takes for a ``DTensor``) counted: yields a list
    that gains one entry a call."""
    calls, inner = [], dlocal.moe_ffn

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    dlocal.moe_ffn = counted
    try:
        yield calls
    finally:
        dlocal.moe_ffn = inner


def cell_train(arch, mesh, reduced=False):
    """``arch`` at full width (``reduced``: its reduced config in fp32,
    REDUCED_CELL_BATCH x REDUCED_CELL_SEQ, the default tuning):
    CELL_TRAIN_STEPS single-device steps, then the same from the same
    seeded state through the production train cell's builder
    (``_build_train``, a card-sized ShapeConfig) on the 1 x 1 mesh; one
    after the other, never both states at once. Returns (record, the
    cell's launches)."""
    cfg = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    batch, seq = (REDUCED_CELL_BATCH, REDUCED_CELL_SEQ) if reduced else (TRAIN_BATCH, TRAIN_SEQ)
    tuning = CellTuning() if reduced else get_tuning(arch, "train_4k")
    shape = ShapeConfig("card_train", "train", seq, batch)
    data = TokenPipeline(DataConfig(cfg.vocab_size, batch, seq, seed=0))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}
               for i in range(CELL_TRAIN_STEPS)]

    def run(step, state, feed):
        losses, norms, secs = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, met = step(state, feed(b))
            losses.append(float(met["loss"]))
            secs.append(time.monotonic() - t0)
            norms.append(float(met["grad_norm"]))
        return losses, norms, secs

    state = init_train_state(cfg, TRAIN_OPT, torch.Generator("cuda").manual_seed(0), "cuda")
    ref = run(make_train_step(cfg, TRAIN_OPT), state, lambda b: b)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(cfg, TRAIN_OPT, torch.Generator("cuda").manual_seed(0), "cuda")
    t0 = time.monotonic()
    step, (cstate, _), meta = _build_train(cfg, shape, mesh, tuning, state=state,
                                           opt_cfg=TRAIN_OPT)
    del state
    build_s = time.monotonic() - t0
    with counting_moe_ffn() as moe_calls:
        reset_counts()  # -- the cells path (train) starts here
        got = run(step, cstate, lambda b: place_batch(cfg, mesh, b, "train"))
        launches = counts()  # -- and ends here
    del cstate, step
    gc.collect()
    torch.cuda.empty_cache()
    tol = CELL_TOL["ssd" if cfg.num_mamba_layers else "attention"]
    errs = [rel_err(a, b) for a, b in zip(got[0] + got[1], ref[0] + ref[1])]
    rec = {"arch": cfg.name, "cell": "train", "batch": batch, "seq": seq,
           "policy": {k: list(v) for k, v in meta["policy"].items()},
           "losses": got[0], "losses_single_device": ref[0], "grad_norms": got[1],
           "grad_norms_single_device": ref[1], "bit_equal": got[:2] == ref[:2],
           "max_rel_err": max(errs), "tol": tol, "step_s": got[2],
           "step_s_single_device": ref[2], "build_s": build_s, "launches": launches,
           "moe_ffn_calls": len(moe_calls)}
    check(all(np.isfinite(x) for x in got[0] + got[1]), f"cells {arch}: not finite {got}")
    check(max(errs) <= tol, f"cells {arch} train differs from one device: {rec}")
    # every step runs each MoE layer's forward, and again under remat
    check(len(moe_calls) % (CELL_TRAIN_STEPS * moe_layers(cfg) or 1) == 0
          and (len(moe_calls) > 0) == (moe_layers(cfg) > 0),
          f"cells {cfg.name}: local.moe_ffn ran {len(moe_calls)} times")
    if reduced:  # fp32, the same ops on one rank: the same losses
        check(got[0] == ref[0], f"cells {cfg.name} losses differ from one device: {rec}")
    return rec, launches


def cell_serve(arch, mesh):
    """``arch`` at full width, inference: the prefill (4 x 1024) and
    CELL_DECODE_STEPS greedy decode steps on one device, then the prefill
    cell and the decode cell (its cache filled by the prefill cell's step,
    then the same tokens) from the production builders on the 1 x 1 mesh.
    Returns (record, the cells' launches)."""
    cfg = ARCHS[arch]
    L = FULL_SEQ + CELL_DECODE_STEPS
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FULL_BATCH, FULL_SEQ),
                                           dtype=np.int32)).cuda()
    pos0 = torch.full((FULL_BATCH,), FULL_SEQ, dtype=torch.int32, device="cuda")

    def timed_call(fn, *a):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    with torch.no_grad():
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        cache = init_cache(cfg, FULL_BATCH, L)
        (logits, _, _), pre_s = timed_call(prefill, cfg, params, {"tokens": prompt}, cache)
        ref, toks, ref_s = [logits], [], []
        for i in range(CELL_DECODE_STEPS):
            toks.append(greedy_sample(ref[-1])[:, None])
            (lg, _), sec = timed_call(decode_step, cfg, params, toks[-1], pos0 + i, cache)
            ref.append(lg)
            ref_s.append(sec)
        del cache
        tuning = get_tuning(arch, "prefill_32k")
        pshape = ShapeConfig("card_prefill", "prefill", FULL_SEQ, FULL_BATCH)
        dshape = ShapeConfig("card_decode", "decode", L, FULL_BATCH)
        moe_calls = {}
        reset_counts()  # -- the cells path (prefill, decode) starts here
        pstep, (pparams, _, pcache), pmeta = _build_prefill(cfg, pshape, mesh, tuning,
                                                            params=params)
        batch = place_batch(cfg, mesh, {"tokens": prompt}, "prefill")
        with counting_moe_ffn() as calls:
            (plog, _), cpre_s = timed_call(pstep, pparams, batch, pcache)
        moe_calls["prefill"] = len(calls)
        got = [plog.full_tensor()]
        del pcache
        dstep, (dparams, _, _, dcache), dmeta = _build_decode(cfg, dshape, mesh, tuning,
                                                              params=params)
        pstep(dparams, batch, dcache)  # fills the decode cell's cache
        cdec_s, moe_calls["decode"] = [], []
        for i in range(CELL_DECODE_STEPS):
            ins = place_batch(cfg, mesh, {"tokens": toks[i], "positions": pos0 + i}, "decode")
            with counting_moe_ffn() as calls:
                (lg, _), sec = timed_call(dstep, dparams, ins["tokens"], ins["positions"],
                                          dcache)
            moe_calls["decode"].append(len(calls))
            got.append(lg.full_tensor())
            cdec_s.append(sec)
        launches = counts()  # -- and ends here
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        bit = all(torch.equal(a, b) for a, b in zip(got, ref))
        prefill_bit = torch.equal(got[0], ref[0])
        del params, pparams, dparams, dcache, got, ref, plog, lg
    gc.collect()
    torch.cuda.empty_cache()
    tol = CELL_TOL["attention"]
    rec = {"arch": arch, "cell": "prefill+decode", "batch": FULL_BATCH, "prompt": FULL_SEQ,
           "decode_steps": CELL_DECODE_STEPS, "cache_len": L,
           "zero_shard_decode": dmeta["zero_shard_decode"],
           "max_rel_err_logits": errs, "bit_equal": bit, "prefill_bit_equal": prefill_bit,
           "tol": tol, "prefill_s": cpre_s, "prefill_s_single_device": pre_s,
           "decode_step_s": cdec_s, "decode_step_s_single_device": ref_s,
           "launches": launches, "moe_ffn_calls": moe_calls,
           "note": "the decode cell merges K2's per-split partials across the cache's "
                   "sequence shards in PyTorch (distributed.local.merge_partials); one "
                   "device merges them in K2's combine kernel"}
    check(max(errs) <= tol, f"cells {arch} logits differ from one device: {rec}")
    check(prefill_bit, f"cells {arch}: the prefill cell's logits are not the single "
                       f"device's bit for bit: {rec}")
    n = moe_layers(cfg)
    check(moe_calls == {"prefill": n, "decode": [n] * CELL_DECODE_STEPS},
          f"cells {arch}: local.moe_ffn ran {moe_calls}, want {n} a step")
    check(launches[fa.NAME] > 0 and launches[dec.NAME] > 0,
          f"cells {arch}: K1 or K2 not launched: {launches}")
    return rec, launches


def phase_cells(dryrun_job):
    """The production cells' builders (launch/cells.py) on a 1 x 1 (data,
    model) mesh over a one-rank NCCL group: qwen2.5-3b's train, prefill and
    decode cells, mamba2-780m's train cell and olmoe-1b-7b's prefill and
    decode cells (the MoE FFN through ``local.moe_ffn``) at full width,
    and the reduced jamba's train cell (K1, K3 and its backward, the MoE
    FFN), each against the same model's single-device steps on the same
    seeded weights; then the dry-run of one production cell (started after
    the build). Returns the cells' launches by kernel."""
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()  # each thread's 32 MiB (autograd's too)
    base = torch.cuda.memory_allocated()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    launches = dict.fromkeys(KERNELS, 0)
    recs = []
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        for fn, arch in ((cell_train, TRAIN_ARCH), (cell_serve, TRAIN_ARCH),
                         (cell_train, MAMBA_TRAIN_ARCH), (cell_serve, MOE_CELL_ARCH),
                         (functools.partial(cell_train, reduced=True), JAMBA_ARCH)):
            rec, got = fn(arch, mesh)
            recs.append(rec)
            for n, c in got.items():
                launches[n] += c
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    after = torch.cuda.memory_allocated()
    dry = finish_dryrun(dryrun_job)
    emit({"phase": "cells", "mesh": {"data": 1, "model": 1}, "backend": "nccl",
          "cells": recs, "launches": launches, "memory_allocated_before": base,
          "memory_allocated_after": after, "dryrun": dry})
    check(after == base, f"cells: memory_allocated {after} != its baseline {base}")
    check(dry["status"] == "OK" and dry["collective_bytes"] > 0, f"dry-run: {dry}")
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the cells path: {launches}")
    return launches


@contextlib.contextmanager
def plain_routes():
    """``kernels.ops``' entry points with ``use_kernel=False``: the models
    run the plain versions on the card."""
    routes = (ops.flash_attention, ops.decode_attention, ops.ssd_scan)
    ops.flash_attention, ops.decode_attention, ops.ssd_scan = (
        functools.partial(f, use_kernel=False) for f in routes)
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention, ops.ssd_scan = routes


def train_grad_check(arch):
    """Every leaf's gradient of lm_loss with the kernels' route (K1 and K3,
    forward and backward) against the same with use_kernel=False,
    ``arch``'s widths at depth 2, fp32 (TF32 off) and bf16, on one pipeline
    batch; the projections that feed a kernel (attention's wq, wk, wv,
    Mamba2's fused in_proj, whose split gives the scan's strided x, B and
    C) have gradients that are not zero. A comparison: its launches are
    not a path."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(ARCHS[arch], num_layers=2, param_dtype=dtype,
                                  compute_dtype=dtype)
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        data = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0))
        batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
        before = (fab.launches, ssdb.launches)
        met, got = _value_and_grad(cfg, params, batch)
        check((fab.launches - before[0], ssdb.launches - before[1])
              == (cfg.num_attn_layers, cfg.num_mamba_layers),
              f"{arch}: the kernel route ran {fab.launches - before[0]} K1 and "
              f"{ssdb.launches - before[1]} K3 backward kernels")
        with plain_routes():
            pmet, want = _value_and_grad(cfg, params, batch)
        worst, per_leaf, ok = 0.0, {}, True
        for (key, _), g, w in zip(T.items(params), got, want):
            err = (g.float() - w.float()).abs().max().item()
            rel = err / max(w.float().abs().max().item(), 1e-30)
            per_leaf[key] = [err, rel]
            ok = ok and err <= grad_tol(getattr(torch, dtype), w)
            worst = max(worst, rel)
        proj = {key: g.float().abs().max().item() for (key, _), g in zip(T.items(params), got)
                if key.split("/")[-1] in ("wq", "wk", "wv", "in_proj")}
        out[dtype] = {"loss": float(met["loss"]), "plain_loss": float(pmet["loss"]),
                      "worst_rel_err": worst, "per_leaf": per_leaf,
                      "projection_max_abs_grad": proj}
        check(ok, f"{arch} train grads ({dtype}) differ from use_kernel=False: {per_leaf}")
        check(proj and all(v > 0 for v in proj.values()), f"{arch} zero projection grads: {proj}")
        del params, got, want, batch
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "train", "check": "grads_vs_use_kernel_false", "arch": arch, "depth": 2,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "results": out,
          "tol": "1e-4 * max(1, max|g|) fp32, 2e-2 * max|g| bf16, per leaf"})


def train_reduced():
    """The reduced qwen2.5-3b (fp32, batch 2 x 16) through ``train_loop``
    on the card: 6 steps with a checkpoint every 3; a failure injected at
    step 4 and a resume, whose losses equal the uninterrupted run's and
    the CPU's (rtol 1e-4); then the compressed DP step on a one-rank NCCL
    group for 3 steps (the loss falls, as tests/test_training.py holds);
    then the reduced jamba (fp32, 2 x 16, 4 steps; K1 and K3 forward and
    backward, MoE) through ``train_loop``, its losses the CPU's (rtol
    1e-4). Returns the card's launches over these runs."""
    kw = dict(steps=6, ckpt_every=3, global_batch=2, seq_len=16, log_every=100)
    reset_counts()  # -- the reduced training path starts here
    with tempfile.TemporaryDirectory() as tmp:
        _, full, _ = train_loop(TRAIN_ARCH, ckpt_dir=f"{tmp}/a", device="cuda", **kw)
        try:
            train_loop(TRAIN_ARCH, ckpt_dir=f"{tmp}/b", device="cuda", fail_at_step=4, **kw)
            failed = False
        except RuntimeError:
            failed = True
        _, resumed, _ = train_loop(TRAIN_ARCH, ckpt_dir=f"{tmp}/b", device="cuda", **kw)
        launches = counts()
        _, cpu, _ = train_loop(TRAIN_ARCH, ckpt_dir=f"{tmp}/c", device="cpu", **kw)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        cfg = ARCHS[TRAIN_ARCH].reduced()
        opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=20, min_lr_ratio=1.0)
        state = init_dp_state(cfg, opt, torch.Generator().manual_seed(0), "cuda")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 16), dtype=np.int32)).cuda()
        step = make_dp_compressed_step(cfg, opt)
        dp_losses = []
        before = counts()
        for _ in range(3):
            state, met = step(state, {"tokens": toks})
            dp_losses.append(float(met["loss"]))
        for n, c in counts().items():
            launches[n] += c - before[n]
    finally:
        dist.destroy_process_group()

    # the reduced jamba: K1 and K3, forward and backward, and MoE
    jkw = dict(steps=4, ckpt_every=100, global_batch=2, seq_len=16, log_every=100)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        before = counts()
        _, jamba, _ = train_loop(JAMBA_ARCH, ckpt_dir=f"{tmp}/a", device="cuda", **jkw)
        jamba_launches = {n: c - before[n] for n, c in counts().items()}
        jamba_s = time.monotonic() - t0
        _, jamba_cpu, _ = train_loop(JAMBA_ARCH, ckpt_dir=f"{tmp}/b", device="cpu", **jkw)
        jamba_cpu_s = time.monotonic() - t0 - jamba_s
    for n, c in jamba_launches.items():
        launches[n] += c
    emit({"phase": "train", "check": "reduced_loop_resume_and_dp", "arch": cfg.name,
          "losses_uninterrupted": full, "losses_resumed": resumed, "losses_cpu": cpu,
          "injected_failure_raised": failed, "dp_nccl_one_rank_losses": dp_losses,
          "jamba_losses": jamba, "jamba_losses_cpu": jamba_cpu,
          "jamba_launches": jamba_launches, "jamba_seconds": [jamba_s, jamba_cpu_s],
          "launches": launches, "rtol": 1e-4})
    jcfg = ARCHS[JAMBA_ARCH].reduced()
    want = {**dict.fromkeys(KERNELS, 0), fa.NAME: 2 * jcfg.num_attn_layers,
            fab.NAME: jcfg.num_attn_layers, ssd.NAME: 2 * jcfg.num_mamba_layers,
            ssdb.NAME: jcfg.num_mamba_layers}
    check(jamba_launches == {n: jkw["steps"] * c for n, c in want.items()},
          f"reduced jamba launches {jamba_launches}, want {jkw['steps']} x {want}")
    check(np.allclose(jamba, jamba_cpu, rtol=1e-4, atol=0),
          f"reduced jamba card losses {jamba} != CPU {jamba_cpu}")
    check(failed, "the injected failure did not raise")
    check(len(resumed) == 3 and np.allclose(resumed, full[-3:], rtol=1e-4, atol=0),
          f"resumed losses {resumed} != {full[-3:]}")
    check(np.allclose(full, cpu, rtol=1e-4, atol=0), f"card losses {full} != CPU {cpu}")
    check(dp_losses[-1] < dp_losses[0], f"DP losses did not fall: {dp_losses}")
    return launches


# ---------------------------------------------------------------------------
# the port's accounting of work: analysis.op_analysis on the card
# ---------------------------------------------------------------------------

ANALYSIS_ARCH = "qwen2.5-3b"


def analysis_steps(cfg, state, use_kernel):
    """``analyze_step`` over the prefill (4 x 1024), one decode step after
    it and one train step (``phase_train``'s settings) of ``cfg``, on
    ``state``'s weights (the train step updates them in place); the plain
    versions inside ``plain_routes`` unless ``use_kernel``. Returns the
    reports and the step functions (for timing)."""
    data = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    params = state["params"]
    prefill_step, decode = make_prefill_step(cfg), make_decode_step(cfg)
    train = make_train_step(cfg, TRAIN_OPT)
    tokens = {"tokens": batch["tokens"]}
    with torch.inference_mode():
        cache = init_cache(cfg, TRAIN_BATCH, TRAIN_SEQ + 1, device="cuda")
    positions = torch.full((TRAIN_BATCH,), TRAIN_SEQ, dtype=torch.int32, device="cuda")
    nxt = batch["tokens"][:, -1:]

    def run_prefill():
        with torch.inference_mode():
            return prefill_step(params, tokens, cache)

    def run_decode():
        with torch.inference_mode():
            return decode(params, nxt, positions, cache)

    def run_train():
        return train(state, batch)

    steps = {"prefill": run_prefill, "decode": run_decode, "train": run_train}
    with contextlib.nullcontext() if use_kernel else plain_routes():
        reports = {name: analyze_step(fn) for name, fn in steps.items()}
    return reports, steps


def same_counts(a, b) -> bool:
    """Two reports' counts equal exactly and their bytes within 1 %."""
    def close(x, y):
        return abs(x - y) <= 0.01 * max(abs(x), abs(y))

    return (a["flops"] == b["flops"] and a["dot_flops"] == b["dot_flops"]
            and {k: v["count"] for k, v in a["by_op"].items()}
            == {k: v["count"] for k, v in b["by_op"].items()}
            and {k: (v["calls"], v["flops"]) for k, v in a["by_kernel"].items()}
            == {k: (v["calls"], v["flops"]) for k, v in b["by_kernel"].items()}
            and close(a["hbm_bytes"], b["hbm_bytes"])
            and close(a["hbm_bytes_fused"], b["hbm_bytes_fused"]))


def event_ms(fn, reps=5) -> dict:
    """The span of one call of ``fn`` between two CUDA events (idle gaps
    between its launches included), after one warm-up call: the median,
    least and most of ``reps`` calls."""
    fn()
    spans = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return {"median": statistics.median(spans), "min": min(spans), "max": max(spans)}


def phase_analysis():
    """``analysis.op_analysis.analyze_step`` on qwen2.5-3b on the card: at
    depth 2 the reports with the kernels and with ``use_kernel=False``
    (counts equal, bytes within 1 %); at full width (bf16, seed 0) the
    prefill 4 x 1024, one decode step and one train step, each report's
    FLOPs, bytes, kernel units and roofline terms beside the step's device
    time (``event_ms``: the median of five spans after a warm-up). Checks: K1's unit FLOPs are ``attention_bound_ms``'s count times
    its calls; the prefill's product FLOPs lie within 10 % of
    ``model_flops`` plus the attention products (and within 1 % of that
    count with the embedding gathered and only the last position
    unembedded, as the prefill does). Returns the launches of the
    full-width reports."""
    full = ARCHS[ANALYSIS_ARCH]
    t0 = time.monotonic()
    small = dataclasses.replace(full, num_layers=2)
    state = init_train_state(small, TRAIN_OPT, torch.Generator("cuda").manual_seed(0), "cuda")
    kern = analysis_steps(small, state, use_kernel=True)[0]
    plain = analysis_steps(small, state, use_kernel=False)[0]
    del state
    parity = {name: same_counts(kern[name], plain[name]) for name in kern}
    emit({"phase": "analysis", "check": "kernels_vs_plain", "arch": small.name, "depth": 2,
          "equal": parity, "seconds": time.monotonic() - t0,
          "reports": {name: {route: {k: r[name][k] for k in ("flops", "dot_flops", "hbm_bytes",
                                                           "hbm_bytes_fused", "by_kernel")}
                             for route, r in (("kernels", kern), ("plain", plain))}
                      for name in kern}})
    check(all(parity.values()), f"analysis: kernel and plain reports differ: {parity}")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    state = init_train_state(full, TRAIN_OPT, torch.Generator("cuda").manual_seed(0), "cuda")
    reset_counts()  # -- the analysis path starts here
    reports, steps = analysis_steps(full, state, use_kernel=True)
    launches = counts()  # -- and ends here
    analysed_s = time.monotonic() - t0
    device_ms = {name: event_ms(fn) for name, fn in steps.items()}
    del state, steps
    gc.collect()
    torch.cuda.empty_cache()
    tokens = {"prefill": TRAIN_BATCH * TRAIN_SEQ, "decode": TRAIN_BATCH,
              "train": TRAIN_BATCH * TRAIN_SEQ}
    out = {}
    for name, rep in reports.items():
        roof = roofline_from_report(full, rep, chips=1, mode=name, tokens=tokens[name])
        out[name] = {k: rep[k] for k in ("flops", "dot_flops", "hbm_bytes", "hbm_bytes_fused",
                                        "by_kernel")}
        out[name].update(roofline=roof, device_ms=device_ms[name],
                         bound_share=roof["step_time_bound_s"] * 1e3
                         / device_ms[name]["median"],
                         top_ops=sorted(([k, v["count"], v["flops"], v["bytes"]]
                                         for k, v in rep["by_op"].items()),
                                        key=lambda r: -r[3])[:6])
    shape = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, full.num_heads, full.num_kv_heads,
             full.head_dim, True)
    k1 = attention_bound_ms(shape, torch.bfloat16)[2]
    pre = reports["prefill"]
    attn = pre["by_kernel"][fa.NAME]["flops"]
    embed = full.vocab_size * full.d_model
    loose = model_flops(full, "prefill", tokens["prefill"]) + attn
    # the embedding is a gather, and only the last position is unembedded
    tight = (2.0 * tokens["prefill"] * (full.param_count() - embed)
             + 2.0 * TRAIN_BATCH * embed + attn)
    emit({"phase": "analysis", "arch": full.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "steps": out, "launches": launches, "seconds_analysed": analysed_s,
          "prefill_dot_flops_over_model_flops_plus_attention": pre["dot_flops"] / loose,
          "prefill_dot_flops_over_gathered_embedding_count": pre["dot_flops"] / tight})
    for name in ("prefill", "train"):
        row = reports[name]["by_kernel"][fa.NAME]
        check(row["flops"] == k1 * row["calls"],
              f"analysis {name}: K1 units {row} != {row['calls']} x {k1}")
    check(abs(pre["dot_flops"] - loose) <= 0.1 * loose,
          f"analysis: prefill dot FLOPs {pre['dot_flops']} vs {loose}")
    check(abs(pre["dot_flops"] - tight) <= 0.01 * tight,
          f"analysis: prefill dot FLOPs {pre['dot_flops']} vs {tight}")
    check(reports["decode"]["by_kernel"][dec.NAME]["calls"] == full.num_attn_layers,
          f"analysis: decode units {reports['decode']['by_kernel']}")
    check(reports["train"]["by_kernel"][fab.NAME]["calls"] == full.num_attn_layers,
          f"analysis: train units {reports['train']['by_kernel']}")
    return launches


def main():
    t_start = time.monotonic()
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.monotonic() - t0
        return out

    smi = timed("card", phase_card)
    timed("build", phase_build)
    tmp = tempfile.TemporaryDirectory()
    dryrun_job = start_dryrun(tmp.name)  # runs beside the phases until `cells`
    try:
        run_phases(smi, timed, seconds, t_start, dryrun_job)
    finally:
        if dryrun_job[0].poll() is None:
            dryrun_job[0].kill()
            dryrun_job[0].communicate()
        tmp.cleanup()


def run_phases(smi, timed, seconds, t_start, dryrun_job):
    timings = {fa.NAME: timed("kernels", phase_kernels),
               fab.NAME: timed("kernels_bwd", phase_kernels_bwd),
               dec.NAME: timed("kernels_decode", phase_kernels_decode),
               ssd.NAME: timed("kernels_ssd", phase_kernels_ssd),
               ssdb.NAME: timed("kernels_ssd_bwd", phase_kernels_ssd_bwd)}
    paths = {name: dict.fromkeys(("reduced", "full_width", "mamba_reduced", "mamba_full",
                                  "gateway", "prefill", "decode", "moe_full", "moe_prefill",
                                  "moe_decode", "whisper_prefill", "whisper_decode",
                                  "zoo_reduced", "train", "train_reduced", "train_mamba",
                                  "cells", "rank_bodies", "serve", "serve_workload",
                                  "exit_ladder", "cold_setup", "control_plane", "analysis"),
                                 0)
             for name in KERNELS}

    def add(path, launches):
        for name, n in launches.items():
            paths[name][path] += n

    add("reduced", timed("reduced", phase_reduced, "reduced", "qwen2.5-3b"))
    add("full_width", timed("full", phase_full, "full", "qwen2.5-3b", "qwen"))
    add("mamba_reduced", timed("mamba_reduced", phase_reduced, "mamba_reduced", "mamba2-780m"))
    add("mamba_full", timed("mamba_full", phase_full, "mamba_full", "mamba2-780m", "mamba"))
    add("moe_full", timed("moe_full", phase_full, "moe_full", "olmoe-1b-7b", "olmoe"))
    paths[fa.NAME]["gateway"] = timed("gateway", phase_gateway)
    add("serve", timed("serve", phase_serve))
    add("serve_workload", timed("serve_workload", phase_serve_workload))
    add("exit_ladder", timed("exit_ladder", phase_exit_ladder))
    add("cold_setup", timed("cold_setup", phase_cold_setup))
    add("control_plane", timed("control_plane", phase_control_plane))
    timed("decode", phase_decode, "qwen2.5-3b", paths)
    timed("mamba_decode", phase_decode, "mamba2-780m", paths)
    timed("moe_decode", phase_decode, "olmoe-1b-7b", paths, path="moe_")
    timed("whisper_decode", phase_decode, "whisper-small", paths, phase="whisper_decode",
          path="whisper_", prompt_len=WHISPER_PROMPT)
    timed("decode_past_cache", decode_past_cache)
    add("zoo_reduced", timed("zoo_reduced", phase_zoo_reduced))
    add("train", timed("train", phase_train, TRAIN_ARCH, "train"))
    timed("train_grad_check", train_grad_check, TRAIN_ARCH)
    add("train_reduced", timed("train_reduced", train_reduced))
    add("train_mamba", timed("train_mamba", phase_train, MAMBA_TRAIN_ARCH, "train_mamba"))
    timed("train_grad_check_mamba", train_grad_check, MAMBA_TRAIN_ARCH)
    add("cells", timed("cells", phase_cells, dryrun_job))
    add("rank_bodies", timed("rank_bodies", phase_rank_bodies))
    add("analysis", timed("analysis", phase_analysis))
    main_path = {fa.NAME: "full_width", fab.NAME: "train", dec.NAME: "decode",
                 ssd.NAME: "mamba_full", ssdb.NAME: "train_mamba"}
    replaces = {
        fa.NAME: "src/repro/kernels/flash_attention.py:37",
        fab.NAME: "jax.grad of src/repro/models/layers.py:164",
        dec.NAME: "src/repro/kernels/decode_attention.py:29",
        ssd.NAME: "src/repro/kernels/ssd_scan.py:38",
        ssdb.NAME: "jax.grad of src/repro/models/mamba2.py:39",
    }
    for name in KERNELS:
        check(paths[name][main_path[name]] > 0, f"{name} never launched on its path")
    for name, path in ((fa.NAME, "gateway"), (fa.NAME, "moe_full"), (dec.NAME, "moe_decode"),
                       (fa.NAME, "whisper_prefill"), (dec.NAME, "whisper_decode"),
                       (fa.NAME, "zoo_reduced"), (dec.NAME, "zoo_reduced"),
                       (ssd.NAME, "zoo_reduced"), (fa.NAME, "train"),
                       (fa.NAME, "train_reduced"), (fab.NAME, "train_reduced"),
                       (ssd.NAME, "train_mamba"), (ssd.NAME, "train_reduced"),
                       (ssdb.NAME, "train_reduced"), (fa.NAME, "serve"),
                       (fa.NAME, "serve_workload"), (ssd.NAME, "serve_workload"),
                       (fa.NAME, "exit_ladder"), (fa.NAME, "cold_setup"),
                       (fa.NAME, "rank_bodies"), (fab.NAME, "rank_bodies"),
                       (ssd.NAME, "rank_bodies"), (ssdb.NAME, "rank_bodies"),
                       (fa.NAME, "control_plane"),
                       (ssd.NAME, "control_plane"), (fa.NAME, "analysis"),
                       (fab.NAME, "analysis"), (dec.NAME, "analysis"),
                       *((name, "cells") for name in KERNELS)):
        check(paths[name][path] > 0, f"{name} never launched on the {path} path")
    emit({"phase": "wall", "seconds": time.monotonic() - t_start, "by_phase": seconds})
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": paths[name][main_path[name]],
        "launches_by_path": paths[name],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "ms_again": t["ms_again"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": t["shape"], "card": smi,
        **({"parts_ms": t["parts_ms"]} if "parts_ms" in t else {}),
    } for name, t in timings.items()]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-runs"]:  # one policy's cold runs, for phase_cold_setup
        print(json.dumps(cold_runs(sys.argv[2])), flush=True)
    else:
        main()
