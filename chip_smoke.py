"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each:

1. card      the card's name and power limit (nvidia-smi), torch and CUDA
             versions;
2. build     builds (or loads) the hand-written kernels from
             src/repro_torch/kernels/csrc with nvcc, all sources at once;
3. kernels   every kernel against its plain PyTorch version on the card at
             the reference sweep and at the serving shapes, then timed at
             the full-width serving shape beside its plain version, one
             PyTorch library call (the yardstick only) and its bound;
4. reduced   SageRuntime serves the reduced qwen2.5-3b cold -> warm -> warm;
5. full      SageRuntime serves the full-width qwen2.5-3b (36 layers,
             d_model 2048, bf16, random weights from a seed), batch 4 x 1024
             tokens: cold, warm, then a burst of 4 concurrent requests;
6. the {"kernels": [...]} line, then the contract's last line.

Any failed check exits non-zero before the last line. The script never
carries on without a card: it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; nothing was run")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import SageRuntime  # noqa: E402
from repro_torch.core.functions import (  # noqa: E402
    _model_function, make_model_function, make_request,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import forward  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound's rates
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
REF_SHAPES = [  # tests/test_kernels.py sweep: B, Sq, Sk, Hq, Hkv, Dh, causal
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 2, 32, True),
    (2, 96, 96, 4, 4, 64, True),
    (1, 128, 128, 4, 1, 128, False),
    (1, 64, 192, 2, 2, 64, False),
    (1, 512, 512, 8, 8, 64, True),
]
REDUCED_SHAPE = (1, 16, 16, 4, 2, 16, True)        # qwen2.5-3b reduced, fp32
FULL_SHAPE = (4, 1024, 1024, 16, 2, 128, True)     # qwen2.5-3b full, bf16
FULL_BATCH, FULL_SEQ = 4, 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def inputs(shape, dtype, seed=0):
    B, Sq, Sk, Hq, Hkv, Dh, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
            for s in ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh))]


def time_ms(fn, reps=5, inner=10, warmup=3) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def attention_bound_ms(shape, dtype):
    """Least time for the work: max(operations / peak, bytes / bandwidth).
    Operations: 2 matmuls x 2 flops per (query, visible key) pair per head
    dim; with the causal mask only keys k <= q are visible. Bytes: q, k, v
    read once and o written once."""
    B, Sq, Sk, Hq, Hkv, Dh, causal = shape
    pairs = sum(min(Sk, qp + 1) for qp in range(Sq)) if causal else Sq * Sk
    flops = 4.0 * B * Hq * Dh * pairs
    nbytes = (2 * B * Sq * Hq * Dh + 2 * B * Sk * Hkv * Dh) * torch.finfo(dtype).bits / 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "tf32": False})
    return smi.splitlines()[0]


def phase_build():
    t0 = time.monotonic()
    _build.build([fa.NAME])
    fa.load()
    ptxas = [ln.strip() for ln in _build.ptxas_log.get(fa.NAME, "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "nvcc_seconds": _build.build_seconds, "flags": _build.NVCC_FLAGS,
          "ptxas": ptxas})


def phase_kernels():
    results = []
    cases = [(s, d) for s in REF_SHAPES for d in (torch.float32, torch.bfloat16)]
    cases += [(REDUCED_SHAPE, torch.float32), (FULL_SHAPE, torch.bfloat16)]
    worst = 0.0
    for shape, dtype in cases:
        q, k, v = inputs(shape, dtype)
        out = ops.flash_attention(q, k, v, causal=shape[-1], use_kernel=True)
        torch.cuda.synchronize()
        plain = ops.flash_attention(q, k, v, causal=shape[-1], use_kernel=False)
        err = (out.float() - plain.float()).abs().max().item()
        tol = TOL[dtype]
        # the tests' criterion: |out - plain| <= tol + tol * |plain|
        ok = bool(((out.float() - plain.float()).abs()
                   <= tol + tol * plain.float().abs()).all().item())
        ok = ok and bool(torch.isfinite(out.float()).all().item())
        results.append({"shape": list(shape), "dtype": str(dtype).split(".")[1],
                        "max_abs_err": err, "tol": tol, "ok": ok})
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
    bound, bound_by, flops, nbytes = attention_bound_ms(FULL_SHAPE, torch.bfloat16)
    emit({"phase": "kernel_timing", "kernel": fa.NAME, "shape": list(FULL_SHAPE),
          "dtype": "bfloat16", **timing, "bound_ms": bound, "bound_by": bound_by,
          "flops": flops, "bytes": nbytes, "library": "scaled_dot_product_attention, "
          "GQA expanded outside the timed call", "library_max_abs_err": lib_err,
          "tflops": flops / timing["ms"] / 1e9})
    return worst, timing, bound, bound_by


def drain(rt) -> dict:
    deadline = time.monotonic() + 60
    while not rt.is_idle() and time.monotonic() < deadline:
        time.sleep(0.01)
    rt.drain_teardown()
    usage = rt.memory_usage()
    rt.shutdown()
    return usage


def record(r) -> dict:
    return {"e2e_s": r.e2e, "warm_stage": r.warm_stage,
            "stages_s": dict(r.stages), "error": r.error}


def phase_reduced():
    rt = SageRuntime("sage", time_scale=0.02, exit_ttl=5.0, device="cuda")
    rt.sage_init()
    fn = make_model_function(rt.db, "f", arch="qwen2.5-3b", seed=3)
    rt.register_function(fn)
    reqs = [make_request(rt.db, fn, seed=s) for s in (0, 1, 2)]
    served, per_request = [], []
    fa.launches = 0  # -- the main path (reduced) starts here
    for req in reqs:
        before = fa.launches
        served.append(rt.db.fetch(rt.sage_run(req)))
        per_request.append(fa.launches - before)
    launches = fa.launches  # -- and ends here
    recs = rt.telemetry.records
    warm = [r.warm_stage for r in recs]
    stats = dict(rt.daemon.stats)
    usage = drain(rt)

    cfg = ARCHS["qwen2.5-3b"].reduced()
    weights = rt.db.fetch("f/weights")  # the host copy
    errs = []
    for req, out in zip(reqs, served):
        toks = rt.db.fetch(req.in_data[1].key)
        plain, _ = forward(cfg, weights, {"tokens": toks})  # CPU: plain attention
        errs.append(float(np.abs(out - plain[:, -1, :8].numpy()).max()))
    emit({"phase": "reduced", "warm_stage": warm, "shared_hits": stats["shared_hits"],
          "loads": stats["loads"], "launches": launches,
          "launches_per_request": per_request, "max_abs_err_vs_cpu_plain": max(errs),
          "tol": 1e-4, "requests": [record(r) for r in recs], "usage_after": usage})
    check(warm == [None, 1, 1], f"warm_stage {warm}")
    check(stats["shared_hits"] >= 1, "no shared hit")
    check(per_request == [2, 2, 2], f"launches per request {per_request}")
    check(max(errs) <= 1e-4, f"served logits differ from the CPU forward: {errs}")
    check(usage["device_used"] == usage["host_used"] == 0, f"teardown {usage}")
    return launches


def phase_full():
    cfg = ARCHS["qwen2.5-3b"]  # unreduced: the published widths and depth
    check(cfg.param_dtype == cfg.compute_dtype == "bfloat16", "full width is bf16")
    gc.collect()
    base_alloc = torch.cuda.memory_allocated()
    time_scale, load_timeout_s = 1.0, 120.0
    rt = SageRuntime("sage", time_scale=time_scale, load_timeout_s=load_timeout_s,
                     exit_ttl=60.0, device="cuda")
    rt.sage_init()
    t0 = time.monotonic()
    fn = _model_function(rt.db, "qwen", cfg, batch=FULL_BATCH, seq=FULL_SEQ, seed=0)
    init_s = time.monotonic() - t0
    rt.register_function(fn)
    ro_bytes = rt.db.size_of("qwen/weights")
    modelled_s = (ro_bytes / rt.paths.db.base_bw + ro_bytes / rt.paths.pcie.base_bw) * time_scale
    reqs = [make_request(rt.db, fn, batch=FULL_BATCH, seq=FULL_SEQ,
                         vocab=cfg.vocab_size, seed=s) for s in range(6)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0  # -- the main path (full width) starts here
    t0 = time.monotonic()
    out_keys = [rt.sage_run(reqs[0])]
    cold_launches = fa.launches
    out_keys.append(rt.sage_run(reqs[1]))
    futs = [rt.submit(r) for r in reqs[2:]]
    out_keys += [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = fa.launches  # -- and ends here
    peak = torch.cuda.max_memory_allocated()
    recs = rt.telemetry.records
    stats = dict(rt.daemon.stats)
    served = [rt.db.fetch(k) for k in out_keys]

    # one served request against the direct forward of the same weights and
    # tokens on the card (these launches are a comparison, not the path)
    weights = rt.db.to_device(rt.db.fetch("qwen/weights"))
    toks = rt.db.fetch(reqs[0].in_data[1].key).cuda()
    with torch.inference_mode():
        direct = forward(cfg, weights, {"tokens": toks})[0][:, -1, :8].float().cpu().numpy()
    direct_err = float(np.abs(served[0] - direct).max())
    del weights, toks
    usage = drain(rt)
    del rt, fn, futs
    gc.collect()
    after_raw = torch.cuda.memory_allocated()
    # every thread that ran a cuBLAS call keeps a workspace (32 MiB each on
    # this card) for the life of the process; those are not the port's
    torch._C._cuda_clearCublasWorkspaces()
    after = torch.cuda.memory_allocated()
    n_layers = cfg.num_layers
    emit({"phase": "full", "arch": cfg.name, "params": cfg.param_count(),
          "ro_bytes": ro_bytes, "batch": FULL_BATCH, "seq": FULL_SEQ,
          "init_s": init_s, "time_scale": time_scale, "load_timeout_s": load_timeout_s,
          "modelled_load_s": modelled_s, "wall_s": wall_s,
          "requests": [record(r) for r in recs], "shared_hits": stats["shared_hits"],
          "loads": stats["loads"], "launches": launches, "cold_launches": cold_launches,
          "max_memory_allocated": peak, "memory_allocated_before": base_alloc,
          "memory_allocated_after_shutdown": after_raw,
          "memory_allocated_after_cublas_workspaces_cleared": after, "usage_after": usage,
          "direct_max_abs_err": direct_err,
          "served_sample": [float(x) for x in served[0][0]]})
    check(all(r.error is None for r in recs), "a request failed")
    check(len(recs) == 6 and recs[0].warm_stage is None, "cold request")
    check(cold_launches == n_layers, f"cold request launched {cold_launches}")
    check(launches == 6 * n_layers, f"{launches} launches for 6 requests")
    check(stats["shared_hits"] >= 5, f"shared_hits {stats['shared_hits']}")
    check(all(np.isfinite(s).all() and s.shape == (FULL_BATCH, 8) for s in served),
          "served logits not finite")
    check(direct_err <= 1e-3, f"served differs from the direct forward: {direct_err}")
    check(usage["device_used"] == usage["host_used"] == 0, f"teardown {usage}")
    check(after <= base_alloc, f"device memory not freed: {after} > {base_alloc} bytes")
    return launches


def main():
    smi = phase_card()
    phase_build()
    worst, timing, bound, bound_by = phase_kernels()
    reduced_launches = phase_reduced()
    full_launches = phase_full()
    emit({"kernels": [{
        "name": fa.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "launches": full_launches,
        "launches_by_path": {"reduced": reduced_launches, "full_width": full_launches},
        "max_abs_err": worst, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": timing["library_ms"],
        "shape": list(FULL_SHAPE), "card": smi,
    }]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
