"""Dry-run: trace every (arch x shape) cell as one rank of the production
mesh, with no device, and give its per-rank work and roofline terms at the
H100's rates (the JAX package's ``launch/dryrun.py``).

The JAX dry-run lowers and compiles each cell for 256 or 512 placeholder
host devices. Here a cell runs once in eager PyTorch as rank 0 of a "fake"
process group of 256 or 512 ranks (``distributed.compat.init_fake_group``):
the inputs are ``meta`` shards placed by the rules, so nothing is
allocated and nothing is computed, and the collectives move nothing.
``analysis.op_analysis.analyze_step`` counts what the rank runs: its local
ops on its shards' shapes, the hand kernels' units, and the collectives of
``DTensor``'s redistributions. The rules shard only dims that divide, so
every rank's shapes, and so its report, are rank 0's.

The record has the JAX record's keys, with ``trace_s`` (building and
running the cell once) in place of ``lower_s`` and ``compile_s``.
``analysis["memory"]`` gives the rank's argument and output bytes from the
local shard shapes. XLA's temporary bytes (``temp_bytes``) have no
counterpart here: an eager step's peak depends on the allocator and the
order of frees, which a meta run does not see, so the key is None.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--workers 2] \\
      [--out build/dryrun]
  python -m repro_torch.launch.dryrun --all --both-meshes   # full 40x2 matrix

``--all`` runs each cell in a subprocess of its own: one cell's failure
cannot poison the rest, and the fake group is its process's default group.
Results land as JSON per cell under ``--out`` (``build/`` is not
committed).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.analysis.roofline import roofline_from_report
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape, shape_applicable

ROOT = Path(__file__).resolve().parents[3]
CELL_TIMEOUT_S = 3600  # a cell's subprocess is killed after this


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """Trace one cell as rank 0 of the production mesh; the full record."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
    }
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    import torch.distributed as dist

    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.distributed.compat import init_fake_group
    from repro_torch.launch.cells import build_cell, local_bytes
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.time()
    init_fake_group(rec["chips"])
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        step, args, meta = build_cell(arch, shape_name, mesh)
        arg_bytes = local_bytes(args)
        outs = []
        report = analyze_step(lambda: outs.append(step(*args)))
        out_bytes = local_bytes(outs)
    finally:
        dist.destroy_process_group()
    report["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": None,
        "note": "per rank, from the local shard shapes; an eager step has no "
                "counterpart of XLA's temporary bytes",
    }
    tag = f"[{arch} x {shape_name} x {rec['mesh']}]"
    print(tag, "memory:", report["memory"])
    print(tag, "flops:", report["flops"], "hbm_bytes:", report["hbm_bytes"],
          "collective_bytes:", report["collective_bytes"])
    rec.update(
        status="OK",
        mode=meta["mode"],
        tokens_per_step=meta["tokens_per_step"],
        trace_s=round(time.time() - t0, 1),
        analysis=report,
        roofline=roofline_from_report(
            cfg, report, chips=rec["chips"], mode=meta["mode"],
            tokens=meta["tokens_per_step"],
        ),
    )
    return rec


def _cell_cmd(arch, shape, multi_pod, out_path):
    cmd = [
        sys.executable, "-m", "repro_torch.launch.dryrun",
        "--arch", arch, "--shape", shape, "--json-out", str(out_path),
    ]
    if multi_pod:
        cmd.append("--multi-pod")
    return cmd


def run_all(multi_pod_options, out_dir: Path, workers: int, archs=None, shapes=None):
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = []
    for mp in multi_pod_options:
        for a in (archs or ARCHS):
            for s in (shapes or SHAPES):
                tag = f"{a}__{s}__{'2x16x16' if mp else '16x16'}"
                cells.append((a, s, mp, out_dir / f"{tag}.json"))
    procs: list = []
    pending = list(cells)
    results = {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    while pending or procs:
        while pending and len(procs) < workers:
            a, s, mp, path = pending.pop(0)
            if path.exists():  # incremental: reuse finished cells
                results[path.name] = json.loads(path.read_text())
                print(f"cached   {path.stem}")
                continue
            log = open(path.with_suffix(".log"), "w")
            p = subprocess.Popen(_cell_cmd(a, s, mp, path), stdout=log,
                                 stderr=subprocess.STDOUT, cwd=str(ROOT), env=env)
            procs.append((p, a, s, mp, path, log, time.time()))
        for item in procs[:]:
            p, a, s, mp, path, log, t0 = item
            rc = p.poll()
            if rc is None:
                if time.time() - t0 > CELL_TIMEOUT_S:
                    p.kill()
                    p.wait()
                    rc = -9
                else:
                    continue
            procs.remove(item)
            log.close()
            if rc == 0 and path.exists():
                results[path.name] = json.loads(path.read_text())
                st = results[path.name].get("status")
                print(f"done     {path.stem}: {st}")
            else:
                rec = {"arch": a, "shape": s, "status": "FAIL", "rc": rc,
                       "mesh": "2x16x16" if mp else "16x16",
                       "log": str(path.with_suffix(".log"))}
                path.write_text(json.dumps(rec))
                results[path.name] = rec
                print(f"FAILED   {path.stem} rc={rc} (log: {rec['log']})")
        time.sleep(0.5)
    n_ok = sum(1 for r in results.values() if r.get("status") == "OK")
    n_skip = sum(1 for r in results.values() if r.get("status") == "SKIP")
    n_fail = sum(1 for r in results.values() if r.get("status") == "FAIL")
    print(f"\n=== dry-run matrix: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"of {len(results)} cells ===")
    (out_dir / "summary.json").write_text(json.dumps(list(results.values()), indent=1))
    return 1 if n_fail else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun"))
    ap.add_argument("--json-out")
    args = ap.parse_args(argv)

    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        sys.exit(run_all(meshes, Path(args.out), args.workers))
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")

    rec = run_cell(args.arch, args.shape, args.multi_pod)
    js = json.dumps(rec, indent=1, default=str)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(js)
    print(js)


if __name__ == "__main__":
    main()
