"""Build and load the hand-written CUDA kernels (nvcc -> shared library ->
ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``<repo>/build/kernels/<name>-<hash>.so`` at first use, for
``sm_90a``. The hash covers the source, every shared header
``csrc/*.cuh`` and the nvcc flags, so a changed source or header gets a
new hash and is rebuilt; an unchanged one is loaded from the build
directory. Several sources build in parallel
(one ``nvcc`` each, all started together). Nothing here runs at import
time: the CPU tests import this module and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds spent in nvcc per source by this process (0.0 when it was cached)
build_seconds: Dict[str, float] = {}
#: what ``-Xptxas -v`` printed per source (registers, shared memory, spills)
ptxas_log: Dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no up-to-date library,
    all in parallel; raise with nvcc's output if any fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    t0 = time.monotonic()
    for n, out in targets.items():
        if out.exists():
            build_seconds.setdefault(n, 0.0)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_seconds[n] = time.monotonic() - t0
        ptxas_log[n] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
        os.replace(tmp, targets[n])  # atomic: a reader never sees half a file
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
