"""Fault-tolerant checkpointing in the JAX package's on-disk format, so that
each package restores what the other wrote (``checkpoint/manager.py``
there):

* **atomic commit** — shards are written to ``step_N.tmp/`` and renamed into
  place only after every shard and the manifest fsync; a crashed writer can
  never produce a readable-but-corrupt checkpoint;
* **sharded layout** — each host writes the leaves it owns (every
  ``num_hosts``-th key in sorted order) to ``shard_XXXXX.msgpack.zst``: a
  MessagePack map of its codec, per-key meta (shape, dtype, sha256[:16],
  bytes) and compressed data; host 0 writes ``manifest.json`` last;
* **content hashes** — every leaf's sha256 prefix is verified on load; a bad
  shard fails fast with its path;
* **retention** — keep the newest K checkpoints (plus any 'milestone' every
  M steps), delete the rest;
* **auto-resume** — ``latest_step()`` scans the directory.

The port's differences: the MessagePack codec is its own
(``msgpack_subset``; the card's machine has no ``msgpack``); ``zstandard``
is used where it is installed, else stdlib zlib, and the shard names the
codec it used, as the reference's fallback does; a bf16 leaf is written and
read as its raw 16-bit words under the dtype name ``"bfloat16"`` (numpy has
no bf16 without ``ml_dtypes``). Leaf keys are the JAX ``_path_str`` of a
sorted-key flatten (``repro_torch.tree``). Tensors are copied to the host
to be written; ``restore`` puts each leaf on the device and in the dtype of
the matching leaf of ``like``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import msgpack_subset

try:  # optional: fall back to stdlib zlib when the wheel is absent
    import zstandard as zstd
except ImportError:  # pragma: no cover - exercised on zstd-less installs
    zstd = None


class _ZlibCompressor:
    """Stdlib stand-in for ``zstd.ZstdCompressor`` (same duck type)."""

    def __init__(self, level: int = 6):
        self.level = min(max(level, 1), 9)

    def compress(self, buf: bytes) -> bytes:
        return zlib.compress(buf, self.level)


class _ZlibDecompressor:
    def decompress(self, blob: bytes, max_output_size: int = 0) -> bytes:
        return zlib.decompress(blob)


def _codec_name() -> str:
    return "zstd" if zstd is not None else "zlib"


def _compressor(level: int):
    if zstd is not None:
        return zstd.ZstdCompressor(level=level)
    return _ZlibCompressor(level)


def _decompressor(codec: str):
    if codec == "zstd":
        if zstd is None:
            raise IOError(
                "checkpoint was written with zstd but the 'zstandard' "
                "package is not installed; pip install zstandard to restore"
            )
        return zstd.ZstdDecompressor()
    if codec == "zlib":
        return _ZlibDecompressor()
    raise IOError(f"unknown checkpoint codec {codec!r}")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array whose bytes are the leaf's, the dtype name to record)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_buffer(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(buf, np.int16).reshape(shape).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy())


def _unflatten_like(like, flat: Dict[str, torch.Tensor]):
    out = []
    for key, leaf in T.items(like):
        t = flat[key]
        if torch.is_tensor(leaf):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        out.append(t)
    return T.unflatten(like, out)


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        milestone_every: int = 0,
        zstd_level: int = 3,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.milestone_every = milestone_every
        self.zstd = zstd_level

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, state: Any, *, host_id: int = 0, num_hosts: int = 1,
             extra: Optional[dict] = None) -> Path:
        """Atomic sharded save. Each host writes its shard file; host 0
        writes the manifest last and commits via rename."""
        flat = dict(T.items(state))
        keys = sorted(flat)
        my_keys = [k for i, k in enumerate(keys) if i % num_hosts == host_id]
        tmp = self.dir / f"step_{step:010d}.tmp"
        tmp.mkdir(parents=True, exist_ok=True)

        cctx = _compressor(self.zstd)
        shard_meta = {}
        payload = {}
        for k in my_keys:
            a, dtype = _to_numpy(torch.as_tensor(flat[k]))
            buf = a.tobytes()
            payload[k] = cctx.compress(buf)
            shard_meta[k] = {
                "shape": list(a.shape),
                "dtype": dtype,
                "sha256": hashlib.sha256(buf).hexdigest()[:16],
                "bytes": len(buf),
            }
        shard_path = tmp / f"shard_{host_id:05d}.msgpack.zst"
        with open(shard_path, "wb") as f:
            f.write(msgpack_subset.packb({"codec": _codec_name(), "meta": shard_meta,
                                          "data": payload}))
            f.flush()
            os.fsync(f.fileno())

        if host_id == 0:
            manifest = {
                "step": step,
                "num_hosts": num_hosts,
                "keys": keys,
                "extra": extra or {},
            }
            mpath = tmp / "manifest.json"
            mpath.write_text(json.dumps(manifest, indent=1))
            with open(mpath) as f:
                os.fsync(f.fileno())
            final = self._step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)  # the atomic commit point
            self._gc()
            return final
        return tmp

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(self.steps())
        victims = []
        for s in steps[:-self.keep] if self.keep else []:
            if self.milestone_every and s % self.milestone_every == 0:
                continue
            victims.append(s)
        for s in victims:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: each leaf on the device
        and in the dtype of ``like``'s leaf at the same key."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        flat: Dict[str, torch.Tensor] = {}
        for shard in sorted(d.glob("shard_*.msgpack.zst")):
            blob = msgpack_subset.unpackb(shard.read_bytes())
            dctx = _decompressor(blob.get("codec", "zstd"))
            for k, meta in blob["meta"].items():
                buf = dctx.decompress(blob["data"][k],
                                      max_output_size=meta["bytes"] or 1)
                if hashlib.sha256(buf).hexdigest()[:16] != meta["sha256"]:
                    raise IOError(f"checksum mismatch in {shard}:{k}")
                flat[k] = _from_buffer(buf, meta["dtype"], meta["shape"])
        missing = set(manifest["keys"]) - set(flat)
        if missing:
            raise IOError(f"checkpoint step {step} missing shards for: {sorted(missing)[:5]}")
        return _unflatten_like(like, flat)

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        s = self.latest_step()
        if s is None:
            return None, like
        return s, self.restore(s, like)
