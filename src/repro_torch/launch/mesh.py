"""Production mesh construction (the JAX package's ``launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group. The mesh shapes are the JAX package's, so the sharding rules
give the same specs on both:

* ``make_production_mesh()``: 16 x 16 (``data``, ``model``), 256 ranks; on
  H100s that is 32 nodes of 8 cards. ``multi_pod=True``: 2 x 16 x 16
  (``pod``, ``data``, ``model``), 512 ranks, 64 nodes of 8.
* ``make_host_mesh(data, model)``: a small mesh for smoke runs.

``model`` is TP/EP/flash-decode. With ``model = 16`` a model group spans
two 8-card NVLink domains, so half of each TP collective crosses the
network between nodes; ``data`` carries FSDP and the batch; ``pod`` only
the weight and gradient collectives. A ``DeviceMesh`` lays its ranks out
row-major, so the ``model`` group of a rank is 16 consecutive ranks.

Each builds a ``DeviceMesh`` over the default process group, whose world
size must be the mesh's size: the caller starts it (``torch.distributed.
init_process_group``, or ``distributed.compat.init_fake_group`` for the
dry-run, which lays out a production mesh with no devices).
"""
from __future__ import annotations

from repro_torch.distributed.compat import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over the default group: smoke runs."""
    return make_mesh((data, model), ("data", "model"), device_type)
