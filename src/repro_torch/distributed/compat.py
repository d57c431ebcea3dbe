"""PyTorch-version shims for meshes, the dry-run's fake process group and
``local_map`` (the JAX package's ``distributed/compat.py`` holds the JAX
ones: ``AbstractMesh``, ``make_mesh``, ``shard_map``).

Every mesh of the port goes through here, so the sharding rules and the
launch code run on the torch versions the port meets (2.11 on the card's
machine, 2.13 on a CPU one):

* ``abstract_mesh(sizes, names)``: a device-free mesh. It carries what the
  rules read, ``shape`` (name -> size, in order) and ``axis_names``; a
  ``DeviceMesh`` needs a process group.
* ``make_mesh(shape, axes)``: ``init_device_mesh`` over the default group,
  whose world size must be the mesh's size.
* ``init_fake_group(world_size)``: the "fake" process group of the dry-run,
  which runs one rank's program and communicates nothing. It is the only
  place that imports the private ``torch.testing._internal`` module.
* ``local_map``: ``shard_map``'s counterpart, a function on each rank's
  local shards of ``DTensor``s.
* ``mesh_shape(mesh)``: name -> size for either kind of mesh (a
  ``DeviceMesh``'s own ``shape`` is a tuple of sizes).
* small ``DTensor`` helpers the model code calls, each the identity on a
  plain tensor: ``is_dtensor`` (free until ``DTensor`` is imported),
  ``reduce_partials``, ``whole`` / ``whole_unless_divides`` (gather along
  a dim), ``gather_fsdp`` (gather over the data axes), ``all_gather``.
"""
from __future__ import annotations

import sys
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch.distributed as dist



def local_map(*args, **kwargs):
    """``torch.distributed.tensor.experimental.local_map`` (imported at the
    first call: the ``DTensor`` package takes a second to import, and a
    model on one device never needs it)."""
    try:  # 2.4+: public
        from torch.distributed.tensor.experimental import local_map as lm
    except ImportError:  # pragma: no cover - older releases
        from torch.distributed._tensor.experimental import local_map as lm
    return lm(*args, **kwargs)


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices and no group."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        sizes_t: Tuple[int, ...] = tuple(int(s) for s in sizes)
        names_t: Tuple[str, ...] = tuple(names)
        if len(sizes_t) != len(names_t):
            raise ValueError(f"mesh rank mismatch: {sizes_t} vs {names_t}")
        self.axis_names = names_t
        self.shape: Dict[str, int] = OrderedDict(zip(names_t, sizes_t))

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(self.shape)})"


def abstract_mesh(sizes: Sequence[int], names: Sequence[str]) -> AbstractMesh:
    """Device-free mesh of the given axis sizes and names."""
    return AbstractMesh(sizes, names)


def mesh_shape(mesh) -> Dict[str, int]:
    """name -> size, in the mesh's order, for an ``AbstractMesh`` or a
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return OrderedDict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"):
    """``init_device_mesh`` of ``shape`` named ``axes`` over the default
    process group (started by the caller)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """Start the "fake" process group of ``world_size`` ranks as this
    process's default group, as rank ``rank``: collectives return at once
    and move nothing, so one process lays out and traces one rank of a
    mesh of any size with no devices (the tensors are on ``meta``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", world_size=int(world_size), rank=int(rank),
                            store=FakeStore())


def all_gather(x, gather_dim: int, group):
    """The functional all-gather along ``gather_dim`` (``all_gather_single``
    from 2.13 on, ``all_gather_tensor`` before; the same call)."""
    import torch.distributed._functional_collectives as funcol

    fn = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return fn(x, gather_dim, group)


def all_gather_autograd(x, gather_dim: int, group):
    """``all_gather`` with a gradient: its backward reduce-scatters
    (``all_gather_single_autograd`` from 2.13 on, ``all_gather_tensor_autograd``
    before), waited for."""
    import torch.distributed._functional_collectives as funcol

    fn = (getattr(funcol, "all_gather_single_autograd", None)
          or funcol.all_gather_tensor_autograd)
    return funcol.wait_tensor(fn(x, gather_dim, group))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``; free when the ``DTensor`` package was
    never imported (then none exists)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def reduce_partials(x):
    """``x`` with every pending partial sum of a ``DTensor`` reduced
    (``Partial`` -> ``Replicate``); a plain tensor as it is. A vocab-sharded
    lookup (embedding, gather) leaves a masked partial whose mask is kept
    for one reduction only, so it is reduced where it is made."""
    if not is_dtensor(x) or not any(pl.is_partial() for pl in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if pl.is_partial() else pl
                                          for pl in x.placements])


def whole_unless_divides(x, dim: int, n: int):
    """``x`` gathered whole along ``dim`` over every mesh dim that splits it
    but does not divide ``n`` (the heads that a view of ``dim`` into (n,
    ...) must split evenly); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    dim = dim % x.ndim
    mesh = x.device_mesh
    bad = [i for i, pl in enumerate(x.placements)
           if pl.is_shard() and pl.dim % x.ndim == dim and n % mesh.size(i)]
    if not bad:
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(mesh, [Replicate() if i in bad else pl
                                 for i, pl in enumerate(x.placements)])


def whole(x, dim: int):
    """``x`` gathered whole along ``dim`` on every rank; a plain tensor as
    it is."""
    return whole_unless_divides(x, dim, 1)


def gather_fsdp(x):
    """A ``DTensor`` gathered whole over the data axes (``pod``, ``data``),
    its other placements kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    fsdp = [i for i, pl in enumerate(x.placements)
            if names[i] in ("pod", "data") and not pl.is_replicate()]
    if not fsdp:
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(mesh, [Replicate() if i in fsdp else pl
                                 for i, pl in enumerate(x.placements)])


def local_shape(shape: Sequence[int], mesh_sizes: Dict[str, int], placements) -> Tuple[int, ...]:
    """One rank's shard shape for ``placements`` (``Shard(d)`` or
    ``Replicate()``, one per mesh dim, in ``mesh_sizes``' order); every
    sharded dim must divide (the rules shard only dims that do)."""
    out = list(int(s) for s in shape)
    for size, pl in zip(mesh_sizes.values(), placements):
        d = getattr(pl, "dim", None)
        if d is not None and pl.is_shard():
            if out[d] % size:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide by {size}")
            out[d] //= size
    return tuple(out)


__all__ = ["AbstractMesh", "abstract_mesh", "all_gather", "all_gather_autograd", "axis_names", "init_fake_group", "is_dtensor",
           "gather_fsdp", "local_map", "local_shape", "make_mesh", "mesh_shape", "reduce_partials",
           "whole", "whole_unless_divides"]
