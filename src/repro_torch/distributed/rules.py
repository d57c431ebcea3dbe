"""Sharding rules: tree paths -> partition specs -> ``DTensor`` placements.

The JAX package's ``distributed/rules.py``, rule for rule, on the port's
nested dicts of tensors (real or ``meta``). One rules table per execution
mode:

* ``train`` / ``prefill``: FSDP over the data axes (``pod`` + ``data``)
  stacked on TP over ``model``. Every weight and optimizer tensor is sharded
  on *both* axes; ``DTensor`` all-gathers a weight where an op needs it
  whole and reduce-scatters its gradient. MoE experts shard over ``model``
  (EP); the ``pod`` axis only ever carries gradient and weight collectives.
* ``decode``: weights TP over ``model`` (plus ZeRO-style ``data`` sharding
  when the TP shard would not fit the card's memory: the 398B/400B archs);
  the KV cache shards batch over ``data`` and *sequence over model*
  (flash-decode: each shard's partial softmax, then a small merge across
  shards, ``distributed.local``).

GQA: the k/v projections are *replicated* over ``model`` when
``num_kv_heads`` does not divide by the model axis (Megatron-style); the q
path carries the TP, and each rank's attention takes the KV heads of its
own query heads (``distributed.local``).

A spec is a ``P``: a tuple with one entry per tensor dim, each ``None``
(replicated), an axis name, or a tuple of axis names (the first the
major one), as a JAX ``PartitionSpec``, so the two packages' specs compare
leaf by leaf. ``named(mesh, specs)`` turns each into ``DTensor`` placements,
one per mesh dim: ``Shard(d)`` where the spec puts that axis on dim ``d``,
``Replicate()`` elsewhere.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Optional, Tuple

from repro_torch.analysis.roofline import HBM_BYTES
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compat import axis_names, mesh_shape


def _entry(e):
    """One dim's entry as JAX keeps it: an empty tuple is None, a 1-tuple
    its one name."""
    if isinstance(e, (tuple, list)):
        if not e:
            return None
        return e[0] if len(e) == 1 else tuple(e)
    return e


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``;
    its entries are kept as a JAX ``PartitionSpec`` keeps them."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def path_str(path) -> str:
    """A leaf's path, its keys joined by "/" (``layers/sub0/mixer/wq``); a
    string is returned as it is."""
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def mesh_axes(mesh) -> Tuple[str, ...]:
    return axis_names(mesh)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def dp_size(mesh) -> int:
    sizes = mesh_shape(mesh)
    return _prod(sizes[a] for a in fsdp_axes(mesh))


def tp_size(mesh) -> int:
    return int(mesh_shape(mesh).get("model", 1))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------


def _kv_tp_ok(cfg: ModelConfig, mesh) -> bool:
    return cfg.num_kv_heads % tp_size(mesh) == 0


def param_spec(
    cfg: ModelConfig,
    mesh,
    path: str,
    shape: Tuple[int, ...],
    *,
    mode: str,
    zero_shard_decode: bool = False,
) -> P:
    """The spec of one parameter. ``path`` is its "/"-joined tree path.

    Layer-stack params carry a leading ``num_periods`` axis (never sharded).
    """
    sizes = mesh_shape(mesh)
    F = fsdp_axes(mesh)  # ('pod','data') or ('data',)
    Mx = "model"
    train = mode in ("train", "prefill")
    # in decode, weights are TP-sharded; optionally ZeRO over data for giants
    Fw: Tuple[str, ...] = F if (train or zero_shard_decode) else ()

    def fs(i: int) -> Optional[Tuple[str, ...]]:
        """fsdp axes if the dim divides, else None (replicated)."""
        if not Fw:
            return None
        d = _prod(sizes[a] for a in Fw)
        return Fw if shape[i] % d == 0 else None

    def mp(i: int):
        return Mx if shape[i] % tp_size(mesh) == 0 else None

    lead = (None,) if re.search(r"(layers|enc_layers)/", path) else ()
    n = len(shape) - len(lead)

    # --- embeddings
    if path.endswith("embed/embedding"):
        return P(mp(0), fs(1))
    if path.endswith("embed/lm_head"):
        return P(fs(0), mp(1))
    # --- attention
    if re.search(r"mixer/wq$|cross/wq$", path):
        return P(*lead, fs(-2), mp(-1))
    if re.search(r"mixer/w[kv]$|cross/w[kv]$", path):
        kv = Mx if _kv_tp_ok(cfg, mesh) else None
        return P(*lead, fs(-2), kv)
    if re.search(r"mixer/wo$|cross/wo$", path):
        return P(*lead, mp(-2), fs(-1))
    if re.search(r"b[qkv]$", path):
        return P(*lead, None)
    # --- MoE (leading expert axis after the period axis) -- before the
    # dense-mlp patterns, which would otherwise swallow the 3D expert weights
    if re.search(r"ffn/router$", path):
        return P(*lead, fs(-2), None)
    if n == 3 and re.search(r"ffn/w[gud]$", path):  # (E, d_in, d_out)
        e = Mx if shape[len(lead)] % tp_size(mesh) == 0 else None
        return P(*lead, e, fs(-2) if train else None, None)
    # --- dense mlp
    if re.search(r"ffn/w[gu]$|shared/w[gu]$", path):
        return P(*lead, fs(-2), mp(-1))
    if re.search(r"ffn/wd$|shared/wd$", path):
        return P(*lead, mp(-2), fs(-1))
    # --- mamba
    if re.search(r"mixer/in_proj$", path):
        return P(*lead, fs(-2), mp(-1))
    if re.search(r"mixer/out_proj$", path):
        return P(*lead, mp(-2), fs(-1))
    if re.search(r"mixer/conv_[wb]$|mixer/(A_log|D|dt_bias|norm)$", path):
        return P(*lead, *([None] * n))
    # --- norms and everything else: replicated (tiny)
    return P(*lead, *([None] * n))


# ---------------------------------------------------------------------------
# activation / batch / cache rules
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, mesh, batch_shapes: dict, *, mode: str) -> dict:
    """Specs for a batch dict (tokens, positions, encoder embeds); a value
    is a tensor or a shape."""
    F = fsdp_axes(mesh)
    bdim = dp_size(mesh)
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        b_ax = F if shape[0] % bdim == 0 and shape[0] > 1 else None
        if k == "mrope_positions":  # (3, B, S)
            b2 = F if shape[1] % bdim == 0 and shape[1] > 1 else None
            out[k] = P(None, b2, None)
        elif k == "positions":  # (B,)
            out[k] = P(b_ax)
        else:
            out[k] = P(b_ax, *([None] * (len(shape) - 1)))
    return out


def cache_spec(cfg: ModelConfig, mesh, path: str, shape: Tuple[int, ...]) -> P:
    """Decode-cache sharding. Leaves carry a leading num_periods axis.

    k/v: (P, B, L, Hkv, Dh) -> batch over data, **sequence over model**
    (flash-decode); ssm: (P, B, H, hp, N) -> batch over data, heads over
    model; conv: (P, B, W-1, C) -> batch over data, channels over model.
    """
    F = fsdp_axes(mesh)
    bdim = dp_size(mesh)
    b_ax = F if shape[1] % bdim == 0 and shape[1] > 1 else None
    t = tp_size(mesh)
    if re.search(r"/(k|v|ck|cv)$", path):
        l_ax = "model" if shape[2] % t == 0 else None
        return P(None, b_ax, l_ax, None, None)
    if path.endswith("/ssm"):
        h_ax = "model" if shape[2] % t == 0 else None
        return P(None, b_ax, h_ax, None, None)
    if path.endswith("/conv"):
        c_ax = "model" if shape[3] % t == 0 else None
        return P(None, b_ax, None, c_ax)
    return P(*([None] * len(shape)))


# ---------------------------------------------------------------------------
# tree-level entry points
# ---------------------------------------------------------------------------


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict (or list) of leaves, keeping its
    structure; the JAX ``tree_map_with_path`` with ``path_str`` paths."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def tree_param_specs(cfg: ModelConfig, mesh, params_shapes, *, mode: str,
                     zero_shard_decode: bool = False):
    """Map a params tree (of tensors, meta or real) to specs."""
    return map_with_path(
        lambda path, leaf: param_spec(cfg, mesh, path, tuple(leaf.shape), mode=mode,
                                      zero_shard_decode=zero_shard_decode),
        params_shapes)


def tree_cache_specs(cfg: ModelConfig, mesh, cache_shapes):
    return map_with_path(lambda path, leaf: cache_spec(cfg, mesh, path, tuple(leaf.shape)),
                         cache_shapes)


def tree_opt_specs(cfg: ModelConfig, mesh, opt_shapes, *, mode: str = "train"):
    """Optimizer state mirrors the param sharding; scalars replicated."""
    def one(ps, leaf):
        if ps.endswith("step") or leaf.ndim == 0:
            return P()
        # strip the leading 'm/' or 'v/' component so param rules match
        inner = ps.split("/", 1)[1] if "/" in ps else ps
        return param_spec(cfg, mesh, inner, tuple(leaf.shape), mode=mode)
    return map_with_path(one, opt_shapes)


def placements(mesh, spec: P, ndim: Optional[int] = None):
    """``DTensor`` placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec names that axis on tensor dim ``d``,
    ``Replicate()`` where it names it nowhere."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                where[ax] = d
    out = []
    for ax in axis_names(mesh):
        out.append(Shard(where[ax]) if ax in where else Replicate())
    return tuple(out)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as its placements on ``mesh``."""
    def conv(t):
        if isinstance(t, P):
            return placements(mesh, t)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return t
    return conv(spec_tree)


def needs_zero_decode(cfg: ModelConfig, mesh, hbm_bytes: int = HBM_BYTES) -> bool:
    """True if TP-only weights would overflow 60 % of a card's memory
    (``hbm_bytes``, the H100's by default; the 398B/400B archs)."""
    bytes_per = 2 if cfg.param_dtype == "bfloat16" else 4
    return cfg.param_count() * bytes_per / tp_size(mesh) > 0.6 * hbm_bytes
