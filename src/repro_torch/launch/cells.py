"""Cell construction: the step, its inputs placed on a mesh, and the
cell's facts, for one (arch x shape x mesh) cell (the JAX package's
``launch/cells.py``). The dry-run (``launch.dryrun``) traces what
``build_cell`` returns; a run on cards builds the same cell around real
weights (``_build_train`` / ``_build_prefill`` / ``_build_decode`` with
``state=`` or ``params=``, and ``place`` for the JAX package's weights
carried over).

Every input is a ``DTensor`` placed by ``distributed.rules``: the state or
the parameters, the batch, the cache. With no real weights given, the
leaves are ``meta`` tensors (``models.param_shapes``, the counterpart of
``jax.eval_shape(init_params)``), each rank holding only its shard's
shape, so a 400B model is laid out with nothing drawn and nothing
allocated. The step runs the port's own step (``training.steps``,
``serving.engine``) on those ``DTensor``s under the cell's activation
policy, with plain tensors (positions, masks made inside the model)
taken as replicated.

Per-cell tuning (microbatches, activation layout, optimizer state dtype)
lives in ``CELL_TUNING``, with the JAX package's entries.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs import ModelConfig, ShapeConfig, get_arch, get_shape, shape_applicable
from repro_torch.distributed import rules
from repro_torch.distributed.act_sharding import activation_policy
from repro_torch.distributed.compat import is_dtensor, local_shape, mesh_shape
from repro_torch.launch.specs import batch_input_specs, enc_len_for
from repro_torch.models import param_shapes
from repro_torch.serving.engine import cache_shapes, make_decode_step, make_prefill_step
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.training.steps import make_train_step


@dataclass
class CellTuning:
    microbatches: int = 1
    # activation residual layout during train/prefill: 'model' shards d_model
    # over the model axis (Megatron-style), 'none' keeps it replicated on TP
    residual: str = "model"
    remat: Optional[str] = None  # override cfg.remat_policy
    opt_state_dtype: Optional[str] = None


# Key: (arch, shape) or (arch, None); the JAX package's entries.
CELL_TUNING: Dict[Tuple[str, Optional[str]], CellTuning] = {
    ("llama4-maverick-400b-a17b", "train_4k"): CellTuning(
        opt_state_dtype="bfloat16", microbatches=4),
    ("jamba-1.5-large-398b", "train_4k"): CellTuning(
        opt_state_dtype="bfloat16", microbatches=4),
    ("qwen2-vl-72b", "train_4k"): CellTuning(
        opt_state_dtype="float32", microbatches=2),
}


def get_tuning(arch: str, shape: str) -> CellTuning:
    return CELL_TUNING.get((arch, shape)) or CELL_TUNING.get((arch, None)) or CellTuning()


def _opt_cfg(cfg: ModelConfig, tuning: CellTuning) -> OptimizerConfig:
    dt = tuning.opt_state_dtype or (
        "bfloat16" if cfg.param_count() > 1e11 else "float32"
    )
    return OptimizerConfig(state_dtype=dt)


def _apply_remat(cfg: ModelConfig, tuning: CellTuning) -> ModelConfig:
    if tuning.remat and tuning.remat != cfg.remat_policy:
        return dataclasses.replace(cfg, remat_policy=tuning.remat)
    return cfg


# ---------------------------------------------------------------------------
# placing trees on a mesh
# ---------------------------------------------------------------------------


def place_tensor(mesh, t: torch.Tensor, spec: rules.P):
    """``t`` (global) as a ``DTensor`` placed by ``spec``. A ``meta`` tensor
    becomes a meta shard of this rank's shape (nothing moves); a real one is
    cut locally, every rank holding the same values (no rank sends)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = rules.placements(mesh, spec)
    if t.is_meta:
        loc = torch.empty(local_shape(t.shape, mesh_shape(mesh), pl), dtype=t.dtype,
                          device="meta")
        return DTensor.from_local(loc, mesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def place_tree(mesh, tree, specs):
    """Every leaf of ``tree`` placed by the spec at the same path."""
    if isinstance(tree, dict):
        return {k: place_tree(mesh, v, specs[k]) for k, v in tree.items()}
    return place_tensor(mesh, tree.detach(), specs)


def place(cfg: ModelConfig, mesh, params, mode: str, *, zero_shard_decode: bool = False):
    """A parameter tree (the port's tensors, or the JAX package's carried
    over by ``models.convert.params_from_numpy``) distributed by the rules
    of ``mode``."""
    specs = rules.tree_param_specs(cfg, mesh, params, mode=mode,
                                   zero_shard_decode=zero_shard_decode)
    return place_tree(mesh, params, specs)


def place_state(cfg: ModelConfig, mesh, state):
    """A train state {"params", "opt"} distributed by the train rules (the
    optimizer state mirrors the parameters; its step is replicated)."""
    return {"params": place(cfg, mesh, state["params"], "train"),
            "opt": place_tree(mesh, state["opt"],
                              rules.tree_opt_specs(cfg, mesh, state["opt"]))}


def place_batch(cfg: ModelConfig, mesh, batch: Dict[str, torch.Tensor], mode: str):
    """Batch inputs (tokens, masks, positions, encoder embeds) over the data
    axes where their batch divides."""
    specs = rules.batch_specs(cfg, mesh, batch, mode=mode)
    return {k: place_tensor(mesh, v, specs[k]) for k, v in batch.items()}


def _zeros_placed(mesh, shapes, specs, device):
    """A tree of zeros shaped as ``shapes``, each rank allocating only its
    shard on ``device`` (``meta``: nothing)."""
    from torch.distributed.tensor import DTensor

    if isinstance(shapes, dict):
        return {k: _zeros_placed(mesh, v, specs[k], device) for k, v in shapes.items()}
    pl = rules.placements(mesh, specs)
    loc = torch.zeros(local_shape(shapes.shape, mesh_shape(mesh), pl), dtype=shapes.dtype,
                      device=device)
    return DTensor.from_local(loc, mesh, pl, run_check=False, shape=shapes.shape,
                              stride=shapes.stride())


def _device(tree) -> torch.device:
    leaf = T.leaves(tree)[0]
    return leaf.to_local().device if is_dtensor(leaf) else leaf.device


def _plain(x):
    """A ``DTensor`` result gathered whole (a metric, a logit)."""
    return x.full_tensor() if is_dtensor(x) else x


def _in_cell(fn: Callable, policy) -> Callable:
    """``fn`` run with plain tensors taken as replicated and the cell's
    activation policy set."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        with implicit_replication(), activation_policy(policy):
            return fn(*args)

    return run


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh):
    """Returns (step, args tuple, meta dict): ``step(*args)`` runs the cell
    once on the ``meta`` inputs placed on ``mesh``.

    Raises ValueError for inapplicable cells (see shape_applicable)."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"SKIP: {reason}")
    tuning = get_tuning(arch, shape_name)
    cfg = _apply_remat(cfg, tuning)
    if shape.kind == "train":
        return _build_train(cfg, shape, mesh, tuning)
    if shape.kind == "prefill":
        return _build_prefill(cfg, shape, mesh, tuning)
    return _build_decode(cfg, shape, mesh, tuning)


def _residual_policy(mesh, tuning: CellTuning, batch: int) -> Dict[str, rules.P]:
    """The residual's layout: rows over the data axes where ``batch`` divides
    them and is more than one row (as ``place_batch`` places the inputs; a
    ``DTensor`` cannot reshape a one-row dim split even over a one-rank
    axis), d_model over ``model`` per ``tuning``."""
    F = rules.fsdp_axes(mesh)
    b_ax = F if batch % rules.dp_size(mesh) == 0 and batch > 1 else None
    return {"residual": rules.P(b_ax, None, "model" if tuning.residual == "model" else None)}


def _build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, tuning: CellTuning, *,
                 state=None, opt_cfg: Optional[OptimizerConfig] = None):
    """The train cell. ``state`` (a real {"params", "opt"} tree, placed or
    not) replaces the meta state; ``opt_cfg`` the cell's optimizer."""
    opt_cfg = opt_cfg or _opt_cfg(cfg, tuning)
    if state is None:
        params = param_shapes(cfg)
        state = {"params": params, "opt": adamw_init(opt_cfg, params)}
    if not is_dtensor(T.leaves(state["params"])[0]):
        state = place_state(cfg, mesh, state)
    batch = place_batch(cfg, mesh, batch_input_specs(cfg, shape), "train")
    pol = _residual_policy(mesh, tuning, shape.global_batch)
    inner = _in_cell(make_train_step(cfg, opt_cfg, microbatches=tuning.microbatches), pol)

    def train_step(state, batch):
        state, metrics = inner(state, batch)
        return state, {k: _plain(v) for k, v in metrics.items()}

    meta = {
        "mode": "train",
        "tokens_per_step": shape.global_batch * shape.seq_len,
        "policy": pol,
        "opt_state_dtype": opt_cfg.state_dtype,
        "microbatches": tuning.microbatches,
    }
    return train_step, (state, batch), meta


def _build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, tuning: CellTuning, *,
                   params=None):
    """The prefill cell; ``params`` (real, placed or not) replace the meta
    ones, and the cache is then allocated (each rank its shard) beside them."""
    if params is None:
        params = param_shapes(cfg)
    if not is_dtensor(T.leaves(params)[0]):
        params = place(cfg, mesh, params, "prefill")
    batch = place_batch(cfg, mesh, batch_input_specs(cfg, shape), "prefill")
    enc_len = enc_len_for(cfg, shape.seq_len) if cfg.is_encoder_decoder else 0
    cshape = cache_shapes(cfg, shape.global_batch, shape.seq_len, enc_len)
    cache = _zeros_placed(mesh, cshape, rules.tree_cache_specs(cfg, mesh, cshape),
                          _device(params))
    pol = _residual_policy(mesh, tuning, shape.global_batch)
    step = _in_cell(make_prefill_step(cfg), pol)
    meta = {
        "mode": "prefill",
        "tokens_per_step": shape.global_batch * shape.seq_len,
        "policy": pol,
    }
    return step, (params, batch, cache), meta


def _build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, tuning: CellTuning, *,
                  params=None):
    """The decode cell (one step); ``params`` as for ``_build_prefill``. The
    cache (zeros) is sized ``shape.seq_len``; a run fills it with the
    prefill cell's step first."""
    zero = rules.needs_zero_decode(cfg, mesh)
    if params is None:
        params = param_shapes(cfg)
    if not is_dtensor(T.leaves(params)[0]):
        params = place(cfg, mesh, params, "decode", zero_shard_decode=zero)
    B = shape.global_batch
    enc_len = enc_len_for(cfg, shape.seq_len) if cfg.is_encoder_decoder else 0
    cshape = cache_shapes(cfg, B, shape.seq_len, enc_len)
    cache = _zeros_placed(mesh, cshape, rules.tree_cache_specs(cfg, mesh, cshape),
                          _device(params))
    F = rules.fsdp_axes(mesh)
    b_ax = F if (B % rules.dp_size(mesh) == 0 and B > 1) else None
    inputs = place_batch(cfg, mesh, {
        "tokens": torch.empty((B, 1), dtype=torch.int32, device="meta"),
        "positions": torch.empty((B,), dtype=torch.int32, device="meta")}, "decode")
    pol = {"residual": rules.P(b_ax, None, None)}
    step = _in_cell(make_decode_step(cfg), pol)
    meta = {
        "mode": "decode",
        "tokens_per_step": B,
        "policy": pol,
        "zero_shard_decode": zero,
    }
    return step, (params, inputs["tokens"], inputs["positions"], cache), meta


def local_bytes(tree: Any) -> int:
    """This rank's bytes of the tensors in ``tree`` (a ``DTensor`` counts its
    shard)."""
    total = 0
    for leaf in T.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            loc = leaf.to_local() if is_dtensor(leaf) else leaf
            total += loc.numel() * loc.element_size()
    return total
