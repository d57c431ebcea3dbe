"""A step's FLOPs and bytes, counted op by op as eager PyTorch runs them.

Replaces the JAX package's ``analysis/hlo_analysis.py``. That module
parses the compiled XLA HLO text; PyTorch has no HLO, so the name differs:
here ``analyze_step(fn, *args, **kwargs)`` runs ``fn`` once under a
``TorchDispatchMode`` and counts every aten op it dispatches, in the
forward, under ``inference_mode`` and in autograd's backward alike. It
returns a report with the keys ``roofline.roofline_from_report`` reads:

* ``flops``          -- product FLOPs plus elementwise and reduction FLOPs;
* ``dot_flops``      -- the products alone: ``mm``, ``bmm``, ``addmm``,
                        ``baddbmm`` and ``convolution`` count 2 prod(out) K,
                        and the hand kernels count their own products;
* ``hbm_bytes``      -- operand bytes plus result bytes of every op (gathers
                        and scatters as below). In
                        eager PyTorch each aten op is its own launch, so this
                        is the eager program's traffic, not an upper bound;
* ``hbm_bytes_fused``-- the same without the elementwise ops and casts: the
                        traffic left if those fused into their neighbours;
* ``collective_bytes`` and ``collective_traffic_bytes`` -- the c10d
                        collectives' operand sizes (and the functional
                        collectives' that ``DTensor`` issues), and a
                        per-rank traffic estimate with ring factors, as
                        ``hlo_analysis`` does;
* ``by_op``          -- count, flops and bytes per aten op;
* ``by_product``     -- the same per product op and operand shapes
                        (``"aten.mm (4096, 1536) @ (1536, 6448)"``), the
                        products' ``by_op`` rows split by shape;
* ``by_kernel``      -- calls, flops and bytes per hand kernel.

An elementwise op (one PyTorch tags ``pointwise``) counts one flop per
output element, a reduction one per input element; copies, casts, views
and allocations count no flops, and views and allocations no bytes. As
``hlo_analysis`` counts dynamic slices and scatters, a gather (an
embedding lookup, an index) moves 2 x its result's bytes and a scatter
(a cache write) 3 x its update's, not the whole table.
Composite ops (``linear``, ``matmul``, ``einsum``, ``reshape``), which the
mode sees whole under ``inference_mode``, are counted through their
decompositions, so a step counts the same with and without autograd.

The hand kernels launch through ``ctypes``, so the dispatcher never sees
them. ``kernels.ops`` counts each call of ``flash_attention``,
``decode_attention`` and ``ssd_scan`` here as one unit of work, priced by
``roofline``'s formulas (``attention_bound_ms``, ``decode_bound_ms`` with
the call's lengths, ``ssd_bound_ms``), and each of their backwards as
another (``attention_bwd_bound_ms``, ``ssd_bwd_bound_ms``); so are
``flash_attention_lse`` (a forward) and ``flash_attention_bwd`` (a
backward), which attention split by query rows calls directly. The aten ops
inside a unit, the plain versions' included, are not counted, so a step
gives the same report whether the kernels or the plain versions run, on
the CPU and on the card. A unit's outputs (and its backward's gradients)
leave it contiguous, as the kernels write them, so the ops around it are
the same on both routes. A
unit that takes a gradient runs its route's own forward and backward inside
a ``torch.autograd.Function``, whose backward is the unit's backward call;
the tensors that route saves are kept until that backward, even under
remat. With no analysis running, ``kernels.ops`` pays one ``None`` check.

On ``DTensor``s (a cell's step on a mesh) the mode lets ``DTensor`` run
each op and counts what it runs on this rank: the local ops on the
shards' shapes and the collectives of its redistributions. What
``DTensor`` runs to choose a layout is not work and is not counted: the
ops on fake tensors that find the global shapes, and the ops (chunks,
concatenations, index ranges, empty shards) that price each candidate
layout's redistributions while it propagates an op's shardings, or plan
a redistribution, on plain tensors (``_propagation_uncounted``). So a
dry-run's report is one rank's, and the same whether ``DTensor``'s
caches of those choices are cold or warm.

Eager mode runs every layer of a stack, so the JAX package's trip-count
multiplication has no counterpart: a loop of L layers counts L times.

``analyze_step`` counts the calling thread and autograd's (which the mode
follows); it is not reentrant.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import roofline
from repro_torch.kernels import ops as _ops

aten = torch.ops.aten

_PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution}
# one flop per input element
_REDUCTIONS = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.prod,
    aten.argmax, aten.argmin, aten.var, aten.var_mean, aten.std, aten.norm,
    aten.linalg_vector_norm, aten.logsumexp, aten.cumsum, aten._softmax,
    aten._log_softmax, aten._softmax_backward_data, aten._log_softmax_backward_data,
    aten.nll_loss_forward, aten.nll_loss_backward, aten.topk, aten.sort,
}
# move data but compute nothing
_COPIES = {aten.clone, aten._to_copy, aten.copy_, aten.copy}
# touch no memory: allocations and metadata
_NO_BYTES = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten._unsafe_view, aten.detach, aten.alias,
    aten.lift_fresh, aten._local_scalar_dense, aten.resize_, aten.set_,
}
# read (and write) only the rows they gather: 2 x the result's bytes, as
# hlo_analysis counts a dynamic slice
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index}
# write only their updates: 3 x the update's bytes (read it, read and write
# the slots), as hlo_analysis counts a scatter
_SCATTERS = {aten.index_put_, aten.index_put, aten.scatter, aten.scatter_, aten.scatter_add,
             aten.scatter_add_, aten.index_add, aten.index_add_, aten.index_copy_}
# c10d op (and the functional collectives ``DTensor`` issues, namespace
# ``_c10d_functional``) -> (collective, index of its operand argument)
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0), "all_reduce_coalesced": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0), "broadcast": ("broadcast", 0),
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1), "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("broadcast", 0),
}


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _product_key(packet, args) -> str:
    """A product's op and its two operands' shapes."""
    a, b = (args[1], args[2]) if packet in (aten.addmm, aten.baddbmm) else (args[0], args[1])
    return f"{packet} {tuple(a.shape)} @ {tuple(b.shape)}"


def _product_flops(packet, args, out) -> float:
    if packet in (aten.mm, aten.bmm):
        return 2.0 * out.numel() * args[0].shape[-1]
    if packet in (aten.addmm, aten.baddbmm):
        return 2.0 * out.numel() * args[1].shape[-1]
    # convolution: K = (input channels / groups) x the kernel's size
    inp, weight, transposed = args[0], args[1], args[6]
    if transposed:  # weight (Cin, Cout / groups, *kernel)
        return 2.0 * inp.numel() * weight[0].numel()
    return 2.0 * out.numel() * weight[0].numel()


# ---------------------------------------------------------------------------
# the hand kernels' work, from roofline's formulas
# ---------------------------------------------------------------------------

Work = Tuple[float, float]  # (flops, bytes)


def _attention_work(q, k, v, *, causal=True, **_) -> Dict[str, Work]:
    shape = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
             bool(causal))
    return {"flash_attention": roofline.attention_bound_ms(shape, q.dtype)[2:],
            "flash_attention_bwd": roofline.attention_bwd_bound_ms(shape, q.dtype)[2:]}


def _attention_bwd_work(q, k, v, o, lse, do, *, causal=True, **_) -> Dict[str, Work]:
    shape = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
             bool(causal))
    return {"flash_attention_bwd": roofline.attention_bwd_bound_ms(shape, q.dtype)[2:]}


def _decode_work(q, k_cache, v_cache, lengths, **_) -> Dict[str, Work]:
    B, L, Hkv, Dh = k_cache.shape
    # what this call's data needs; a dry-run's lengths (meta) hold no data,
    # and its cache is counted full
    lens = [L] * B if lengths.is_meta else lengths.clamp(0, L).tolist()
    return {"decode_attention":
            roofline.decode_bound_ms((B, L, q.shape[2], Hkv, Dh), lens, q.dtype)[2:]}


def _ssd_work(x, dt, A, Bm, Cm, *, chunk=128, **_) -> Dict[str, Work]:
    shape = (*x.shape, Bm.shape[-1], chunk)
    return {"ssd_scan": roofline.ssd_bound_ms(shape, x.dtype)[2:],
            "ssd_scan_bwd": roofline.ssd_bwd_bound_ms(shape, x.dtype)[2:]}


UNIT_WORK: Dict[str, Callable[..., Dict[str, Work]]] = {
    "flash_attention": _attention_work,
    "flash_attention_bwd": _attention_bwd_work,
    "decode_attention": _decode_work,
    "ssd_scan": _ssd_work,
}


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@dataclass
class OpReport:
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_fused: float = 0.0
    collective_bytes: float = 0.0
    collective_traffic_bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)    # collective -> operand bytes
    collective_counts: Dict[str, int] = field(default_factory=dict)
    by_op: Dict[str, Dict[str, float]] = field(default_factory=dict)
    by_product: Dict[str, Dict[str, float]] = field(default_factory=dict)
    by_kernel: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_fused": self.hbm_bytes_fused,
            "collective_bytes": self.collective_bytes,
            "collective_traffic_bytes": self.collective_traffic_bytes,
            "collectives": dict(self.collectives),
            "collective_counts": dict(self.collective_counts),
            "by_op": {k: dict(v) for k, v in self.by_op.items()},
            "by_product": {k: dict(v) for k, v in self.by_product.items()},
            "by_kernel": {k: dict(v) for k, v in self.by_kernel.items()},
        }


def _same(t):
    return t


class _Unit(torch.autograd.Function):
    """A hand kernel's call that takes a gradient, as one unit each way:
    the forward runs the route's own autograd graph inside (its ops not
    counted), the backward differentiates that graph and counts the unit's
    backward."""

    @staticmethod
    def forward(ctx, counter, bwd_work, fn, *args):
        with counter.inside(), torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_same, _same):
            ins = [a.detach().requires_grad_(a.requires_grad) if isinstance(a, torch.Tensor)
                   else a for a in args]
            out = fn(*ins)
            single = isinstance(out, torch.Tensor)
            outs = tuple(o.contiguous() for o in ((out,) if single else out))
        ctx.counter, ctx.bwd_work, ctx.ins, ctx.outs = counter, bwd_work, ins, outs
        ctx.set_materialize_grads(False)
        res = tuple(o.detach() for o in outs)
        return res[0] if single else res

    @staticmethod
    def backward(ctx, *grads):
        counter, ins, outs = ctx.counter, ctx.ins, ctx.outs
        ctx.ins = ctx.outs = None
        need = [a for a in ins if isinstance(a, torch.Tensor) and a.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        counter.add_unit(*ctx.bwd_work)
        with counter.inside():
            got = iter([None if g is None else g.contiguous() for g in torch.autograd.grad(
                [o for o, _ in pairs], need, [g for _, g in pairs], allow_unused=True)])
        return (None, None, None,
                *(next(got) if isinstance(a, torch.Tensor) and a.requires_grad else None
                  for a in ins))


class _Counter(TorchDispatchMode):
    """Counts the aten ops it sees into ``report``, except inside a hand
    kernel's unit (``depth`` > 0), whose work ``unit`` counts whole."""

    def __init__(self, report: OpReport):
        super().__init__()
        self.report = report
        self.depth = 0
        self._lock = threading.Lock()

    # -- the hand kernels (called by kernels.ops) --------------------------
    def outside(self) -> bool:
        return self.depth == 0

    @contextmanager
    def inside(self):
        with self._lock:
            self.depth += 1
        try:
            yield
        finally:
            with self._lock:
                self.depth -= 1

    def add_unit(self, name: str, work: Work) -> None:
        flops, nbytes = work
        rep = self.report
        with self._lock:
            row = rep.by_kernel.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            row["calls"] += 1
            row["flops"] += flops
            row["bytes"] += nbytes
            rep.flops += flops
            rep.dot_flops += flops
            rep.hbm_bytes += nbytes
            rep.hbm_bytes_fused += nbytes

    def unit(self, kind: str, fn, *args, **kwargs):
        """One call of the hand kernel ``kind`` through ``fn`` (``kernels.ops``'s
        entry point, which runs its route while this is inside a unit)."""
        with self.inside():
            works = UNIT_WORK[kind](*args, **kwargs)
        self.add_unit(kind, works[kind])
        bwd = f"{kind}_bwd"
        # tensors passed by keyword (an initial state) become positional, so
        # that the Function returns their gradients too
        names = [k for k, v in kwargs.items() if isinstance(v, torch.Tensor)]
        tensors = (*args, *(kwargs[k] for k in names))
        if torch.is_grad_enabled() and bwd in works and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
            rest = {k: v for k, v in kwargs.items() if k not in names}

            def call(*ins):
                return fn(*ins[:len(args)], **rest, **dict(zip(names, ins[len(args):])))

            return _Unit.apply(self, (bwd, works[bwd]), call, *tensors)
        with self.inside():
            out = fn(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                return out.contiguous()
            return type(out)(o.contiguous() for o in out)

    # -- aten ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run it: the mode then sees each rank's local ops and
            # the collectives of its redistributions
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation, on the global shapes: not work
            return func(*args, **kwargs)
        if self.depth == 0 and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func.overloadpacket.__name__
            # the functional ones also have waits and autograd wrappers
            if func.namespace == "c10d" or name in _COLLECTIVES:
                self._count_collective(func, args)
            return
        packet = func.overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in _PRODUCTS:
            flops = _product_flops(packet, args, outs[0])
            dot = flops
        else:
            dot = 0.0
            if packet in _REDUCTIONS:
                flops = float(args[0].numel())
            elif packet in _COPIES:
                flops = 0.0
            elif torch.Tag.pointwise in func.tags:
                flops = float(sum(t.numel() for t in outs))
            else:
                flops = 0.0
        if func.is_view or packet in _NO_BYTES:
            nbytes = 0.0
        elif packet in _GATHERS:
            nbytes = 2.0 * _nbytes(outs)
        elif packet in _SCATTERS:
            nbytes = 3.0 * _nbytes(ins[-1:])  # the update is the last tensor operand
        else:
            nbytes = _nbytes(ins) + _nbytes(outs)
        fusable = torch.Tag.pointwise in func.tags or packet in _COPIES
        rep = self.report
        with self._lock:
            rows = [rep.by_op.setdefault(str(packet), {"count": 0, "flops": 0.0, "bytes": 0.0})]
            if packet in _PRODUCTS:
                rows.append(rep.by_product.setdefault(_product_key(packet, args),
                                                      {"count": 0, "flops": 0.0, "bytes": 0.0}))
            for row in rows:
                row["count"] += 1
                row["flops"] += flops
                row["bytes"] += nbytes
            rep.flops += flops
            rep.dot_flops += dot
            rep.hbm_bytes += nbytes
            if not fusable:
                rep.hbm_bytes_fused += nbytes

    def _count_collective(self, func, args) -> None:
        base, at = _COLLECTIVES.get(func.overloadpacket.__name__,
                                    (func.overloadpacket.__name__, 0))
        operand = _nbytes(_tensors(args[at]))
        gs = _group_size(args)
        if base == "all-gather":
            traffic = operand * (gs - 1)  # out = gs x operand: out (gs - 1) / gs
        elif base == "all-reduce":
            traffic = 2.0 * operand * (gs - 1) / gs
        elif base in ("reduce-scatter", "all-to-all"):
            traffic = operand * (gs - 1) / gs
        else:
            traffic = operand
        rep = self.report
        with self._lock:
            rep.collective_bytes += operand
            rep.collective_traffic_bytes += traffic
            rep.collectives[base] = rep.collectives.get(base, 0.0) + operand
            rep.collective_counts[base] = rep.collective_counts.get(base, 0) + 1


def _group_size(args) -> int:
    """The ranks of a collective's group: a c10d op carries the group, a
    functional one its name (and sometimes its size)."""
    group = next((a for a in args if hasattr(a, "size") and not isinstance(
        a, (torch.Tensor, list, tuple))), None)
    if group is not None:
        return max(int(group.size()), 1)
    # the group's name is the last string of every functional collective
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    if name is not None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        try:
            return max(int(_resolve_process_group(name).size()), 1)
        except (RuntimeError, ValueError, KeyError):
            pass
    return 1


@contextmanager
def _propagation_uncounted(counter: _Counter):
    """``DTensor``'s choice of layouts run inside ``counter.inside()``: its
    sharding propagator's cached and uncached entry points (on its one
    instance) and the redistribution planner (``_gen_transform_infos``'s
    uncached body) are wrapped while the step runs, and restored after."""
    import torch.distributed.tensor._redistribute as redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    sites = [(obj, n) for obj, n in ((prop, "propagate_op_sharding"),
                                     (prop, "propagate_op_sharding_non_cached"),
                                     (redistribute, "_gen_transform_infos_non_cached"))
             if hasattr(obj, n)]
    own = [(obj, n, vars(obj).get(n)) for obj, n in sites]

    def uncounted(orig):
        def run(*args, **kwargs):
            with counter.inside():
                return orig(*args, **kwargs)
        return run

    for obj, n in sites:
        setattr(obj, n, uncounted(getattr(obj, n)))
    try:
        yield
    finally:
        for obj, n, was in own:
            if was is None:
                delattr(obj, n)
            else:
                setattr(obj, n, was)


def analyze_step(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return its report (the module
    docstring lists the keys). ``fn`` runs as it would without analysis;
    its result is dropped."""
    if _ops.counter is not None:
        raise RuntimeError("analyze_step is already running")
    report = OpReport()
    counter = _Counter(report)
    _ops.counter = counter
    try:
        with counter, _propagation_uncounted(counter):
            fn(*args, **kwargs)
    finally:
        _ops.counter = None
    return report.as_dict()
