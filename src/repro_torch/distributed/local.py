"""What each rank computes on its own shards, where ``DTensor``'s own rules
cannot say it: the hand kernels (which take raw pointers through ``ctypes``
and know nothing of ``DTensor``), the MoE FFN (whose einsums ``DTensor``
would lay out op by op, by a search that takes minutes on a 3-D mesh and
picks layouts that do many times a rank's share of the expert products),
the vocab-sharded lookups, and the cache writes. Each runs through
``local_map`` with stated placements, one per mesh dim; the batch keeps
the placement it came with on the data axes, and the ``model`` axis is
set here:

* ``flash_attention``: query heads over ``model`` when they divide by it,
  else replicated (every rank runs all heads, and no collective beyond
  gathering q, k and v whole: phi4-mini's 24 heads and whisper-small's 12
  at ``model = 16``). KV heads that do not divide (GQA with the k/v
  projections replicated, ``rules._kv_tp_ok``) stay whole on every rank,
  and each rank hands the kernel the KV heads of its own query block
  (``(r Hq / tp) // G`` on); their gradients are partial sums over
  ``model``.
* ``decode_attention``: the cache is split along the sequence over
  ``model`` (flash-decode). Each rank runs K2 on its shard with its share
  of each length and keeps the unnormalised per-split partials (m, l, acc)
  that the kernel merges across its own splits; the partials of all ranks
  are all-gathered (a few KB) and merged as the kernel's combine does
  (``ref._combine_partials``). The cache is never gathered.
* ``ssd_scan``: SSD heads over ``model``; B and C (ngroups 1) whole on
  every rank, their gradients partial sums over ``model``.
* ``moe_ffn``: the MoE FFN's experts over ``model`` (the JAX rules'
  layout): each rank routes its rows on all experts, then runs its own E /
  tp; the output is a partial sum over ``model``. Experts that do not
  divide run whole on every rank.
* ``embedding`` / ``target_logits``: a vocab-sharded table or logits; each
  rank looks up the ids it holds, zeros the rest, and the partial sums are
  reduced at once.
* ``write_rows`` / ``write_positions``: the prefill's and the decode
  step's cache writes into a sequence-sharded cache: each rank writes the
  rows that fall in its shard and drops the rest.

A mesh axis of one rank takes the same code; its collectives move nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.compat import all_gather, is_dtensor, local_map
from repro_torch.kernels import ops


def _pl():
    from torch.distributed.tensor import Partial, Replicate, Shard

    return Partial, Replicate, Shard


def _model_dim(mesh):
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def _tp(mesh) -> int:
    i = _model_dim(mesh)
    return 1 if i is None else mesh.size(i)


def _batch_axes(mesh, x, dim: int = 0):
    """The mesh dims (not ``model``) over which ``x`` is split along ``dim``."""
    if not is_dtensor(x):
        return frozenset()
    mi = _model_dim(mesh)
    return frozenset(i for i, pl in enumerate(x.placements)
                     if i != mi and pl.is_shard(dim))


def _places(mesh, batch, bdim, model):
    """Placements: ``Shard(bdim)`` on the batch axes, ``model`` on the model
    axis, ``Replicate()`` elsewhere (``bdim`` None: an input with no batch
    dim, replicated over the batch axes)."""
    _, Replicate, Shard = _pl()
    mi = _model_dim(mesh)
    out = []
    for i in range(mesh.ndim):
        if i == mi:
            out.append(model)
        elif i in batch and bdim is not None:
            out.append(Shard(bdim))
        else:
            out.append(Replicate())
    return tuple(out)


def _no_batch_grad(mesh, batch, model):
    """The gradient placements of an input with no batch dim: each rank's
    share of the batch gives a partial sum over each split batch axis."""
    Partial, Replicate, _ = _pl()
    mi = _model_dim(mesh)
    return tuple(model if i == mi else (Partial() if i in batch and mesh.size(i) > 1
                                        else Replicate())
                 for i in range(mesh.ndim))


def _as_dtensor(x, mesh):
    """A plain tensor as a ``DTensor`` replicated on ``mesh``."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    _, Replicate, _ = _pl()
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _rank(mesh) -> int:
    return mesh.get_local_rank("model") if _model_dim(mesh) is not None else 0


# ---------------------------------------------------------------------------
# the hand kernels
# ---------------------------------------------------------------------------


def _own_kv(k, v, first: int, hq: int, G: int):
    """The KV heads of query heads ``first .. first + hq - 1`` (G query
    heads per KV head), and the kernel sees hq / that many query heads to
    each."""
    if hq % G == 0:
        a, b = first // G, (first + hq) // G
    elif G % hq == 0:
        a = first // G
        b = a + 1
    else:  # the block straddles KV heads unevenly: one KV head per query head
        idx = torch.tensor([(first + j) // G for j in range(hq)], device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)
    return k[:, :, a:b], v[:, :, a:b]


def flash_attention(q, k, v, *, causal=True, **kw):
    Partial, Replicate, Shard = _pl()
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    t = _tp(mesh)
    Hq, Hkv = q.shape[2], k.shape[2]
    split = Hq % t == 0
    kv_split = split and Hkv % t == 0
    batch = _batch_axes(mesh, q)
    qpl = _places(mesh, batch, 0, Shard(2) if split else Replicate())
    kvpl = _places(mesh, batch, 0, Shard(2) if kv_split else Replicate())
    kvgrad = _places(mesh, batch, 0, Shard(2) if kv_split else
                     (Partial() if split and t > 1 else Replicate()))
    G = Hq // Hkv

    def fn(ql, kl, vl):
        if split and not kv_split:
            hq = ql.shape[2]
            kl, vl = _own_kv(kl, vl, _rank(mesh) * hq, hq, G)
        return ops.flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                   causal=causal, **kw)

    return local_map(fn, out_placements=(qpl,), in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kvgrad, kvgrad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def merge_partials(acc: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """K2's combine: partials acc (B, Hq, n, Dh) and (m, l) (B, Hq, n, 2),
    fp32 -> (B, 1, Hq, Dh) fp32, as ``ref._combine_partials`` merges them."""
    m, l = ml[..., 0], ml[..., 1]
    c = torch.exp(m - m.amax(dim=-1, keepdim=True))
    den = (l * c).sum(-1)
    out = (acc * c[..., None]).sum(2) / torch.clamp(den, min=1e-30)[..., None]
    return out[:, None]


def decode_attention(q, k_cache, v_cache, lengths, **kw):
    _, Replicate, Shard = _pl()
    mesh = k_cache.device_mesh
    q, v_cache = _as_dtensor(q, mesh), _as_dtensor(v_cache, mesh)
    lengths = _as_dtensor(lengths, mesh)
    mi = _model_dim(mesh)
    seq = mi is not None and k_cache.placements[mi].is_shard(1)
    batch = _batch_axes(mesh, k_cache)
    cpl = _places(mesh, batch, 0, Shard(1) if seq else Replicate())
    qpl = _places(mesh, batch, 0, Replicate())

    def fn(ql, kl, vl, ll):
        ql = ql.contiguous()
        if not seq:
            return ops.decode_attention(ql, kl, vl, ll, **kw)
        L = kl.shape[1]
        own = (ll - _rank(mesh) * L).clamp(0, L).to(torch.int32)
        acc, ml = ops.decode_attention(ql, kl, vl, own, partials=True, **kw)
        acc = all_gather(acc, 2, (mesh, mi))
        ml = all_gather(ml, 2, (mesh, mi))
        return merge_partials(acc, ml).to(ql.dtype)

    return local_map(fn, out_placements=(qpl,), in_placements=(qpl, cpl, cpl, qpl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache,
                                                                 lengths)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=128, initial_state=None, **kw):
    Partial, Replicate, Shard = _pl()
    mesh = x.device_mesh
    dt, A, Bm, Cm = (_as_dtensor(a, mesh) for a in (dt, A, Bm, Cm))
    t = _tp(mesh)
    split = x.shape[2] % t == 0
    batch = _batch_axes(mesh, x)
    xpl = _places(mesh, batch, 0, Shard(2) if split else Replicate())
    apl = _places(mesh, batch, None, Shard(0) if split else Replicate())
    agrad = _no_batch_grad(mesh, batch, Shard(0) if split else Replicate())
    bcpl = _places(mesh, batch, 0, Replicate())
    bcgrad = _places(mesh, batch, 0, Partial() if split and t > 1 else Replicate())
    spl = _places(mesh, batch, 0, Shard(1) if split else Replicate())
    args = [x, dt, A, Bm, Cm]
    inp, grads = [xpl, xpl, apl, bcpl, bcpl], [xpl, xpl, agrad, bcgrad, bcgrad]
    if initial_state is not None:
        args.append(_as_dtensor(initial_state, mesh))
        inp.append(spl)
        grads.append(spl)

    def fn(xl, dtl, Al, Bl, Cl, sl=None):
        return ops.ssd_scan(xl, dtl.contiguous(), Al.contiguous(), Bl, Cl, chunk=chunk,
                            initial_state=None if sl is None else sl.contiguous(), **kw)

    return local_map(fn, out_placements=(xpl, spl), in_placements=tuple(inp),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# the MoE FFN: experts over ``model``
# ---------------------------------------------------------------------------


def moe_ffn(cfg, p, x, *, capacity_factor=None):
    """``layers.moe_forward`` for a ``DTensor`` ``x`` (B, S, D): (y, aux).

    Each rank takes its batch rows whole over ``model`` (the norm's output
    already is), routes them on all E experts and counts the capacity
    slots (per batch row, so on its own rows), then dispatches to,
    computes and combines only its own E / tp experts (``layers.
    moe_experts`` on its slice of the one-hots and its expert weights). y
    is a partial sum over ``model``, reduced into the residual's placement
    where it is added (``act_sharding.placed_like``). E that does not
    divide by the model axis: every rank runs all experts and y is whole.

    aux is the one-rank step's mean over the global batch: each rank's
    share of the routed fractions is all-reduced over the batch axes,
    and its share of the mean router probabilities (times those
    fractions, over its own experts) is a partial sum over the batch axes
    and ``model``, so its gradient reaches each rank's rows once.
    Gradients: the expert weights get their own shards; the router and x
    partial sums over ``model`` (each rank's experts' share)."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.models import layers as L

    Partial, Replicate, Shard = _pl()
    mesh = x.device_mesh
    E, K = cfg.num_experts, cfg.experts_per_token
    t = _tp(mesh)
    esplit = E % t == 0 and t > 1
    ct = L.cdtype(cfg)
    C = L.moe_capacity(cfg, x.shape[1], capacity_factor)
    rows = x.shape[0]
    batch = _batch_axes(mesh, x)
    part = Partial() if esplit else Replicate()
    epl = Shard(0) if esplit else Replicate()
    xpl = _places(mesh, batch, 0, Replicate())
    rpl = _places(mesh, batch, None, Replicate())
    wpl = _places(mesh, batch, None, epl)

    def fn(xl, rl, wgl, wul, wdl):
        probs, gate_vals, gate_idx = L.moe_route(cfg, {"router": rl}, xl)
        onehot = F.one_hot(gate_idx, E)
        frac_probs = probs.mean(dim=(0, 1))
        if esplit:
            lo = _rank(mesh) * (E // t)
            onehot, frac_probs = onehot[..., lo:lo + E // t], frac_probs[lo:lo + E // t]
        y = L.moe_experts(cfg, xl, gate_vals, gate_idx, onehot, wgl, wul, wdl, C)
        frac_tokens = onehot.sum(2).float().mean(dim=(0, 1))
        share = xl.shape[0] / rows
        if share != 1:
            frac_tokens, frac_probs = frac_tokens * share, frac_probs * share
            for i in sorted(batch):
                frac_tokens = funcol.all_reduce(frac_tokens, "sum", (mesh, i))
        return y, E * torch.sum(frac_tokens * frac_probs) / K

    y, aux = local_map(
        fn, out_placements=(_places(mesh, batch, 0, part), _no_batch_grad(mesh, batch, part)),
        in_placements=(xpl, rpl, wpl, wpl, wpl),
        in_grad_placements=(_places(mesh, batch, 0, part), _no_batch_grad(mesh, batch, part),
                            *[_no_batch_grad(mesh, batch, epl)] * 3),
        device_mesh=mesh, redistribute_inputs=True)(
            x, L.weight(p["router"], torch.float32), L.weight(p["wg"], ct),
            L.weight(p["wu"], ct), L.weight(p["wd"], ct))
    if cfg.moe_shared_expert:
        y = y + L.mlp_forward(cfg, p["shared"], x)
    return y.to(x.dtype), _reduce(aux).float()


# ---------------------------------------------------------------------------
# vocab-sharded lookups
# ---------------------------------------------------------------------------


def _vocab_split(x, dim: int) -> bool:
    mi = _model_dim(x.device_mesh)
    return mi is not None and x.placements[mi].is_shard(dim) and x.device_mesh.size(mi) > 1


def embedding(tokens, table):
    """``F.embedding(tokens, table)`` for a ``DTensor`` table, the vocab
    over ``model``: each rank looks up the ids in its rows, zeros the rest,
    and the partial sums are reduced over ``model``."""
    Partial, Replicate, Shard = _pl()
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    vsplit = _vocab_split(table, 0)
    batch = _batch_axes(mesh, tokens)
    mpl = Shard(0) if vsplit else Replicate()
    tpl = _places(mesh, batch, 0, Replicate())
    wpl = _places(mesh, batch, None, mpl)

    def fn(tl, wl):
        if not vsplit:
            return F.embedding(tl, wl)
        V = wl.shape[0]
        loc = tl - _rank(mesh) * V
        ok = (loc >= 0) & (loc < V)
        return F.embedding(loc.clamp(0, V - 1), wl) * ok[..., None].to(wl.dtype)

    out = local_map(fn, out_placements=(_places(mesh, batch, 0,
                                                Partial() if vsplit else Replicate()),),
                    in_placements=(tpl, wpl),
                    in_grad_placements=(tpl, _no_batch_grad(mesh, batch, mpl)),
                    device_mesh=mesh, redistribute_inputs=True)(tokens, table)
    return _reduce(out)


def target_logits(logits, targets):
    """``logits.gather(-1, targets[..., None])[..., 0]`` for ``DTensor``
    logits (B, S, V), the vocab over ``model``."""
    Partial, Replicate, Shard = _pl()
    mesh = logits.device_mesh
    targets = _as_dtensor(targets, mesh)
    vsplit = _vocab_split(logits, 2) or _vocab_split(logits, -1)
    batch = _batch_axes(mesh, logits)
    lpl = _places(mesh, batch, 0, Shard(2) if vsplit else Replicate())
    tpl = _places(mesh, batch, 0, Replicate())

    def fn(ll, tl):
        if not vsplit:
            return ll.gather(-1, tl[..., None])[..., 0]
        V = ll.shape[-1]
        loc = tl - _rank(mesh) * V
        ok = (loc >= 0) & (loc < V)
        got = ll.gather(-1, loc.clamp(0, V - 1)[..., None])[..., 0]
        return torch.where(ok, got, torch.zeros((), dtype=got.dtype, device=got.device))

    out = local_map(fn, out_placements=(_places(mesh, batch, 0,
                                                Partial() if vsplit else Replicate()),),
                    in_placements=(lpl, tpl), in_grad_placements=(lpl, tpl),
                    device_mesh=mesh, redistribute_inputs=True)(logits, targets)
    return _reduce(out)


def _reduce(x):
    from repro_torch.distributed.compat import reduce_partials

    return reduce_partials(x)


# ---------------------------------------------------------------------------
# reshapes and microbatches on each rank's rows
# ---------------------------------------------------------------------------


def _local_rows(x, shape):
    """``shape`` with each dim that ``x`` is split along cut to one rank's
    share (only leading dims the reshape keeps may be split)."""
    out = list(shape)
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            d = pl.dim % x.ndim
            if d >= len(shape) or x.shape[d] != shape[d]:
                raise ValueError(f"dim {d} of {tuple(x.shape)} is split over ranks and "
                                 f"the reshape to {tuple(shape)} does not keep it")
            out[d] //= x.device_mesh.size(i)
    return out


def reshape_rows(x, shape):
    """``x.reshape(shape)`` on each rank's shard, the placements kept (the
    split dims are leading dims the reshape keeps); its backward first
    places the gradient as ``x`` was placed."""
    pls = tuple(x.placements)
    loc = _local_rows(x, shape)
    return local_map(lambda t: t.reshape(loc), out_placements=(pls,), in_placements=(pls,),
                     in_grad_placements=(pls,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def narrow_batch(x, ax: int, microbatches: int, i: int):
    """Microbatch ``i`` of a batch-split ``DTensor``: each rank's rows
    ``i * n .. (i + 1) * n`` of its own share (n = its rows / microbatches),
    the placements kept. On one rank it is the single-device cut; on more,
    microbatch i holds the i-th part of each rank's rows, and the
    microbatches together still hold every row once, so the step's mean
    loss and gradient are the same."""
    pls = tuple(x.placements)

    def fn(t):
        n = t.shape[ax] // microbatches
        return t.narrow(ax, i * n, n)

    return local_map(fn, out_placements=(pls,), in_placements=(pls,),
                     in_grad_placements=(pls,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


# ---------------------------------------------------------------------------
# cache writes into a sequence-sharded cache
# ---------------------------------------------------------------------------


def _cache_parts(cache, rows):
    """(the cache's local tensor, ``rows`` placed as the cache's batch and
    whole over ``model``, as a local tensor, the first global row of this
    rank's shard, its length)."""
    _, Replicate, _ = _pl()
    mesh = cache.device_mesh
    mi = _model_dim(mesh)
    seq = mi is not None and cache.placements[mi].is_shard(1)
    batch = _batch_axes(mesh, cache)
    want = _places(mesh, batch, 0, Replicate())
    rows = _as_dtensor(rows, mesh)
    if tuple(rows.placements) != want:
        rows = rows.redistribute(mesh, want)
    local = cache.to_local()
    L = local.shape[1]
    return local, rows.to_local(), (_rank(mesh) * L if seq else 0), L


def write_rows(cache, rows) -> None:
    """``cache[:, :S] = rows`` (rows (B, S, ...)), in place, each rank
    writing the rows of its shard."""
    local, rl, first, L = _cache_parts(cache, rows)
    a, b = first, min(first + L, rl.shape[1])
    if b > a:
        local[:, a - first:b - first] = rl[:, a:b].to(local.dtype)


def write_positions(cache, positions, new) -> None:
    """``cache[b, positions[b]] = new[b]`` (new (B, ...)), in place; a
    position outside this rank's shard (or past the cache) is dropped
    here, as the single-device write drops one past the cache."""
    local, nl, first, L = _cache_parts(cache, new)
    pos = _cache_parts(cache, positions)[1].long() - first
    keep = ((pos >= 0) & (pos < L)).reshape(-1, *([1] * (nl.dim() - 1)))
    pos = pos.clamp(0, L - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    local[bidx, pos] = torch.where(keep, nl.to(local.dtype), local[bidx, pos])
