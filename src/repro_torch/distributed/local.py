"""What each rank computes on its own shards, where ``DTensor``'s own rules
cannot say it: the hand kernels (which take raw pointers through ``ctypes``
and know nothing of ``DTensor``), the MoE FFN (whose einsums ``DTensor``
would lay out op by op, by a search that takes minutes on a 3-D mesh and
picks layouts that do many times a rank's share of the expert products),
the vocab-sharded lookups, and the cache writes. Each runs through
``local_map`` with stated placements, one per mesh dim; the batch keeps
the placement it came with on the data axes, and the ``model`` axis is
set here:

* ``flash_attention``: query heads over ``model`` when they divide by it.
  KV heads that do not divide (GQA with the k/v projections replicated,
  ``rules._kv_tp_ok``) stay whole on every rank, and each rank hands the
  kernel the KV heads of its own query block (``(r Hq / tp) // G`` on);
  their gradients are partial sums over ``model``. Query heads that do
  not divide (phi4-mini's 24, whisper-small's 12, llama4's 40 at ``model
  = 16``) split the query rows over ``model`` instead, against whole K/V
  (``_RowSplitAttention``): causal rows zigzag (2 tp chunks, rank r takes
  chunks r and 2 tp - 1 - r, so every rank sees as many (query, key)
  pairs), each chunk two K1 calls merged by their log-sum-exps; the rows
  and dq are all-gathered whole, dk and dv are partial sums over
  ``model``.
* ``decode_attention``: the cache is split along the sequence over
  ``model`` (flash-decode). Each rank runs K2 on its shard with its share
  of each length and keeps the unnormalised per-split partials (m, l, acc)
  that the kernel merges across its own splits; the partials of all ranks
  are all-gathered (a few KB) and merged as the kernel's combine does
  (``ref._combine_partials``). The cache is never gathered.
* ``ssd_scan``: SSD heads over ``model``; B and C (ngroups 1) whole on
  every rank, their gradients partial sums over ``model``.
* ``mamba_mixer``: the Mamba2 block on each rank's SSD heads (as
  ``ssd_scan``): the rank multiplies the in_proj columns it stores (as
  the JAX rules lay in_proj out), the products are all-gathered and it
  keeps its z, x and dt columns and B and C whole, the gated norm's sum
  of squares all-reduced over ``model`` (a (B, S, 1) tensor),
  out_proj row-parallel on its heads: the output and the gradients of x
  and of the small leaves are partial sums over ``model``.
* ``moe_ffn``: the MoE FFN's experts over ``model`` (the JAX rules'
  layout): each rank routes its rows on all experts, then runs its own E /
  tp; the output is a partial sum over ``model``. Experts that do not
  divide run whole on every rank.
* ``embedding`` / ``target_logits``: a vocab-sharded table or logits; each
  rank looks up the ids it holds, zeros the rest, and the partial sums are
  reduced at once. ``logsumexp`` reduces vocab-split logits by
  all-reducing each rank's (B, S) sums, where ``DTensor`` would gather the
  logits whole.
* ``split_over_model``: a weight the rules keep whole over ``model``
  because its dim does not divide (an unembedding's vocab, mamba2-780m's
  50280 and whisper-small's 51865; K/V projections whose KV heads do not
  divide) cut along that dim over ``model`` (``torch.chunk``'s chunks,
  uneven where it does not divide), so each rank forms its own columns
  of the product, not all of them.
* ``write_rows`` / ``write_positions``: the prefill's and the decode
  step's cache writes into a sequence-sharded cache: each rank writes the
  rows that fall in its shard and drops the rest.

A mesh axis of one rank takes the same code; its collectives move nothing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.compat import all_gather, all_gather_autograd, is_dtensor, local_map
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
    if Hq % t:
        return _row_split_attention(q, k, v, causal=causal, **kw)
    kv_split = Hkv % t == 0
    batch = _batch_axes(mesh, q)
    qpl = _places(mesh, batch, 0, Shard(2))
    kvpl = _places(mesh, batch, 0, Shard(2) if kv_split else Replicate())
    kvgrad = _places(mesh, batch, 0, Shard(2) if kv_split else
                     (Partial() if t > 1 else Replicate()))
    G = Hq // Hkv

    def fn(ql, kl, vl):
        if not kv_split:
            hq = ql.shape[2]
            kl, vl = _own_kv(kl, vl, _rank(mesh) * hq, hq, G)
        return ops.flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                   causal=causal, **kw)

    return local_map(fn, out_placements=(qpl,), in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kvgrad, kvgrad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def row_chunks(S: int, t: int, causal: bool):
    """Each of ``t`` ranks' query-row chunks, (first row, rows) each:
    causal, 2 t near-equal chunks with rank r taking chunks r and 2 t - 1 -
    r (zigzag: a chunk near the end of the causal triangle paired with one
    near its start); otherwise t near-equal contiguous chunks. Chunks may
    be empty when S < 2 t."""
    n = 2 * t if causal else t
    edge = [S * i // n for i in range(n + 1)]
    chunk = [(edge[i], edge[i + 1] - edge[i]) for i in range(n)]
    if causal:
        return [[chunk[r], chunk[n - 1 - r]] for r in range(t)]
    return [[chunk[r]] for r in range(t)]


def key_parts(first: int, rows: int, Sk: int, causal: bool):
    """The K1 calls of a chunk of query rows, (first key, keys, causal)
    each. K1 masks top-left (row i sees keys 0..i), so a causal chunk at
    ``first`` is a non-causal call against keys [0, first) and a causal
    one against keys [first, first + rows); a non-causal chunk sees every
    key."""
    if not causal:
        return [(0, Sk, False)]
    out = []
    if min(first, Sk) > 0:
        out.append((0, min(first, Sk), False))
    if min(first + rows, Sk) > first:
        out.append((first, min(first + rows, Sk) - first, True))
    return out


def merge_lse(parts, dtype):
    """Outputs (B, S, H, Dh) and log-sum-exps fp32 (B, H, S) of attention
    over disjoint key sets, merged into the attention over their union:
    (out in ``dtype``, lse)."""
    if len(parts) == 1:
        return parts[0][0].to(dtype), parts[0][1]
    lse = torch.logsumexp(torch.stack([p[1] for p in parts]), dim=0)
    out = sum(o.float() * torch.exp(l - lse).permute(0, 2, 1)[..., None] for o, l in parts)
    return out.to(dtype), lse


def rank_rows(q, k, v, *, causal, scale, use_kernel, rank, t):
    """Rank ``rank`` of ``t``'s share of attention split by query rows
    (``row_chunks``) against whole K/V: each of its chunks' K1 calls
    (``key_parts``, with their log-sum-exps) merged. Returns a list of
    (first row, rows, out (B, rows, Hq, Dh), lse fp32 (B, Hq, rows)), the
    empty chunks left out."""
    Sk = k.shape[1]
    mine = []
    for first, rows in row_chunks(q.shape[1], t, causal)[rank]:
        if rows == 0:
            continue
        qc = q[:, first:first + rows].contiguous()
        res = [ops.flash_attention_lse(qc, k[:, a:a + n].contiguous(),
                                       v[:, a:a + n].contiguous(), causal=cz,
                                       scale=scale, use_kernel=use_kernel)
               for a, n, cz in key_parts(first, rows, Sk, causal)]
        mine.append((first, rows, *merge_lse(res, q.dtype)))
    return mine


def rank_rows_bwd(q, k, v, mine, dout, *, causal, scale, use_kernel):
    """The gradients of ``rank_rows``' share, (dq, dk, dv) in the inputs'
    dtypes (dq nonzero on the rank's rows only): K1's backward once per
    call, from the merged output and log-sum-exp of its chunk (exact: the
    merged lse gives each part the whole row's probabilities, and D =
    rowsum(dO o O) is the whole row's). ``dout`` is the whole output's
    gradient."""
    Sk = k.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for first, rows, o, lse in mine:
        qc = q[:, first:first + rows].contiguous()
        doc = dout[:, first:first + rows].to(q.dtype).contiguous()
        for a, n, cz in key_parts(first, rows, Sk, causal):
            g = ops.flash_attention_bwd(qc, k[:, a:a + n].contiguous(), v[:, a:a + n].contiguous(),
                                        o, lse, doc, causal=cz, scale=scale, use_kernel=use_kernel)
            dq[:, first:first + rows] += g[0]
            dk[:, a:a + n] += g[1]
            dv[:, a:a + n] += g[2]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _gather_rows(x, mine, group, t: int, causal: bool):
    """``x`` (B, S, ...) whole on every rank, from each rank's rows of it
    (``mine``: this rank's (first row, rows), as ``row_chunks`` gives
    them): each rank's rows packed, all-gathered over ``model`` and put
    back in order."""
    B, S = x.shape[:2]
    chunks = row_chunks(S, t, causal)
    width = max(sum(c for _, c in r) for r in chunks)
    own = x.new_zeros((B, width, *x.shape[2:]))
    at = 0
    for first, rows in mine:
        own[:, at:at + rows] = x[:, first:first + rows]
        at += rows
    gathered = all_gather(own, 1, group)
    index = [0] * S
    for r, ranks_chunks in enumerate(chunks):
        at = r * width
        for first, rows in ranks_chunks:
            index[first:first + rows] = range(at, at + rows)
            at += rows
    return gathered.index_select(1, torch.tensor(index, device=x.device)).contiguous()


class _RowSplitAttention(torch.autograd.Function):
    """One rank's share of attention split by query rows (``rank_rows``),
    its rows all-gathered over ``model`` and put back in order; backward
    ``rank_rows_bwd``, whose dq, dk and dv are partial sums over
    ``model``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, use_kernel, group, rank, t):
        mine = rank_rows(q, k, v, causal=causal, scale=scale, use_kernel=use_kernel,
                         rank=rank, t=t)
        out = q.new_zeros(q.shape)
        for first, rows, o, _ in mine:
            out[:, first:first + rows] = o
        out = _gather_rows(out, [(f, r) for f, r, _, _ in mine], group, t, causal)
        ctx.causal, ctx.scale, ctx.use_kernel, ctx.group, ctx.t = (causal, scale, use_kernel,
                                                                   group, t)
        ctx.chunks = [(f, r) for f, r, _, _ in mine]
        ctx.save_for_backward(q, k, v, *[x for _, _, o, lse in mine for x in (o, lse)])
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *saved = ctx.saved_tensors
        mine = [(f, r, saved[2 * i], saved[2 * i + 1]) for i, (f, r) in enumerate(ctx.chunks)]
        dq, dk, dv = rank_rows_bwd(q, k, v, mine, dout, causal=ctx.causal, scale=ctx.scale,
                                   use_kernel=ctx.use_kernel)
        # dq whole, as q came: each rank's rows gathered (its product with
        # the q projection's weight then stays the rank's columns)
        return (_gather_rows(dq, [(f, r) for f, r, _, _ in mine], ctx.group, ctx.t,
                             ctx.causal), dk, dv, None, None, None, None, None, None)


def _row_split_attention(q, k, v, *, causal=True, scale=None, use_kernel="auto", **_):
    """``flash_attention`` when the query heads do not divide by ``model``:
    q, k and v whole over ``model``, each rank its rows
    (``_RowSplitAttention``); the output and q's gradient whole over
    ``model`` (each gathered from the ranks' rows), k's and v's partial
    sums over it."""
    Partial, Replicate, _ = _pl()
    mesh = q.device_mesh
    mi = _model_dim(mesh)
    batch = _batch_axes(mesh, q)
    whole = _places(mesh, batch, 0, Replicate())
    part = _places(mesh, batch, 0, Partial())
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))

    def fn(ql, kl, vl):
        return _RowSplitAttention.apply(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                        bool(causal), scale, use_kernel, (mesh, mi),
                                        _rank(mesh), _tp(mesh))

    return local_map(fn, out_placements=(whole,), in_placements=(whole, whole, whole),
                     in_grad_placements=(whole, part, part), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def merge_partials(acc: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """K2's combine: partials acc (B, Hq, n, Dh) and (m, l) (B, Hq, n, 2),
    fp32 -> (B, 1, Hq, Dh) fp32, as ``ref._combine_partials`` merges them."""
    m, l = ml[..., 0], ml[..., 1]
    c = torch.exp(m - m.amax(dim=-1, keepdim=True))
    den = (l * c).sum(-1)
    out = (acc * c[..., None]).sum(2) / torch.clamp(den, min=1e-30)[..., None]
    return out[:, None]


def _idle_axes(mesh, batch) -> list:
    """The mesh dims other than ``model`` that the batch (split over the
    dims in ``batch``) leaves idle, in mesh order."""
    mi = _model_dim(mesh)
    return [i for i in range(mesh.ndim) if i != mi and i not in batch and mesh.size(i) > 1]


def _idle_rank(mesh, idle) -> tuple:
    """(this rank's index over the ``idle`` dims, row-major in mesh order,
    their number of ranks)."""
    r, n = 0, 1
    for i in idle:
        r, n = r * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    return r, n


def decode_attention(q, k_cache, v_cache, lengths, **kw):
    """K2 on a ``DTensor`` cache: each rank attends its batch rows against
    its shard of the cache, merging the partials across ``model`` where the
    cache's sequence is split over it (flash-decode). Where the batch
    leaves axes other than ``model`` idle (a one-row decode), the query
    heads are split over them too, as XLA's partitioner splits them: each
    rank attends its Hq / n heads against the KV heads they read (sliced
    from its cache shard), and the heads are gathered back."""
    _, Replicate, Shard = _pl()
    mesh = k_cache.device_mesh
    q, v_cache = _as_dtensor(q, mesh), _as_dtensor(v_cache, mesh)
    lengths = _as_dtensor(lengths, mesh)
    mi = _model_dim(mesh)
    seq = mi is not None and k_cache.placements[mi].is_shard(1)
    batch = _batch_axes(mesh, k_cache)
    cpl = _places(mesh, batch, 0, Shard(1) if seq else Replicate())
    qpl = _places(mesh, batch, 0, Replicate())
    Hq, Hkv = q.shape[2], k_cache.shape[2]
    idle = _idle_axes(mesh, batch)
    r, n = _idle_rank(mesh, idle)
    h, G = Hq // n, Hq // Hkv
    if Hq % n or not (G % h == 0 or h % G == 0):
        idle, r, n, h = [], 0, 1, Hq

    def fn(ql, kl, vl, ll):
        ql = ql[:, :, r * h:(r + 1) * h].contiguous()
        kv = slice(r * h // G, -(-(r + 1) * h // G))
        kl, vl = kl[:, :, kv].contiguous(), vl[:, :, kv].contiguous()
        if not seq:
            out = ops.decode_attention(ql, kl, vl, ll, **kw)
        else:
            L = kl.shape[1]
            own = (ll - _rank(mesh) * L).clamp(0, L).to(torch.int32)
            acc, ml = ops.decode_attention(ql, kl, vl, own, partials=True, **kw)
            acc = all_gather(acc, 2, (mesh, mi))
            ml = all_gather(ml, 2, (mesh, mi))
            out = merge_partials(acc, ml).to(ql.dtype)
        for i in reversed(idle):  # the heads back, the innermost axis first
            out = all_gather(out, 2, (mesh, i))
        return out

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
# the Mamba2 block: SSD heads over ``model``
# ---------------------------------------------------------------------------

class _SumOverModel(torch.autograd.Function):
    """An all-reduce (sum) over ``model`` whose gradient is one too: each
    rank's share reaches every rank's use of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol

        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


def mamba_mixer(cfg, p, x, *, initial_state=None, return_state=False):
    """``mamba2.mamba_forward`` for a ``DTensor`` ``x`` (B, S, D), whole over
    ``model``: each rank runs ``mamba2.mixer`` on its nh / tp SSD heads
    (contiguous, as ``ssd_scan`` splits them and as out_proj's rows are
    stored). in_proj's product: each rank multiplies the 1 / tp of the
    columns it stores (the JAX rules' layout, which does not line up with
    the z / x / B / C / dt blocks), the products are all-gathered (the
    backward reduce-scatters their gradient) and the rank keeps its z, x
    and dt columns and B and C whole; where the columns do not divide, the
    weight is whole on every rank and the rank multiplies the columns it
    keeps. The output is a partial sum over ``model``, reduced into the
    residual's placement where it is added; the final state is split by
    heads (the ssm cache's layout) and the conv tail whole (the rank's x
    channels all-gathered). Heads that do not divide by ``model``: every
    rank runs the whole block."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M

    Partial, Replicate, Shard = _pl()
    mesh = x.device_mesh
    mi = _model_dim(mesh)
    t = _tp(mesh)
    split = t > 1 and cfg.ssm_nheads % t == 0
    ranks = t if split else 1
    ct = L.cdtype(cfg)
    cols = 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads
    stored = split and cols % t == 0
    batch = _batch_axes(mesh, x)
    part = Partial() if split else Replicate()
    whole = _places(mesh, batch, None, Replicate())
    small = _no_batch_grad(mesh, batch, part)
    ipl = Shard(1) if stored else Replicate()
    opl = Shard(0) if split else Replicate()
    names = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")
    args = [x, L.weight(p["in_proj"], ct), L.weight(p["out_proj"], ct),
            *(_as_dtensor(p[n], mesh) for n in names)]
    inp = [_places(mesh, batch, 0, Replicate()), _places(mesh, batch, None, ipl),
           _places(mesh, batch, None, opl), *[whole] * len(names)]
    grads = [_places(mesh, batch, 0, part), _no_batch_grad(mesh, batch, ipl if stored else part),
             _no_batch_grad(mesh, batch, opl), *[small] * len(names)]
    if initial_state is not None:
        args.append(_as_dtensor(initial_state, mesh))
        inp.append(_places(mesh, batch, 0, Shard(1) if split else Replicate()))
        grads.append(inp[-1])
    group = (mesh, mi)
    rank = _rank(mesh) if split else 0

    def fn(xl, wi, wo, *rest):
        pl = dict(zip(names, rest), in_proj=wi, out_proj=wo)
        proj = None
        if stored:  # every rank's stored columns' product, gathered; this rank's columns
            proj = M._take(all_gather_autograd(xl.to(ct) @ wi, xl.ndim - 1, group),
                           M.own_columns(cfg, rank, ranks), -1)
        res = M.mixer(cfg, pl, xl, initial_state=rest[len(names)] if len(rest) > len(names)
                      else None, return_state=return_state, rank=rank, ranks=ranks,
                      sum_ranks=lambda s: _SumOverModel.apply(s, group), proj=proj)
        if not return_state:
            return res
        out, final, tail = res
        if split:  # the conv tail whole: every rank's x channels, then B and C
            dr = cfg.ssm_d_inner // ranks
            xs = all_gather(tail[..., :dr].contiguous(), tail.ndim - 1, group)
            tail = torch.cat([xs, tail[..., dr:]], dim=-1)
        return out, final, tail

    outs = (_places(mesh, batch, 0, part),)
    if return_state:
        outs += (_places(mesh, batch, 0, Shard(1) if split else Replicate()),
                 _places(mesh, batch, 0, Replicate()))
    res = local_map(fn, out_placements=outs if return_state else (outs[0],),
                    in_placements=tuple(inp), in_grad_placements=tuple(grads),
                    device_mesh=mesh, redistribute_inputs=True)(*args)
    return res


def mamba_decode(cfg, p, x, ssm_state, conv_state):
    """``mamba2.mamba_decode`` for a ``DTensor`` ``x`` (B, 1, D), whole over
    ``model``: each rank steps its nh / tp SSD heads, as ``mamba_mixer``
    runs them. in_proj's product: each rank multiplies its stored columns,
    the products are all-gathered and the rank keeps its z, x and dt
    columns and B and C whole. The ssm state comes in as the rank's heads
    (the cache's layout). The conv state's split over ``model`` is
    contiguous channels (``rules.cache_spec``), which do not line up with
    the heads: it comes in whole (all-gathered: (B, W-1, conv_dim), a few
    kB), each rank convolves its x channels and B and C, and the new state
    goes out whole (the rank's new x channels all-gathered) to be written
    back into the cache's split. The gated norm sums its squares over
    ``model`` and out_proj's rows are the rank's, so the output is a
    partial sum over ``model``. Heads that do not divide: every rank steps
    them all."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M

    Partial, Replicate, Shard = _pl()
    mesh = x.device_mesh
    t = _tp(mesh)
    split = t > 1 and cfg.ssm_nheads % t == 0
    ranks = t if split else 1
    ct = L.cdtype(cfg)
    di, ns = cfg.ssm_d_inner, cfg.ssm_state
    dr = di // ranks
    cols = 2 * di + 2 * ns + cfg.ssm_nheads
    stored = split and cols % t == 0
    batch = _batch_axes(mesh, x)
    rows = _places(mesh, batch, 0, Replicate())
    heads = _places(mesh, batch, 0, Shard(1) if split else Replicate())
    names = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")
    args = [x, L.weight(p["in_proj"], ct), L.weight(p["out_proj"], ct),
            *(_as_dtensor(p[n], mesh) for n in names), ssm_state, conv_state]
    inp = [rows, _places(mesh, batch, None, Shard(1) if stored else Replicate()),
           _places(mesh, batch, None, Shard(0) if split else Replicate()),
           *[_places(mesh, batch, None, Replicate())] * len(names), heads, rows]
    group = (mesh, _model_dim(mesh))
    rank = _rank(mesh) if split else 0

    def fn(xl, wi, wo, *rest):
        pl = dict(zip(names, rest), in_proj=wi, out_proj=wo)
        ssm, conv = rest[len(names):]
        if not split:
            return M.mamba_decode(cfg, pl, xl, ssm, conv)
        proj = None
        if stored:  # every rank's stored columns' product, gathered; this rank's columns
            proj = M._take(all_gather(xl[:, 0].to(ct) @ wi, 1, group),
                           M.own_columns(cfg, rank, ranks), -1)
        mine = M._take(conv, [(rank * dr, dr), (di, 2 * ns)], 2)
        out, new_ssm, new_conv = M.mamba_decode(
            cfg, pl, xl, ssm, mine, rank=rank, ranks=ranks, proj=proj,
            sum_ranks=lambda s: _SumOverModel.apply(s, group))
        row = new_conv[:, -1:]  # the new row of the rank's channels: every rank's x, B, C
        xs = all_gather(row[..., :dr].contiguous(), 2, group)
        return out, new_ssm, torch.cat([conv[:, 1:], torch.cat([xs, row[..., dr:]], -1)], 1)

    return local_map(fn, out_placements=(_places(mesh, batch, 0, Partial() if split
                                                 else Replicate()), heads, rows),
                     in_placements=tuple(inp), device_mesh=mesh,
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

    Where the batch leaves axes other than ``model`` idle (its rows split
    over none of them: a one-row decode or prefill) and no gradient is
    taken, the experts' d_ff is split over those axes too, so that each
    rank forms its share of its experts' products (XLA's partitioner
    splits them over the idle axes as well); y is then also a partial sum
    over them. With a gradient the d_ff stays whole: the router's gradient
    would be a partial sum over the idle axes through y but whole through
    aux. No cell reaches that case (every train cell's microbatch splits
    its rows over all of ``pod`` and ``data``: ``tests/test_torch_cells.py``
    holds it), so the guard serves only a one-row training step.

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
    grad = torch.is_grad_enabled() and any(
        w.requires_grad for w in (x, p["router"], p["wg"], p["wu"], p["wd"]))
    idle = _idle_axes(mesh, batch)
    if grad or p["wg"].shape[-1] % math.prod(mesh.size(i) for i in idle):
        idle = []

    def wpl(ff: int):  # experts over ``model``, d_ff (dim ``ff``) over the idle axes
        return tuple(Shard(ff) if i in idle else pl
                     for i, pl in enumerate(_places(mesh, batch, None, epl)))

    ypl = tuple(Partial() if i in idle else pl
                for i, pl in enumerate(_places(mesh, batch, 0, part)))

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
        fn, out_placements=(ypl, _no_batch_grad(mesh, batch, part)),
        in_placements=(xpl, rpl, wpl(2), wpl(2), wpl(1)),
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


def _vocab_first(x, dim: int) -> int:
    """This rank's first vocab row of ``x`` split along ``dim`` over
    ``model`` (``torch.chunk``'s split: ceil(V / tp) rows a rank, the last
    rank fewer when V does not divide)."""
    t = _tp(x.device_mesh)
    return _rank(x.device_mesh) * -(-x.shape[dim] // t)


def split_over_model(w, dim: int):
    """A ``DTensor`` weight ``w`` whole over ``model`` (the rules keep it so
    when its dim does not divide by the model axis: K/V projections whose
    KV heads do not divide, an unembedding whose vocab does not) split
    along ``dim`` over ``model``, so that each rank forms its own columns
    of the product, not all of them: a local cut (``torch.chunk``'s
    split, uneven where ``dim`` does not divide), no collective. Its
    gradient is gathered back whole. Otherwise ``w`` as it is."""
    _, _, Shard = _pl()
    mi = _model_dim(w.device_mesh)
    if mi is None or w.device_mesh.size(mi) == 1 or not w.placements[mi].is_replicate():
        return w
    pls = list(w.placements)
    pls[mi] = Shard(dim % w.ndim)
    return w.redistribute(w.device_mesh, pls)


def rows_of(x, w):
    """``x`` (..., K), whole over ``model``, cut along K to the rows of ``w``
    (K, N) this rank holds, when ``w``'s rows are split over ``model``: a
    local cut, so that ``x @ w`` is the rank's partial sum and its weight
    gradient the rank's rows (left to itself ``DTensor`` forms that
    gradient whole on every rank). Otherwise ``x`` as it is."""
    _, _, Shard = _pl()
    mi = _model_dim(x.device_mesh)
    if (mi is None or not x.placements[mi].is_replicate()
            or not (is_dtensor(w) and w.placements[mi].is_shard(0))):
        return x
    pls = list(x.placements)
    pls[mi] = Shard(x.ndim - 1)
    return x.redistribute(x.device_mesh, pls)


class _ShareSum(torch.autograd.Function):
    """A sum over ``model`` of each rank's share of a result that every rank
    then uses alike (replicated): all-reduced forward, the identity
    backward (each share's gradient is the result's, once)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def logsumexp(logits):
    """``torch.logsumexp(logits, -1)`` for ``DTensor`` logits (B, S, V), the
    vocab over ``model``: each rank's sum of exp below the global max,
    all-reduced ((B, S) tensors, where ``DTensor`` would gather the logits
    whole). The max is a constant of the result's value, so its gradient
    is the softmax of each rank's own logits."""
    import torch.distributed._functional_collectives as funcol

    Partial, Replicate, Shard = _pl()
    mesh = logits.device_mesh
    if not (_vocab_split(logits, 2) or _vocab_split(logits, -1)):
        return torch.logsumexp(logits, dim=-1)
    mi = _model_dim(mesh)
    batch = _batch_axes(mesh, logits)
    lpl = _places(mesh, batch, 0, Shard(2))
    group = (mesh, mi)

    def fn(ll):
        m = funcol.wait_tensor(funcol.all_reduce(ll.detach().amax(-1), "max", group))
        share = torch.exp(ll - m[..., None]).sum(-1)
        return m + torch.log(_ShareSum.apply(share, group))

    return local_map(fn, out_placements=(_places(mesh, batch, 0, Replicate()),),
                     in_placements=(lpl,), in_grad_placements=(lpl,), device_mesh=mesh,
                     redistribute_inputs=True)(logits)


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

    first = _vocab_first(table, 0) if vsplit else 0

    def fn(tl, wl):
        if not vsplit:
            return F.embedding(tl, wl)
        V = wl.shape[0]
        loc = tl - first
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

    first = _vocab_first(logits, -1) if vsplit else 0

    def fn(ll, tl):
        if not vsplit:
            return ll.gather(-1, tl[..., None])[..., 0]
        V = ll.shape[-1]
        loc = tl - first
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
