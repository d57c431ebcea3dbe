"""Seeded weights, made on the device in a few large draws.

Every leaf of a configuration's layout (``configs/<name>.py``'s
``layout``) is a view of one flat buffer per dtype. Each buffer is filled
from a ``torch.Generator`` seeded with the run's seed, uniform in [-1, 1)
in pieces of ``PIECE`` elements, in the dtype the weights are served in;
then each leaf is shaped in place by its rule:

* ``("uniform", b)``: uniform in [-b, b);
* ``("near_one", a)``: 1 + uniform in [-a, a) (norm scales, D);
* ``("log_uniform_a", lo, hi)``: log of uniform in [lo, hi) (Mamba2's A_log);
* ``("dt_bias", lo, hi)``: softplus⁻¹ of dt, log-uniform in [lo, hi).

The same seed on the same device gives the same weights, so the reference
draws them again once the program's run is over. A node that holds several
functions gives each its own: function ``f`` draws from the streams
``FUNCTION_STREAMS * f`` on (function 0 from the plain seed's)."""
from __future__ import annotations

import math
from typing import Iterable

import torch

PIECE = 1 << 28
FUNCTION_STREAMS = 1000
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _shape(v: torch.Tensor, rule) -> None:
    kind = rule[0]
    if kind == "uniform":
        v.mul_(rule[1])
    elif kind == "near_one":
        v.mul_(rule[1]).add_(1.0)
    elif kind == "log_uniform_a":
        lo, hi = rule[1], rule[2]
        v.add_(1.0).mul_((hi - lo) / 2).add_(lo).log_()
    elif kind == "dt_bias":
        lo, hi = math.log(rule[1]), math.log(rule[2])
        v.add_(1.0).mul_((hi - lo) / 2).add_(lo).exp_()  # dt
        v.copy_(torch.log(torch.expm1(v)))
    else:
        raise ValueError(f"unknown weight rule {rule!r}")


def numel(layout: Iterable) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout)


def nbytes(layout: Iterable) -> int:
    return sum(math.prod(shape) * DTYPES[dt].itemsize for _, shape, dt, _ in layout)


def make(layout: list, seed: int, device, function: int = 0) -> dict:
    """The nested weight tree of ``layout`` drawn from ``seed`` on ``device``
    for the node's function ``function``."""
    device = torch.device(device)
    tree: dict = {}
    for stream, (name, dtype) in enumerate(sorted(DTYPES.items())):
        leaves = [leaf for leaf in layout if leaf[2] == name]
        if not leaves:
            continue
        total = numel(leaves)
        flat = torch.empty(total, dtype=dtype, device=device)
        g = generator(seed, device, FUNCTION_STREAMS * function + stream)
        for a in range(0, total, PIECE):
            flat[a:a + PIECE].uniform_(-1.0, 1.0, generator=g)
        at = 0
        for path, shape, _, rule in leaves:
            n = math.prod(shape)
            v = flat[at:at + n].view(shape)
            _shape(v, rule)
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = v
            at += n
    return tree
