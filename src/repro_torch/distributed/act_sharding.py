"""Activation sharding constraints, injected without touching model code.

A cell sets a policy (name -> placements, or name -> a ``rules.P`` spec)
while its step runs; the model calls ``constrain(x, "residual")`` at each
period boundary. ``constrain`` redistributes a ``DTensor`` to the policy's
placements on its own mesh. With no policy, for a name the policy does not
hold, or on a plain tensor it is the identity, so model code runs unchanged
on one device.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from repro_torch.distributed.compat import is_dtensor
from repro_torch.distributed.rules import P, placements

_tls = threading.local()


def current_policy() -> Optional[Dict[str, object]]:
    return getattr(_tls, "policy", None)


@contextmanager
def activation_policy(policy: Optional[Dict[str, object]]):
    prev = current_policy()
    _tls.policy = policy
    try:
        yield
    finally:
        _tls.policy = prev


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    policy = current_policy()
    if policy is None or name not in policy:
        return x
    if not is_dtensor(x):
        return x

    want = policy[name]
    if isinstance(want, P):
        want = placements(x.device_mesh, want)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def placed_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``ref``'s placements when both are
    ``DTensor``s that differ (a row-parallel product's partial sum added to
    the residual is reduce-scattered to the residual's layout, and its
    backward gathers the gradient whole); otherwise ``x`` as it is."""
    if is_dtensor(x) and is_dtensor(ref) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x
