"""Carry weights over from numpy: the JAX package's params become the
port's tensors one to one (same nested-dict keys, same shapes and dtypes).

The caller turns a JAX pytree into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``); this module never sees
JAX. ``torch.from_numpy`` rejects the ml_dtypes ``bfloat16`` that numpy
holds for bf16 leaves, so those go over as their 16-bit pattern and are
viewed back as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.data.database import resolve_device


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.array(a)  # own, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
