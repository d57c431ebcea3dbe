"""Nested dicts of tensors (the JAX package's pytrees of parameters and
optimizer state) flattened in JAX's order: dict keys sorted, lists and
tuples by index. A leaf's path is its keys joined by "/", as the JAX
checkpoint manager's ``_path_str`` gives it (``params/layers/sub0/mixer/wq``,
``opt/step``)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple


def items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def unflatten(like: Any, new_leaves: Iterable[Any]) -> Any:
    """``like``'s structure with ``new_leaves`` in flatten order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # keep the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in zip(leaves(tree), *others)])
