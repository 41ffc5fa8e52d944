"""Nested dicts of tensors (the port's counterpart of a JAX pytree of
parameters or optimiser state): flatten to ``/``-joined paths in sorted
key order, as the reference's checkpointer and ``jax.tree`` order them,
and back."""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple


def leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict in sorted key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


def unflatten(flat: Dict[str, Any]) -> Dict:
    """The nested dict whose :func:`leaves` are ``flat``."""
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def map_tree(fn, tree: Dict) -> Dict:
    """``fn`` applied to every leaf of a nested dict, same structure."""
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
