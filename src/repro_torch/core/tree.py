"""Trees of tensors — nested dicts, NamedTuples, lists and tuples — in
the JAX package's pytree order, for the training state: dict keys
sorted, NamedTuple fields in declaration order, sequences by index,
``None`` an empty subtree. ``leaves_with_paths`` names each leaf by the
keys, field names and indices on its way down, as the JAX package's
checkpoint names its files (``repro/checkpoint/manager.py:_leaf_paths``)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` of every leaf, in pytree order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, sub in _children(tree):
        out.extend(leaves_with_paths(sub, prefix + (name,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in pytree
    order, by ``new_leaves``."""
    it: Iterator = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        parts = [build(v) for v in t]
        return type(t)(*parts) if hasattr(t, "_fields") else type(t)(parts)

    return build(template)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
