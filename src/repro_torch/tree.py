"""Nested trees of tensors: the port's params, optimizer moments and train
states (dicts, lists, tuples and NamedTuples with tensor leaves; None is an
empty subtree, as in a JAX pytree).  Dict keys are visited sorted, as JAX
flattens a dict, so two trees of one structure list their leaves in one
order whatever order their dicts were filled in."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

import torch


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(t: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(t, dict):
        for k in sorted(t):
            yield str(k), t[k]
    elif _is_namedtuple(t):
        yield from zip(t._fields, t)
    elif isinstance(t, (list, tuple)):
        yield from ((str(i), v) for i, v in enumerate(t))


def _is_node(t: Any) -> bool:
    return isinstance(t, (dict, list, tuple))


def leaves_with_paths(tree: Any, prefix: str = ""
                      ) -> List[Tuple[str, torch.Tensor]]:
    """[(path, leaf)] in flattening order; a path joins the keys, field
    names and list indices from the root with "/"."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, new_leaves: Sequence[Any]) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in flattening
    order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        kids = [build(v) for _, v in _children(t)]
        if _is_namedtuple(t):
            return type(t)(*kids)
        return type(t)(kids)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of its
    structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structures")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
