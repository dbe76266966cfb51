"""Trees of tensors: nested dicts, lists, tuples and named tuples, with
None as an empty subtree, walked in ``jax.tree_util``'s order (dict keys
sorted, sequences and named-tuple fields in order).  The port's params,
optimizer and train states are such trees; the checkpoint manager names
their leaves by the reference's path strings (``.params/['embed']/
['table']``)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Iterator[Tuple[str, Any]]:
    """(path key, child) pairs of an inner node, in the reference's
    order; a leaf has none."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield f"[{k!r}]", node[k]
    elif _is_namedtuple(node):
        for k in node._fields:
            yield f".{k}", getattr(node, k)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield f"[{i}]", v


def _is_leaf(node) -> bool:
    return node is not None and not isinstance(node, (dict, list, tuple))


def leaves_with_paths(tree) -> Tuple[List[str], List[Any]]:
    """Every leaf and its path: the keys from the root joined by ``/``."""
    paths, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        if _is_leaf(node):
            paths.append("/".join(path))
            leaves.append(node)
            return
        for key, child in _children(node):
            walk(child, path + [key])

    walk(tree, [])
    return paths, leaves


def tree_leaves(tree) -> List[Any]:
    return leaves_with_paths(tree)[1]


def tree_map(fn: Callable, tree, *rest):
    """A tree of ``tree``'s structure whose leaves are ``fn`` of the
    matching leaves of ``tree`` and ``rest`` (which share its structure);
    None stays None."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    kids = [tree_map(fn, v, *(r[i] for r in rest))
            for i, v in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*kids)
    return type(tree)(kids)


def tree_unflatten(like, leaves: List[Any]):
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_leaf(node):
            return next(it)
        kids = {key: build(child) for key, child in _children(node)}
        if isinstance(node, dict):
            return {k: kids[f"[{k!r}]"] for k in node}
        vals = list(kids.values())
        if _is_namedtuple(node):
            return type(node)(*vals)
        return type(node)(vals)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
