"""Trees of tensors: nested mappings and lists whose leaves are tensors
(or numpy arrays), the port's stand-in for the JAX pytrees that the
reference's parameter layouts, optimizer and checkpoints walk.  The one
walker of the port: every function that maps over a parameter, gradient
or optimizer tree goes through it.  :func:`tree_map` keeps each mapping's
key order; :func:`tree_items` visits keys in sorted order and list items
in order, as ``jax.tree_util`` flattens them, and joins a leaf's keys and
indices with "/", as the reference's checkpoint keys are."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple

Path = Tuple[Any, ...]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: Path = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree``;
    ``path`` is the tuple of the keys (str) and list indices (int) that
    lead to the leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, t, *(r[i] for r in rest),
                                   path=path + (i,))
                for i, t in enumerate(tree)]
    return fn(path, tree, *rest)


def key_names(path: Path) -> Tuple[str, ...]:
    """The mapping keys of ``path``, list indices left out (the names
    ``parallel/sharding.py::tp_dim`` reads)."""
    return tuple(str(k) for k in path if not isinstance(k, int))


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in flattening order, the path "/"-joined."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_items(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


__all__ = ["tree_map", "tree_map_with_path", "key_names", "tree_items",
           "tree_leaves"]
