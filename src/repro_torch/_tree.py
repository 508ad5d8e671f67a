"""Pytrees as the reference's ``jax.tree`` walks them.

JAX visits a dict's entries in sorted key order; torch's pytree keeps
insertion order. The ops a step emits, and so the mapper's node order,
follow the walk, and the checkpoint key paths name the leaves: both must
be the reference's. Dicts, lists and tuples are containers; ``None`` is an
empty subtree; everything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree, *rest,
             is_leaf: Callable[[Any], bool] | None = None):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (the reference's prefix semantics: ``rest`` may be deeper
    where ``tree`` has a leaf), dict entries in sorted key order. Each
    result keeps ``tree``'s structure, key order included. ``is_leaf``
    marks further subtrees as leaves, as in ``jax.tree.map``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *[r[k] for r in rest],
                           is_leaf=is_leaf)
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *[r[i] for r in rest],
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def leaves_with_path(tree, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``("a/b/0", leaf)`` pairs in the reference's order: the key paths
    of ``repro.checkpoint.ckpt._flatten``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from leaves_with_path(t, (*prefix, str(i)))
    elif tree is not None:
        yield "/".join(prefix), tree


def map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over ``tree``'s leaves, structure kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, (*prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, t, (*prefix, str(i)))
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)
