"""Trees of tensors: nested dicts, lists and tuples whose leaves are
tensors or arrays, walked in the reference's (``jax.tree_util``) order.

Dict keys are visited sorted, sequences in order, a named tuple by its
fields (``AdamWState``), and ``None`` is an empty subtree.  The
parameters, gradients and AdamW moments that the trainer holds, and the
trees a checkpoint writes, are all such trees.
"""
from __future__ import annotations


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, path=()):
    """``(path, leaf)`` for every leaf of ``tree``, in :func:`tree_leaves`
    order; a path is the tuple of keys, indices and field names leading
    to the leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif is_namedtuple(tree):
        for k in tree._fields:
            yield from leaves_with_path(getattr(tree, k), path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [x for _, x in leaves_with_path(tree)]


def _child(tree, key):
    """``tree[key]``, or a named tuple's field ``key`` (a restored
    checkpoint holds a named tuple as the dict of its fields)."""
    if is_namedtuple(tree) and isinstance(key, str):
        return getattr(tree, key)
    return tree[key]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure, where a named tuple may stand for the dict
    of its fields); ``tree``'s containers are rebuilt as they were (named
    tuples as their type), its ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(_child(r, k) for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if is_namedtuple(tree) else type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(skeleton, leaves):
    """A tree shaped as ``skeleton`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return type(t)(*out) if is_namedtuple(t) else type(t)(out)
        return next(it)
    return build(skeleton)


__all__ = ["is_namedtuple", "leaves_with_path", "tree_leaves", "tree_map",
           "tree_unflatten"]
