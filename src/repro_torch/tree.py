"""Nested containers of tensors (the port's parameter and train-state
trees): dicts, tuples and lists, walked as `jax.tree_util` walks them —
dict keys in sorted order — so leaf order and the path names of
checkpoints match the reference's."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_path(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) in the reference's order; a path is the tuple of dict
    keys and sequence indices from the root."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from leaves_with_path(x, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [x for _, x in leaves_with_path(tree)]


def path_key(path: tuple) -> str:
    """A path as the checkpoint key the reference writes ("a/0/b")."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`, in
    a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_unzip(tree, like, n: int) -> tuple:
    """A tree shaped like `like` whose leaves are n-tuples, as n trees."""
    def part(t, l, i):
        if isinstance(l, dict):
            return {k: part(t[k], l[k], i) for k in l}
        if isinstance(l, (tuple, list)):
            return type(l)(part(t[j], x, i) for j, x in enumerate(l))
        return t[i]
    return tuple(part(tree, like, i) for i in range(n))


def replace_leaves(tree, by: dict, missing: Callable = lambda x: x,
                   prefix: tuple = ()):
    """`tree` with the leaf at each path of `by` replaced by its value,
    every other leaf passed through `missing`."""
    if isinstance(tree, dict):
        return {k: replace_leaves(v, by, missing, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(replace_leaves(x, by, missing, prefix + (i,))
                          for i, x in enumerate(tree))
    return by[prefix] if prefix in by else missing(tree)
