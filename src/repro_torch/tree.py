"""Trees of nested dicts, lists and tuples whose leaves are tensors (or
numpy arrays, or Python numbers): the port's stand-in for a JAX pytree.

Leaves come in ``jax.tree_util``'s order (dict keys sorted, sequences by
index) and ``None`` is an empty subtree, so a path names the same leaf in
both packages: checkpoints key their files by it, and AdamW numbers its
leaves by it.
"""
from __future__ import annotations


def leaves(tree, prefix: tuple = ()):
    """(path, leaf) pairs; a path is the tuple of ``str`` keys and indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def rebuild(tree, fn, prefix: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, fn, prefix + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def get(tree, path: tuple):
    """The subtree at ``path``."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def put(tree, path: tuple, value) -> None:
    """Replace the subtree at ``path`` (its parent must be a dict or list)."""
    parent = get(tree, path[:-1])
    k = path[-1]
    parent[int(k) if isinstance(parent, list) else k] = value
