"""The tree walks the port needs over its plain dicts and lists of tensors
(parameters, gradients, optimizer moments): leaves in a fixed order, the
same with their paths, and a map that keeps the structure."""
from __future__ import annotations


def leaves(tree) -> list:
    """Every leaf, dict values in insertion order and list items in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn, tree):
    """``tree`` with every leaf x replaced by fn(x)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def items(tree, path: str = ""):
    """(path, leaf) for every leaf, in ``leaves``' order; a path joins dict
    keys and list indices with "/" (``layers/3/mixer/wq``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from items(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree
