"""Map a function over the tensors of nested state dataclasses and dicts."""
from __future__ import annotations

from dataclasses import fields, is_dataclass


def tree_map(fn, tree, *rest):
    """fn(leaf, *matching leaves of rest) over dataclass fields and dict
    values, keeping the structure; None stays None."""
    if tree is None:
        return None
    if is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in fields(tree)
        })
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
