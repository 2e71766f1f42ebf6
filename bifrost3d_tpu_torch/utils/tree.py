"""Flattening of the port's nested NamedTuples of tensors.

The port's scene data (``RenderScene``, ``PinholeCamera``, ...) are
NamedTuples whose fields are tensors, None, plain numbers or further
NamedTuples. :func:`tree_flatten` lists the tensors in field order and
returns the inverse, so a caller can swap every tensor (for one that
requires grad, or for its gradient) and rebuild the same structure.
"""

from __future__ import annotations

import torch


def tree_flatten(tree):
    """→ (the tensors of ``tree`` in field order, ``unflatten(leaves)``
    building the same structure around new leaves). Anything that is
    neither a tensor nor a tuple is kept as it is."""
    leaves = []

    def maker(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return next
        if isinstance(node, tuple):
            makers = [maker(field) for field in node]
            if hasattr(node, "_fields"):
                return lambda it: type(node)._make(m(it) for m in makers)
            return lambda it: tuple(m(it) for m in makers)
        return lambda it: node

    build = maker(tree)

    def unflatten(new_leaves):
        return build(iter(new_leaves))

    return leaves, unflatten


def tree_to(tree, device):
    """``tree`` with every tensor on ``device`` (a tensor already there is
    kept by identity, so the kernels' table caches keep hitting)."""
    leaves, unflatten = tree_flatten(tree)
    return unflatten([t.to(device) for t in leaves])
