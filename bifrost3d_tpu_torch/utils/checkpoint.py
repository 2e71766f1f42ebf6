"""Checkpoint and resume of trees of tensors.

Port of ``bifrost3d_tpu/utils/checkpoint.py`` (``_path_str``,
``save_checkpoint``, ``load_checkpoint``, ``latest_checkpoint``) with the
same file format, so that a checkpoint written by either package loads
into the other: one ``.npz`` (written to a temporary file, then renamed)
holding the leaves as ``leaf_{i}`` and a ``__checkpoint_meta__`` entry,
the UTF-8 JSON ``{"names": [...], "step": ..., "metadata": {...}}`` as
uint8. A leaf's name is its path in the tree as the JAX package names it:
dict keys, NamedTuple field names and sequence indices joined by "/", or
``<root>`` for a bare leaf; the walk visits dict keys sorted, as a pytree
flatten does, and None holds no leaf.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Optional

import numpy as np
import torch

_META_KEY = "__checkpoint_meta__"


def _flatten(tree):
    """→ ([(path, leaf)], rebuild(new_leaves)): the leaves of ``tree`` in
    pytree order with their paths (tuples of keys) and the inverse."""
    items = []

    def walk(node, path):
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            keys = sorted(node)
            makers = [walk(node[k], path + (k,)) for k in keys]
            return lambda it: {k: m(it) for k, m in zip(keys, makers)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            makers = [walk(v, path + (f,)) for f, v in zip(node._fields, node)]
            return lambda it: type(node)._make(m(it) for m in makers)
        if isinstance(node, (list, tuple)):
            makers = [walk(v, path + (i,)) for i, v in enumerate(node)]
            return lambda it: type(node)(m(it) for m in makers)
        items.append((path, node))
        return next

    build = walk(tree, ())
    return items, lambda leaves: build(iter(leaves))


def _path_str(path) -> str:
    return "/".join(str(p) for p in path) if path else "<root>"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None,
                    metadata: Optional[dict] = None) -> str:
    """Write a tree of tensors (or arrays, or numbers) to ``path`` (npz).
    Atomic: writes a temporary file in the same directory, then renames it.
    Returns ``path``."""
    items, _ = _flatten(tree)
    arrays = {f"leaf_{i}": _as_numpy(leaf) for i, (_, leaf) in
              enumerate(items)}
    meta = {"names": [_path_str(p) for p, _ in items], "step": step,
            "metadata": metadata or {}}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                      dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, like: Any = None):
    """Load a checkpoint → ``(tree, step, metadata)``.

    With ``like`` (a tree of the same structure, e.g. the freshly made
    state) the leaves are restored into that structure, each as a tensor of
    its template's dtype on its template's device (a numpy template gives
    an array of its dtype); names are checked against the saved ones, so
    that a reordering cannot pass silently. Without ``like``, a flat
    ``{name: numpy array}`` dict."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode("utf-8"))
        leaves = [data[f"leaf_{i}"] for i in range(len(meta["names"]))]

    if like is None:
        tree = dict(zip(meta["names"], leaves))
    else:
        items, rebuild = _flatten(like)
        if len(items) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                             f"has {len(items)}")
        for (p, _), name in zip(items, meta["names"]):
            if _path_str(p) != name:
                raise ValueError(f"leaf mismatch: checkpoint '{name}' vs "
                                 f"template '{_path_str(p)}'")
        restored = []
        for (_, template), leaf in zip(items, leaves):
            if isinstance(template, torch.Tensor):
                leaf = torch.as_tensor(np.asarray(leaf)).to(
                    dtype=template.dtype, device=template.device)
            elif hasattr(template, "dtype"):
                leaf = np.asarray(leaf, dtype=template.dtype)
            restored.append(leaf)
        tree = rebuild(restored)
    return tree, meta.get("step"), meta.get("metadata", {})


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """The highest-step ``{prefix}{step}.npz`` in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if not (name.startswith(prefix) and name.endswith(".npz")):
            continue
        try:
            step = int(name[len(prefix):-4])
        except ValueError:
            continue
        if step > best_step:
            best, best_step = os.path.join(directory, name), step
    return best
