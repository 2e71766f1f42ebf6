"""Host-side caches keyed by the identity and version of tensors.

A torch tensor can be written in place (``add_``, ``copy_``, an optimizer
step), so its ``id()`` alone does not say that its values are the ones a
cache was filled from. Every tensor carries a version counter that each
in-place write raises; a key of ``(id(t), t._version)`` per source tensor
misses after such a write, as after a ``_replace`` with a new tensor. An
entry keeps its source tensors alive, so an id in a stored key can never
be reused by another tensor while the entry lives.
"""

from __future__ import annotations


def tensor_key(*tensors) -> tuple:
    """``(id, version)`` of each tensor; None stays None."""
    return tuple(None if t is None else (id(t), t._version) for t in tensors)


class VersionedCache:
    """A bounded dict from (tensor keys, extra hashable) to a value; cleared
    whole when full. ``stores`` counts the values stored: each one was a
    miss that rebuilt its value."""

    def __init__(self, limit: int = 32):
        self._entries = {}
        self._limit = limit
        self.stores = 0

    def lookup(self, tensors, extra=()):
        """→ (key, cached value or None) for these source tensors."""
        key = (tensor_key(*tensors), extra)
        entry = self._entries.get(key)
        return key, None if entry is None else entry[0]

    def store(self, key, tensors, value):
        """Keep ``value`` under ``key`` (from :meth:`lookup`), pinning the
        source tensors; → value."""
        if len(self._entries) >= self._limit:
            self._entries.clear()
        self._entries[key] = (value, tuple(tensors))
        self.stores += 1
        return value

    def clear(self) -> None:
        self._entries.clear()

    def values(self) -> list:
        return [entry[0] for entry in self._entries.values()]

    def __len__(self) -> int:
        return len(self._entries)
