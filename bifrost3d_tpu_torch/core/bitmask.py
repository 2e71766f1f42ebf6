"""Typed bitmask wrapper — counterpart of ``Core/Bitmask.h``.

A copy of ``bifrost3d_tpu/core/bitmask.py`` (``Bitmask``).
"""

from __future__ import annotations


class Bitmask:
    """A small typed bitmask with the reference's query surface
    (is_set / any_set / not_set / contains)."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = int(value)

    def is_set(self, flags: int) -> bool:
        """All of ``flags`` set."""
        return (self.value & int(flags)) == int(flags)

    def any_set(self, flags: int) -> bool:
        return (self.value & int(flags)) != 0

    def not_set(self, flags: int) -> bool:
        return (self.value & int(flags)) == 0

    def contains(self, flags: int) -> bool:
        return self.is_set(flags)

    def set(self, flags: int) -> "Bitmask":
        self.value |= int(flags)
        return self

    def clear(self, flags: int = ~0) -> "Bitmask":
        self.value &= ~int(flags)
        return self

    def __or__(self, other):
        return Bitmask(self.value | int(other))

    def __and__(self, other):
        return Bitmask(self.value & int(other))

    def __int__(self):
        return self.value

    def __eq__(self, other):
        return self.value == int(other)

    def __bool__(self):
        return self.value != 0

    def __repr__(self):
        return f"Bitmask({self.value:#x})"
