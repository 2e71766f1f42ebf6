"""Typed UID handles: Bitsquid-style slot map.

A copy of ``bifrost3d_tpu/core/uid.py`` (``UID``, ``TypedUIDGenerator``),
which imports no JAX; the port keeps its own.

Counterpart of ``Core/UniqueIDGenerator.h:24-134`` (SURVEY.md §2.1):
24-bit slot index + 8-bit incarnation so stale handles are detected when a
slot is recycled; typed per manager so a MeshID can't index Materials.
"""

from __future__ import annotations

from typing import Generic, Iterator, TypeVar

INDEX_BITS = 24
INCARNATION_BITS = 8
MAX_IDS = (1 << INDEX_BITS) - 1

T = TypeVar("T")


class UID:
    """An opaque handle: (index, incarnation) packed like the reference."""

    __slots__ = ("_packed",)

    def __init__(self, index: int, incarnation: int):
        self._packed = (incarnation << INDEX_BITS) | index

    @property
    def index(self) -> int:
        return self._packed & MAX_IDS

    @property
    def incarnation(self) -> int:
        return self._packed >> INDEX_BITS

    def __int__(self) -> int:
        return self._packed

    def __index__(self) -> int:
        return self.index

    def __eq__(self, other) -> bool:
        return isinstance(other, UID) and self._packed == other._packed

    def __hash__(self) -> int:
        return self._packed

    def __repr__(self) -> str:
        return f"UID({self.index}#{self.incarnation})"

    @staticmethod
    def invalid() -> "UID":
        return UID(0, 0)


class TypedUIDGenerator(Generic[T]):
    """Slot allocator with incarnation counters.

    Slot 0 is reserved as the invalid id (like the reference). ``generate``
    reuses erased slots, bumping their incarnation so stale UIDs fail
    ``has``.
    """

    def __init__(self, capacity: int = 8):
        self._incarnations = [0]      # slot 0 reserved/invalid
        self._alive = [False]
        self._free: list[int] = []
        self.reserve(capacity)

    def reserve(self, capacity: int) -> None:
        while len(self._incarnations) < capacity + 1:
            self._incarnations.append(0)
            self._alive.append(False)
            self._free.append(len(self._incarnations) - 1)

    @property
    def capacity(self) -> int:
        return len(self._incarnations)

    @property
    def count(self) -> int:
        return sum(self._alive) - (1 if self._alive[0] else 0)

    def generate(self) -> UID:
        if not self._free:
            self.reserve(self.capacity * 2)
        slot = self._free.pop(0)
        self._alive[slot] = True
        return UID(slot, self._incarnations[slot])

    def erase(self, uid: UID) -> bool:
        if not self.has(uid):
            return False
        slot = uid.index
        self._alive[slot] = False
        self._incarnations[slot] = (self._incarnations[slot] + 1) % (
            1 << INCARNATION_BITS)
        self._free.append(slot)
        return True

    def has(self, uid: UID) -> bool:
        return (0 < uid.index < len(self._incarnations)
                and self._alive[uid.index]
                and self._incarnations[uid.index] == uid.incarnation)

    def __iter__(self) -> Iterator[UID]:
        for slot in range(1, len(self._incarnations)):
            if self._alive[slot]:
                yield UID(slot, self._incarnations[slot])
