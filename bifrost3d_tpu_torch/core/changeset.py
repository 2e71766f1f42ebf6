"""Per-tick change tracking — counterpart of ``Core/ChangeSet.h:22-78``.

Every manager records a change bitmask per resource plus a compact list of
changed ids for the tick; renderers diff-sync from it and a tick-cleanup
callback resets it (SURVEY.md §1 "the architectural trick").

A copy of ``bifrost3d_tpu/core/changeset.py`` (``ChangeSet``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from bifrost3d_tpu_torch.core.uid import UID


class ChangeSet:
    CREATED = 1
    DESTROYED = 2
    UPDATED = 4

    def __init__(self):
        self._changes: Dict[int, int] = {}
        self._order: List[UID] = []

    def set_change(self, uid: UID, change: int) -> None:
        """Replace the resource's change bits."""
        if int(uid) not in self._changes:
            self._order.append(uid)
        self._changes[int(uid)] = change

    def add_change(self, uid: UID, change: int) -> None:
        """OR new change bits onto the resource."""
        if int(uid) not in self._changes:
            self._order.append(uid)
        self._changes[int(uid)] = self._changes.get(int(uid), 0) | change

    def get_changes(self, uid: UID) -> int:
        return self._changes.get(int(uid), 0)

    def has_changes(self, uid: UID, change: int) -> bool:
        return (self.get_changes(uid) & change) == change

    def get_changed_resources(self) -> Iterable[UID]:
        return list(self._order)

    @property
    def any_changes(self) -> bool:
        return bool(self._changes)

    def reset_change_notifications(self) -> None:
        self._changes.clear()
        self._order.clear()
