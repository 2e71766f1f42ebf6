"""Engine loop: tick = mutating → non-mutating → cleanup callbacks.

Counterpart of ``Core/Engine.h:33-92`` / ``Core/Engine.cpp:36-49``
(SURVEY.md §2.1): thread safety by architecture — scene mutation happens in
the mutating phase, renderers read-only in the non-mutating phase, change
notifications reset in cleanup.

A copy of ``bifrost3d_tpu/core/engine.py`` (``Time``, ``Window``,
``Engine``).
"""

from __future__ import annotations

import time as _time
from typing import Callable, List


class Time:
    """Tick timing: total time, delta time, tick count (Core/Time)."""

    def __init__(self):
        self.total = 0.0
        self.delta = 0.0
        self.ticks = 0
        self._last = None

    def tick(self, dt: float = None) -> None:
        now = _time.perf_counter()
        if dt is None:
            dt = 0.0 if self._last is None else now - self._last
        self._last = now
        self.delta = dt
        self.total += dt
        self.ticks += 1

    @property
    def is_first_tick(self) -> bool:
        return self.ticks <= 1


class Window:
    """Window metadata + change bits (Core/Window.h:25-56)."""

    CHANGE_NONE = 0
    CHANGE_RESIZED = 1
    CHANGE_RENAMED = 2

    def __init__(self, name: str = "bifrost3d_tpu", width: int = 640,
                 height: int = 480):
        self._name = name
        self._width = width
        self._height = height
        self.changes = 0

    @property
    def name(self) -> str:
        return self._name

    def set_name(self, name: str) -> None:
        self._name = name
        self.changes |= self.CHANGE_RENAMED

    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    @property
    def aspect_ratio(self) -> float:
        return self._width / self._height

    def resize(self, width: int, height: int) -> None:
        if (width, height) != (self._width, self._height):
            self._width, self._height = width, height
            self.changes |= self.CHANGE_RESIZED

    def reset_change_notifications(self) -> None:
        self.changes = 0


class Engine:
    """Owns Time + Window + quit flag; runs the three callback phases."""

    def __init__(self, window: Window = None):
        self.time = Time()
        self.window = window or Window()
        self._quit = False
        self._mutating: List[Callable] = []
        self._non_mutating: List[Callable] = []
        self._tick_cleanup: List[Callable] = []

    # Callback registration (Engine.h API surface).
    def add_mutating_callback(self, cb: Callable) -> None:
        self._mutating.append(cb)

    def add_non_mutating_callback(self, cb: Callable) -> None:
        self._non_mutating.append(cb)

    def add_tick_cleanup_callback(self, cb: Callable) -> None:
        self._tick_cleanup.append(cb)

    @property
    def is_quit_requested(self) -> bool:
        return self._quit

    def request_quit(self) -> None:
        self._quit = True

    def do_tick(self, dt: float = None) -> None:
        """One tick: mutating → non-mutating → cleanup (Engine.cpp:36-49)."""
        self.time.tick(dt)
        for cb in self._mutating:
            cb(self)
        for cb in self._non_mutating:
            cb(self)
        for cb in self._tick_cleanup:
            cb(self)
        self.window.reset_change_notifications()

    def run(self, max_ticks: int = None) -> None:
        """Headless main loop (the driver-layer analogue for offline use)."""
        ticks = 0
        while not self._quit and (max_ticks is None or ticks < max_ticks):
            self.do_tick()
            ticks += 1
