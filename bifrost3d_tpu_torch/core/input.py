"""Keyboard and mouse state — counterpart of ``Input/Keyboard.h`` /
``Input/Mouse.h`` (SURVEY.md §2.3): key state + halftap counts +
consumed-codepoint stream, mouse position/delta/buttons/scroll.

A copy of ``bifrost3d_tpu/core/input.py`` (``Keyboard``, ``Mouse``).
"""

from __future__ import annotations


class Keyboard:
    MAX_HALFTAP_COUNT = 127

    def __init__(self):
        self._pressed = {}
        self._halftaps = {}
        self._codepoints: list[str] = []

    def key_tapped(self, key, halftaps: int = 1) -> None:
        self._halftaps[key] = min(
            self._halftaps.get(key, 0) + halftaps, self.MAX_HALFTAP_COUNT)
        if halftaps % 2 == 1:
            self._pressed[key] = not self._pressed.get(key, False)

    def press(self, key) -> None:
        if not self._pressed.get(key, False):
            self.key_tapped(key)

    def release(self, key) -> None:
        if self._pressed.get(key, False):
            self.key_tapped(key)

    def is_pressed(self, key) -> bool:
        return self._pressed.get(key, False)

    def is_released(self, key) -> bool:
        return not self.is_pressed(key)

    def halftaps(self, key) -> int:
        return self._halftaps.get(key, 0)

    def was_pressed(self, key) -> bool:
        """Pressed at some point during this tick."""
        taps = self.halftaps(key)
        pressed = self.is_pressed(key)
        return taps >= 2 or (pressed and taps == 1)

    def was_released(self, key) -> bool:
        taps = self.halftaps(key)
        return taps >= 2 or (not self.is_pressed(key) and taps == 1)

    def add_codepoint(self, cp: str) -> None:
        self._codepoints.append(cp)

    def get_text(self) -> str:
        return "".join(self._codepoints)

    def per_frame_reset(self) -> None:
        self._halftaps.clear()
        self._codepoints.clear()


class Mouse:
    LEFT, RIGHT, MIDDLE, BUTTON4 = range(4)

    def __init__(self):
        self.position = (0, 0)
        self.delta = (0, 0)
        self._pressed = [False] * 4
        self._halftaps = [0] * 4
        self.scroll_delta = 0.0

    def set_position(self, x: int, y: int) -> None:
        px, py = self.position
        self.delta = (self.delta[0] + x - px, self.delta[1] + y - py)
        self.position = (x, y)

    def button_tapped(self, button: int, pressed: bool) -> None:
        self._pressed[button] = pressed
        self._halftaps[button] = min(self._halftaps[button] + 1, 127)

    def is_pressed(self, button: int) -> bool:
        return self._pressed[button]

    def halftaps(self, button: int) -> int:
        return self._halftaps[button]

    def per_frame_reset(self) -> None:
        self.delta = (0, 0)
        self._halftaps = [0] * 4
        self.scroll_delta = 0.0
