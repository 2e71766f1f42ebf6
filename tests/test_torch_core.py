"""The port's ``core/`` against ``tests/test_core.py`` and the JAX package.

The UID, ChangeSet, Engine and input cases mirror ``tests/test_core.py``
on the port's classes; one seeded script of creates, erases, change bits
and key taps then runs through both packages' classes, which must answer
alike at every step.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test worker)

from bifrost3d_tpu import core as jax_core
from bifrost3d_tpu_torch import core
from bifrost3d_tpu_torch.core import (
    Bitmask,
    ChangeSet,
    Engine,
    Keyboard,
    Mouse,
    TypedUIDGenerator,
)
from bifrost3d_tpu_torch.core.uid import UID


class TestUID:
    def test_generate_and_has(self):
        gen = TypedUIDGenerator()
        a = gen.generate()
        b = gen.generate()
        assert gen.has(a) and gen.has(b)
        assert a != b
        assert not gen.has(UID.invalid())

    def test_erase_invalidates(self):
        gen = TypedUIDGenerator()
        a = gen.generate()
        assert gen.erase(a)
        assert not gen.has(a)
        assert not gen.erase(a)

    def test_incarnation_detects_stale_handles(self):
        gen = TypedUIDGenerator(capacity=2)
        a = gen.generate()
        gen.erase(a)
        for _ in range(16):
            b = gen.generate()
            if b.index == a.index:
                break
            gen.erase(b)
        else:
            pytest.fail("slot never recycled")
        assert b.index == a.index and b.incarnation != a.incarnation
        assert gen.has(b) and not gen.has(a)

    def test_growth(self):
        gen = TypedUIDGenerator(capacity=2)
        ids = [gen.generate() for _ in range(100)]
        assert all(gen.has(i) for i in ids)
        assert len(set(int(i) for i in ids)) == 100
        assert sorted(i.index for i in gen) == sorted(i.index for i in ids)


class TestBitmaskChangeSet:
    def test_bitmask_queries(self):
        m = Bitmask(0b0110)
        assert m.is_set(0b0110) and m.any_set(0b0010)
        assert m.not_set(0b1000) and not m.is_set(0b0111)

    def test_changeset_accumulates_and_resets(self):
        cs = ChangeSet()
        a, b = UID(1, 0), UID(2, 0)
        cs.add_change(a, ChangeSet.CREATED)
        cs.add_change(a, ChangeSet.UPDATED)
        cs.set_change(b, ChangeSet.DESTROYED)
        assert cs.has_changes(a, ChangeSet.CREATED | ChangeSet.UPDATED)
        assert list(cs.get_changed_resources()) == [a, b]
        cs.reset_change_notifications()
        assert not cs.any_changes
        assert cs.get_changes(a) == 0


class TestEngine:
    def test_tick_phase_order(self):
        order = []
        e = Engine()
        e.add_mutating_callback(lambda _: order.append("mutate"))
        e.add_non_mutating_callback(lambda _: order.append("render"))
        e.add_tick_cleanup_callback(lambda _: order.append("cleanup"))
        e.do_tick(dt=0.016)
        assert order == ["mutate", "render", "cleanup"]
        assert e.time.ticks == 1 and e.time.delta == 0.016

    def test_quit_stops_run(self):
        e = Engine()
        count = []

        def cb(engine):
            count.append(1)
            if len(count) >= 3:
                engine.request_quit()
        e.add_mutating_callback(cb)
        e.run()
        assert len(count) == 3

    def test_window_change_bits(self):
        e = Engine()
        e.window.resize(800, 600)
        assert e.window.changes & e.window.CHANGE_RESIZED
        e.do_tick(0.016)
        assert e.window.changes == 0


class TestInput:
    def test_keyboard_taps(self):
        k = Keyboard()
        k.press("w")
        assert k.is_pressed("w") and k.was_pressed("w")
        k.per_frame_reset()
        assert k.is_pressed("w") and not k.was_pressed("w")
        k.release("w")
        assert k.was_released("w")

    def test_mouse_delta(self):
        m = Mouse()
        m.set_position(10, 10)
        m.per_frame_reset()
        m.set_position(15, 12)
        assert m.delta == (5, 2)
        m.button_tapped(Mouse.LEFT, True)
        assert m.is_pressed(Mouse.LEFT) and m.halftaps(Mouse.LEFT) == 1


def _drive(pkg, seed: int = 14, steps: int = 400) -> list:
    """One seeded script through a package's core classes → the trace of
    every answer they gave. ``pkg`` is the JAX package's ``core`` or the
    port's."""
    rng = np.random.default_rng(seed)
    gen = pkg.TypedUIDGenerator(capacity=2)
    changes = pkg.ChangeSet()
    keyboard, mouse = pkg.Keyboard(), pkg.Mouse()
    engine = pkg.Engine(pkg.Window("w", 64, 48))
    ticks = []
    engine.add_mutating_callback(lambda e: ticks.append(("m", e.time.ticks)))
    engine.add_non_mutating_callback(lambda e: ticks.append(("n", e.time.ticks)))
    engine.add_tick_cleanup_callback(lambda e: ticks.append(("c", e.time.ticks)))
    live, dead, trace = [], [], []
    for _ in range(steps):
        op = int(rng.integers(0, 9))
        if op <= 2 or not live:
            uid = gen.generate()
            live.append(uid)
            changes.add_change(uid, pkg.ChangeSet.CREATED)
            trace.append(("gen", int(uid), uid.index, uid.incarnation))
        elif op == 3:
            uid = live.pop(int(rng.integers(0, len(live))))
            dead.append(uid)
            changes.add_change(uid, pkg.ChangeSet.DESTROYED)
            trace.append(("erase", int(uid), gen.erase(uid), gen.erase(uid)))
        elif op == 4:
            uid = live[int(rng.integers(0, len(live)))]
            bits = int(rng.integers(0, 8))
            (changes.set_change if rng.integers(0, 2) else
             changes.add_change)(uid, bits)
            trace.append(("change", int(uid), changes.get_changes(uid),
                          changes.has_changes(uid, bits)))
        elif op == 5:
            trace.append(("changed", [int(u) for u in
                                      changes.get_changed_resources()],
                          changes.any_changes))
            if rng.integers(0, 3) == 0:
                changes.reset_change_notifications()
        elif op == 6:
            key = "wasdqe"[int(rng.integers(0, 6))]
            how = int(rng.integers(0, 4))
            if how == 0:
                keyboard.press(key)
            elif how == 1:
                keyboard.release(key)
            elif how == 2:
                keyboard.key_tapped(key, int(rng.integers(1, 4)))
            else:
                keyboard.per_frame_reset()
            trace.append(("key", key, keyboard.is_pressed(key),
                          keyboard.halftaps(key), keyboard.was_pressed(key),
                          keyboard.was_released(key)))
        elif op == 7:
            x, y = (int(v) for v in rng.integers(0, 100, 2))
            mouse.set_position(x, y)
            button = int(rng.integers(0, 4))
            mouse.button_tapped(button, bool(rng.integers(0, 2)))
            trace.append(("mouse", mouse.position, mouse.delta,
                          mouse.is_pressed(button), mouse.halftaps(button)))
            if rng.integers(0, 2):
                mouse.per_frame_reset()
        else:
            engine.window.resize(int(rng.integers(1, 4)) * 32, 48)
            engine.do_tick(float(rng.integers(1, 5)) / 60.0)
            trace.append(("tick", engine.time.ticks, engine.time.delta,
                          engine.window.changes))
        trace.append(("alive", gen.count, gen.capacity,
                      sorted(int(u) for u in gen),
                      [gen.has(u) for u in live + dead]))
    return trace + ticks


def test_seeded_script_matches_jax():
    assert _drive(core) == _drive(jax_core)
