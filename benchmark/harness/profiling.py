"""Reading a torch.profiler session of a traced segment.

The device's events are placed on the card's own clock between two spin
kernels (``spin``), one before the segment and one after it, as
``chip_smoke._spin`` / ``_device_ranges`` of the repository do; the raw
kineto events are read, since building torch's event tree over many
thousands of them costs the host tens of seconds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SPAN_PREFIX = "bench."


def spin() -> None:
    """A spin kernel (``torch.cuda._sleep``) that marks, on the card's own
    clock, where a traced segment begins or ends."""
    torch.cuda._sleep(1000)


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Segment(NamedTuple):
    """What a traced segment ran: the device's activities (kernels,
    memsets and copies, spin kernels and span annotations left out), the
    benchmark's own host spans, and the segment's bounds on the device
    clock."""

    device: list
    spans: list
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def launches(self) -> int:
        """Kernels and memsets (copies are no launch)."""
        return sum(1 for e in self.device if not e.name.startswith("Memcpy"))

    def busy_s(self) -> float:
        """Seconds in which some activity ran on the device."""
        return sum(b - a for a, b in _union(self.device)) / 1e9

    def device_s(self, word: str) -> float:
        """Summed duration of the activities whose name holds ``word``."""
        return sum(e.end_ns - e.start_ns for e in self.device
                   if word in e.name) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost benchmark span the host was in."""
        ops = {}
        for e in self.device:
            ops[e.name] = ops.get(e.name, 0) + (e.end_ns - e.start_ns)
        gaps = {}
        busy = _union(self.device)
        edges = [self.start_ns] + [x for ab in busy for x in ab] + [self.end_ns]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            inside = [s for s in self.spans if s.start_ns <= mid < s.end_ns]
            label = (min(inside, key=lambda s: s.end_ns - s.start_ns).name
                     if inside else "host:outside_spans")
            gaps[label] = gaps.get(label, 0) + (b - a)

        def top_list(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_list(ops), "idle_gaps": top_list(gaps)}


def _union(events) -> list:
    merged = []
    for a, b in sorted((e.start_ns, e.end_ns) for e in events):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def segment(prof) -> Segment | None:
    """The traced segment of a profiler session that ran ``spin()`` first
    and last; None where the card's trace holds no spin kernel (lost)."""
    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == cuda:
            device.append(ev)
        elif ev.name.startswith(SPAN_PREFIX):
            spans.append(ev)
    device.sort(key=lambda e: e.start_ns)
    spins = [i for i, e in enumerate(device) if "spin_kernel" in e.name]
    if len(spins) < 2:
        return None
    first, last = device[spins[0]], device[spins[-1]]
    inside = [e for e in device[spins[0] + 1:spins[-1]]
              if "spin_kernel" not in e.name
              and not e.name.startswith(SPAN_PREFIX)]
    return Segment(inside, spans, first.end_ns, last.start_ns)
