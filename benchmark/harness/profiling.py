"""Reading a torch.profiler session of a traced segment.

The device's events are placed on the card's own clock between two spin
kernels (``spin``), one before the segment and one after it, as
``chip_smoke._spin`` / ``_device_ranges`` of the repository do; the raw
kineto events are read, since building torch's event tree over many
thousands of them costs the host tens of seconds.

Beside the benchmark's own ``bench.*`` spans a segment keeps the
program's: the port's ``b3d.*`` host spans (``utils/profiling.span``) and
the change of its counters (``utils/profiling.counters``) over the
segment.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.utils.profiling import SPAN_PREFIX as PROGRAM_PREFIX
from bifrost3d_tpu_torch.utils.profiling import counters as program_counters

SPAN_PREFIX = "bench."
OUTSIDE_SPANS = "host:outside_spans"


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
    benchmark's own host spans, the segment's bounds on the device clock,
    the program's host spans, and by how much each of the program's
    counters rose over the segment."""

    device: list
    spans: list
    start_ns: int
    end_ns: int
    program_spans: list = ()
    counters: dict = {}

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

    def idle_gaps(self) -> list:
        """(start_ns, end_ns) of each stretch of the segment in which
        nothing ran on the device."""
        busy = _union(self.device)
        edges = [self.start_ns] + [x for ab in busy for x in ab] + [self.end_ns]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def idle_in(self, prefixes) -> float:
        """Seconds of idle gaps whose midpoint lies in a program span whose
        name starts with one of ``prefixes``."""
        prefixes = tuple(prefixes)
        spans = [s for s in self.program_spans if s.name.startswith(prefixes)]
        return sum(b - a for a, b in self.idle_gaps()
                   if _spans_at((a + b) // 2, spans)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost benchmark span the host was in
        (``idle_gaps``) and by the innermost program span
        (``idle_gaps_program``)."""
        ops = {}
        for e in self.device:
            ops[e.name] = ops.get(e.name, 0) + (e.end_ns - e.start_ns)
        gaps = self.idle_gaps()

        def top_list(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_list(ops),
                "idle_gaps": top_list(_by_innermost(gaps, self.spans)),
                "idle_gaps_program": top_list(
                    _by_innermost(gaps, self.program_spans))}


def _spans_at(t: int, spans) -> list:
    return [s for s in spans if s.start_ns <= t < s.end_ns]


def _by_innermost(gaps, spans) -> dict:
    """{span name: ns} of ``gaps`` summed by the innermost of ``spans``
    around each gap's midpoint (``OUTSIDE_SPANS`` where none is)."""
    out = {}
    for a, b in gaps:
        inside = _spans_at((a + b) // 2, spans)
        label = (min(inside, key=lambda s: s.end_ns - s.start_ns).name
                 if inside else OUTSIDE_SPANS)
        out[label] = out.get(label, 0) + (b - a)
    return out


def _union(events) -> list:
    merged = []
    for a, b in sorted((e.start_ns, e.end_ns) for e in events):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def segment(prof, counters: dict | None = None) -> Segment | None:
    """The traced segment of a profiler session that ran ``spin()`` first
    and last, with ``counters``, the program's counters' change over it;
    None where the card's trace holds no spin kernel (lost)."""
    cuda = torch.autograd.DeviceType.CUDA
    device, spans, program_spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == cuda:
            device.append(ev)
        elif ev.name.startswith(SPAN_PREFIX):
            spans.append(ev)
        elif ev.name.startswith(PROGRAM_PREFIX):
            program_spans.append(ev)
    device.sort(key=lambda e: e.start_ns)
    spins = [i for i, e in enumerate(device) if "spin_kernel" in e.name]
    if len(spins) < 2:
        return None
    first, last = device[spins[0]], device[spins[-1]]
    inside = [e for e in device[spins[0] + 1:spins[-1]]
              if "spin_kernel" not in e.name
              and not e.name.startswith((SPAN_PREFIX, PROGRAM_PREFIX))]
    return Segment(inside, spans, first.end_ns, last.start_ns, program_spans,
                   counters or {})
