"""Mean host duration, in microseconds, of the program's
``b3d.smallpt.frame`` spans in the traced segment: what the host takes to
enqueue one SmallPT accumulation (the checks, the launch and its memset).
Nothing where the segment holds no such span."""

SPAN = "b3d.smallpt.frame"


def read(reading):
    seg = reading["segment"]
    if seg is None:
        return None
    frames = [s for s in seg.program_spans if s.name == SPAN]
    if not frames:
        return None
    return sum(s.end_ns - s.start_ns for s in frames) / len(frames) / 1e3
