"""Device-idle milliseconds per job in the traced segment whose gap
midpoint lies in one of the program's SmallPT spans (``b3d.smallpt.*``):
the card waiting for the host to enqueue SmallPT frames. Nothing where the
segment holds no such span."""

PREFIXES = ("b3d.smallpt.",)


def read(reading):
    seg = reading["segment"]
    if seg is None or not any(s.name.startswith(PREFIXES)
                              for s in seg.program_spans):
        return None
    return 1e3 * seg.idle_in(PREFIXES) / reading["jobs"]
