"""Device-idle milliseconds per job in the traced segment whose gap
midpoint lies in one of the program's render or megakernel spans
(``b3d.render.*``, ``b3d.megakernel.*``): the card waiting for the host to
enqueue frames. Nothing where the segment holds no program span."""

PREFIXES = ("b3d.render.", "b3d.megakernel.")


def read(reading):
    seg = reading["segment"]
    if seg is None or not seg.program_spans:
        return None
    return 1e3 * seg.idle_in(PREFIXES) / reading["jobs"]
