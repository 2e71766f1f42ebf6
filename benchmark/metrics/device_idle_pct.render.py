"""The share of the traced segment of render jobs in which nothing ran on
the device: 1 - the union of its activities' intervals over the segment,
on the card's own clock."""


def read(reading):
    seg = reading["segment"]
    if seg is None or seg.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - seg.busy_s() / seg.window_s)
