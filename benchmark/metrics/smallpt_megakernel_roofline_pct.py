"""The SmallPT megakernel's share of its roofline: the least time of a
frame's work (``harness/roofline_smallpt.py``, counted from the spheres
and the reference's bounces) over the device time of the kernel's
launches per frame in the traced segment. Nothing where the trace holds no
such kernel."""

KERNEL = "smallpt_kernel"


def read(reading):
    seg = reading["segment"]
    if seg is None:
        return None
    device_s = seg.device_s(KERNEL)
    if device_s <= 0.0:
        return None
    frames = reading["jobs"] * reading["accumulations"]
    return 100.0 * reading["least_time_per_frame_s"] / (device_s / frames)
