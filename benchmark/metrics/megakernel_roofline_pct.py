"""The mesh megakernel's share of its roofline: the least time of a
frame's work (``harness/roofline.py``, counted from the scene and the
reference's paths) over the device time of the megakernel's launches per
frame in the traced segment. Nothing where the trace holds no such
kernel."""

KERNEL = "mesh_megakernel"


def read(reading):
    seg = reading["segment"]
    if seg is None:
        return None
    device_s = seg.device_s(KERNEL)
    if device_s <= 0.0:
        return None
    frames = reading["jobs"] * reading["accumulations"]
    return 100.0 * reading["least_time_per_frame_s"] / (device_s / frames)
