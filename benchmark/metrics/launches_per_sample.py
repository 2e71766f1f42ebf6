"""CUDA kernels and memsets on the device per accumulation (a frame of
pixel-samples) in the traced segment, post and readback included."""


def read(reading):
    seg = reading["segment"]
    if seg is None:
        return None
    return seg.launches() / (reading["jobs"] * reading["accumulations"])
