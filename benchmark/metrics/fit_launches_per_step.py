"""CUDA kernels and memsets on the device per Adam step of the traced fit
jobs: the eager estimator's launches, forward, recompute and backward."""


def read(reading):
    seg = reading["segment"]
    if seg is None:
        return None
    return seg.launches() / (reading["jobs"] * reading["steps"])
