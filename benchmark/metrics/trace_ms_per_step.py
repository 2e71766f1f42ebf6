"""Device milliseconds of the dense trace B1 (``csrc/dense_intersect.cu``:
its trace kernel and the chunk-box builder of ``csrc/dense_trace.cuh``)
per Adam step of the traced fit jobs. Nothing where the trace holds no B1
kernel."""

KERNELS = ("dense_intersect_kernel", "build_boxes_kernel")


def read(reading):
    seg = reading["segment"]
    if seg is None:
        return None
    device_s = sum(seg.device_s(k) for k in KERNELS)
    if device_s <= 0.0:
        return None
    return 1e3 * device_s / (reading["jobs"] * reading["steps"])
