"""Host-side rebuilds per job over the traced segment, from the program's
counters: every cache store (``<module>.<cache>.stores``, a miss that
rebuilt a table), nvcc build and kernel library load
(``utils.cuda_build.builds``, ``.loads``). After the warm-up job a job
should rebuild nothing. Nothing where the program kept no counter."""

BUILD = ("utils.cuda_build.builds", "utils.cuda_build.loads")


def read(reading):
    seg = reading["segment"]
    if seg is None or not seg.counters:
        return None
    rebuilds = sum(v for k, v in seg.counters.items()
                   if k.endswith(".stores") or k in BUILD)
    return rebuilds / reading["jobs"]
