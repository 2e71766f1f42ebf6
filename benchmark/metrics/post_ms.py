"""Mean host-clock time of the post chain (``post/pipeline.process``) per
job, over as many jobs as the traced segment holds, run after it: from a
synchronise after the render to one after the post."""


def read(reading):
    times = reading.get("post_ms")
    return sum(times) / len(times) if times else None
