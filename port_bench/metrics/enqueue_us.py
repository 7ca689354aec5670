"""enqueue_us: the median host microseconds from a call's start to its
return, over every call of the untraced window: the column's wrapper,
kernels/build.py's call and run, ctypes and the C launcher."""

import statistics


def read(run):
    if not run.enqueue_ns:
        return None
    return statistics.median(run.enqueue_ns) * 1e-3
