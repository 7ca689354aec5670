"""device_idle_pct: the share of the traced window in which no operation
ran on the device (the union of the profiler's device records), in %."""

from port_bench import trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / run.trace.window_s)
