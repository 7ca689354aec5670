"""call_ms_p95: the 95th percentile, over every call of the window, of the
device time between the events around it (the call's device time plus any
gap the device waited before it)."""

import statistics


def read(run):
    if len(run.call_ms) < 2:
        return None
    return statistics.quantiles(run.call_ms, n=100, method="inclusive")[94]
