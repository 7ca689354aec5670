"""call_us: the median host microseconds of the column's calls as the
program times them from inside, on the profiler's clock: the top-level
spans tbt.<wrapper> that the port's public wrappers record while a
profiler records (tpu_bench_torch/core/spans.py), inside the traced
window.  None where such a span does not hold the whole call
(launch_path.calls).  Beside enqueue_us, which times the same calls from
outside, unprofiled."""

import statistics

from port_bench import launch_path


def read(run):
    found = launch_path.calls(run)
    if not found:
        return None
    return statistics.median(c.ns for c in found) * 1e-3
