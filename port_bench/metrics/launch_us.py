"""launch_us: the median host microseconds of the spans tbt.launch.<kernel>
in the column's calls of the traced window: kernels/build.run, the
entry's lookup, the raw stream, the ctypes call, the C launcher and the
launch count (tpu_bench_torch/core/spans.py).  None where the window's
wrapper spans do not hold the whole call (launch_path.calls)."""

import statistics

from port_bench import launch_path


def read(run):
    found = launch_path.calls(run)
    took = [e - s for c in found or () for s, e in c.launches]
    return statistics.median(took) * 1e-3 if took else None
