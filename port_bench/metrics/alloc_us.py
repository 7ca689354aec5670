"""alloc_us: the median host microseconds of the spans tbt.alloc in the
column's calls of the traced window: the output's torch.empty in K1's and
K2's launch path (tpu_bench_torch/core/spans.py), torch's caching
allocator and, where it misses, cudaMalloc.  None unless every launch of
every call wrote an output allocated under such a span
(launch_path.allocated)."""

import statistics

from port_bench import launch_path


def read(run):
    found = launch_path.allocated(run)
    took = [e - s for c in found or () for s, e in c.allocs]
    return statistics.median(took) * 1e-3 if took else None
