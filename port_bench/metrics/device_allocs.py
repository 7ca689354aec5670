"""device_allocs: the host's cudaMalloc* and cudaFree* calls inside the
spans tbt.alloc of the column's calls in the traced window, per 1000 of
those calls: the output allocations that missed torch's caching allocator
(a cudaFree also waits for the card to drain).  None unless every launch
of every call wrote an output allocated under such a span
(launch_path.allocated), or where no call allocated one."""

import bisect

from port_bench import launch_path

DEVICE_CALLS = ("cudaMalloc", "cudaFree")


def read(run):
    found = launch_path.allocated(run)
    allocs = sorted(a for c in found or () for a in c.allocs)
    if not allocs:
        return None
    starts = [s for s, _ in allocs]
    inside = 0
    for name, s, e in run.trace.host:
        if name.startswith(DEVICE_CALLS):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= allocs[i][1]:
                inside += 1
    return 1000.0 * inside / len(found)
