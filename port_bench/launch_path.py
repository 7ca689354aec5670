"""The traced window's calls of the column, as the port's launch-path spans
show them (tpu_bench_torch/core/spans.py), for the readers call_us,
alloc_us, launch_us and device_allocs.

A call is a top-level span tbt.<wrapper> in the window: one that lies in
no other tbt.<wrapper> span.  It is the column's call only where it holds
the whole of it, so `calls` gives None unless every kernel the window
launched (each tbt.launch.<kernel> span and each cudaLaunch*/cuLaunch*
call of the runtime) and every tbt.alloc span lies inside one: a column
whose entry records no span and calls a spanned wrapper for one stage of
its work is not timed by that stage's span.
"""

from __future__ import annotations

import bisect
import dataclasses

# Spans of the steps inside a wrapper, not wrappers themselves.
INNER = ("tbt.alloc", "tbt.launch.")
# Host events that launch work on the device.
LAUNCHES = ("tbt.launch.", "cudaLaunch", "cuLaunch")


@dataclasses.dataclass
class Call:
    """One top-level wrapper span, and the (start_ns, end_ns) of the
    tbt.alloc and tbt.launch.* spans inside it."""
    start: int
    end: int
    allocs: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)

    @property
    def ns(self) -> int:
        return self.end - self.start


def calls(run) -> list | None:
    """The window's calls of the column whose spans lie wholly inside the
    window, by start; None without a trace, without a wrapper span, or
    where a launch or a tbt.alloc span lies outside every wrapper span."""
    if run.trace is None:
        return None
    tops = []
    for name, s, e in run.trace.host:  # by start
        if not name.startswith("tbt.") or name.startswith(INNER):
            continue
        if not tops or s >= tops[-1].end:  # else nested in the one before
            tops.append(Call(s, e))
    if not tops:
        return None
    starts = [c.start for c in tops]
    for name, s, e in run.trace.host:
        if not name.startswith(LAUNCHES) and name != "tbt.alloc":
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or e > tops[i].end:
            return None
        if name == "tbt.alloc":
            tops[i].allocs.append((s, e))
        elif name.startswith("tbt.launch."):
            tops[i].launches.append((s, e))
    lo, hi = run.trace.window
    return [c for c in tops if lo < c.start and c.end < hi]


def allocated(run) -> list | None:
    """calls(run), where every launch of every call wrote an output that
    the call allocated under a tbt.alloc span; else None."""
    found = calls(run)
    if not found or any(len(c.allocs) != len(c.launches) for c in found):
        return None
    return found
