"""Spans and a counter in the launch path, on the profiler's own clock.

While a torch profiler records (`profiler._is_profiler_enabled`), the
launch path puts spans on its event list, where they share a clock with
the device's records (CUPTI's under ProfilerActivity.CUDA) and nest by the
thread's call order:

    tbt.qp_shared3d_flat, tbt.kron_blocked   the public wrapper a column
                                             calls (checks, configuration,
                                             the rest below)
    tbt.alloc                                the output's torch.empty in
                                             K1's and K2's _launch
    tbt.launch.<kernel>                      kernels/build.run for kernel
                                             <kernel> as build.launches
                                             counts it

and `blocks` takes (kernel, address) of each output a tbt.alloc span
allocated, in launch order, <kernel> the key of the launch that writes
it.  Nothing is recorded, and nothing else is kept, while no profiler
records: each hot site tests the profiler's flag once and runs as it
would without spans.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd import profiler  # noqa: F401 (the flag the sites test)

# (kernel, data_ptr) of the outputs allocated under tbt.alloc spans,
# oldest first: which output block each launch wrote.  Bounded, so a 2 s
# profiled window of the shortest calls (a few µs each) still fits.
blocks: collections.deque = collections.deque(maxlen=2**18)

# span(name): a context that records the span `name` on the profiler's
# event list.  The sites enter it only while a profiler records.
span = torch._C._profiler._RecordFunctionFast


def alloc(shape, like: torch.Tensor, kernel: str) -> torch.Tensor:
    """torch.empty(shape) in like's dtype and on its device, under a
    tbt.alloc span, (kernel, its address) appended to `blocks`: the output
    allocation of a launch of `kernel` while a profiler records."""
    with span("tbt.alloc"):
        out = torch.empty(shape, dtype=like.dtype, device=like.device)
    blocks.append((kernel, out.data_ptr()))
    return out
