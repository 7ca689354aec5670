"""benchmark02's hand-pipelined add (port of tpu_bench/kernels/stream.py's
add_inplace_manual; the ceiling probes of that module are not ported yet).

On the TPU, add_inplace_manual streams x += y through a depth-3 ring of
16 MB VMEM slots with manual DMA, so the copies overlap the adds.  On the
card the same bytes go through K7's 16-byte form (kernels/axpy.py,
csrc/stream.cu), whose resident warps keep the loads in flight; a
cp.async.bulk / TMA ring through shared memory, the ring's real analog, is
later work.
"""

from __future__ import annotations

from tpu_bench_torch.kernels import axpy


def add_inplace_manual(x, y):
    """x += y in place (b02 Pallas(vl)); returns x."""
    return axpy.map2(x, y, vector=True, name="add_inplace_manual")
