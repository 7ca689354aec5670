"""out_block_spread_pct: how far the device time of the window's main
kernel (the one that takes most of its device time) moves with the output
block its launch wrote, in %: the largest over the smallest median device
time of a block, less 1.

tpu_bench_torch/core/spans.blocks holds (kernel, address) of each output
allocated under a tbt.alloc span, in launch order, <kernel> the key
kernels/build.launches counts the launch under; the window's are its last
as many as the window has tbt.alloc spans.  The main kernel's launch key
is the one whose device kernels (KERNELS) take its name, and the n-th of
that key's blocks in the window is paired with the main kernel's n-th
device record.  A block counts where it has at least MIN_CALLS records
and is written both in the first quarter of the pairs and in the last: a
block that the window's sample takes out of the rotation, or hands back
to it, is written in part of the window only, and its median would hold
the card's drift over the window beside the block.  None where the
program records no blocks, where the main kernel is no launch key's of
the window, where the key's blocks and the kernel's records are not as
many, or where fewer than two blocks count."""

import collections
import statistics

from port_bench import spec

MIN_CALLS = 5

# Which device kernels a launch key runs (bf16 keys as their base name),
# for the keys whose outputs are allocated under tbt.alloc; K2's as its
# roofline reader takes them.
KERNELS = {
    "qp_fused3d": lambda name: "qp_fused3d_kernel" in name,
    "kron_blocked": spec.load("metrics", "kron_blocked_roofline")._k2,
}


def _runs(key, kernel) -> bool:
    runs = KERNELS.get(key.removesuffix("_bf16"))
    return runs is not None and runs(kernel)


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    try:
        from tpu_bench_torch.core import spans
    except ImportError:  # a program without spans
        return None
    lo, hi = run.trace.window
    allocs = sum(name == "tbt.alloc" and lo < s and e < hi
                 for name, s, e in run.trace.host)
    if not allocs or len(spans.blocks) < allocs:
        return None
    window = list(spans.blocks)[-allocs:]
    total = collections.Counter()
    for name, s, e in run.trace.device:
        total[name] += e - s
    main = max(total, key=total.get)
    keys = {key for key, _ in window if _runs(key, main)}
    if len(keys) != 1:
        return None
    key = keys.pop()
    blocks = [block for k, block in window if k == key]
    took = [e - s for name, s, e in run.trace.device if name == main]
    n = len(blocks)
    if len(took) != n:
        return None
    whole = set(blocks[:n // 4]) & set(blocks[n - n // 4:])
    by_block = collections.defaultdict(list)
    for block, ns in zip(blocks, took):
        by_block[block].append(ns)
    medians = [statistics.median(v) for b, v in by_block.items()
               if b in whole and len(v) >= MIN_CALLS]
    if len(medians) < 2:
        return None
    return 100.0 * (max(medians) / min(medians) - 1.0)
