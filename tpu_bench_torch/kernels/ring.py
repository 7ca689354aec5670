"""The cp.async.bulk ring of K12 (stream_map) and K7's 16-byte form
(map2_inplace), csrc/ring.cuh: its settings, the arithmetic by which it
cuts the operands into chunks on a one-wave grid (ring_plan, mirrored
from C) and its wave.

The ring is the analog of the TPU's _ring_kernel
(tpu_bench/kernels/stream.py:53-111).  The aligned middle of the operands
(16-byte vectors; the operands placed alike against 16 bytes) is cut
into chunks of `chunk` bytes of every operand, the last one partial; a
grid of one wave of blocks, each with `depth` slots of a chunk per
operand in shared memory, takes the chunks from a counter in device
memory, each block the next one whenever one of its slots frees up.  The
elements before the first 16-byte boundary (the head) and after the last
whole vector (the tail) go to plain accesses of block 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from tpu_bench_torch.kernels import build

# Each use's (chunk bytes of each operand, slots): of the sweep's
# settings that leave room for two blocks an SM, the fastest over f32 and
# f64 on an NVIDIA H100 80GB HBM3, 700.00 W (benchmarks/kernel_blocks.py
# --only ring; PERF.md section 6).
RING = {"copy": (16384, 6), "scale": (8192, 2), "triad": (4096, 2),
        "add": (4096, 2)}
# The sweep's settings, and the kernel's limits (csrc/ring.cuh): fewest
# and most slots, the bytes of the barriers in front of the slots, and
# the H100's opt-in shared memory of one block.
CHUNKS = (4096, 8192, 16384, 32768)
DEPTHS = (2, 3, 4, 6)
MIN_DEPTH, MAX_DEPTH = 2, 8
BARRIER_BYTES = 128
SMEM_BLOCK = 232448
# operands that stream through each use's ring, and K12's op codes
OPERANDS = {"copy": 1, "scale": 1, "triad": 2, "add": 2}
MAP_OPS = {"copy": 0, "scale": 1, "triad": 2}


def smem_bytes(use: str, chunk: int, depth: int) -> int:
    """Dynamic shared memory of one block of `use`'s ring."""
    return BARRIER_BYTES + OPERANDS[use] * depth * chunk


def settings(use: str, limit: int = SMEM_BLOCK) -> list:
    """The sweep's (chunk, depth) settings whose ring fits `limit`."""
    return [(c, d) for c in CHUNKS for d in DEPTHS
            if smem_bytes(use, c, d) <= limit]


class RingPlan(NamedTuple):
    """How the ring cuts n elements: `head` elements before the first
    16-byte boundary and `tail` after the last whole vector (block 0's
    plain accesses), the middle's `nbytes` in `chunks` chunks of `chunk`
    bytes (the last one partial), on a grid of `blocks`."""
    head: int
    tail: int
    nbytes: int
    chunk: int
    chunks: int
    blocks: int


def ring_plan(n: int, itemsize: int, address: int, chunk: int,
              wave: int) -> RingPlan:
    """The ring's plan for n elements of `itemsize` bytes whose first lies
    at `address`, in chunks of `chunk` bytes, on a card that holds `wave`
    of its blocks at once (csrc/ring.cuh: head_elems, chunk_count,
    ring_grid): one wave, no more blocks than chunks, at least one."""
    mis = address % 16
    head = min((16 - mis) // itemsize if mis else 0, n)
    nbytes = (n - head) * itemsize // 16 * 16
    chunks = -(-nbytes // chunk)
    return RingPlan(head=head, tail=n - head - nbytes // itemsize,
                    nbytes=nbytes, chunk=chunk, chunks=chunks,
                    blocks=max(1, min(wave, chunks)))


@functools.cache
def ring_wave(index: int, itemsize: int, use: str, chunk: int,
              depth: int) -> int:
    """Blocks of `use`'s ring at (chunk, depth) that CUDA device `index`
    holds at once (the occupancy API's blocks an SM times the SMs)."""
    import torch

    lib = build.library()
    with torch.cuda.device(index):
        if use == "add":
            blocks = lib.tbt_map2_inplace_wave(itemsize, chunk, depth)
        else:
            blocks = lib.tbt_stream_map_wave(itemsize, MAP_OPS[use], chunk,
                                             depth)
    if blocks < 1:
        raise RuntimeError(f"{use}: no occupancy for ring ({chunk}, "
                           f"{depth}) (code {blocks})")
    return blocks
