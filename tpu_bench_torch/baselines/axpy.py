"""Library-tier streaming add for benchmark02 (port of
tpu_bench/baselines/axpy.py).

Library tiers in the reference: Kokkos parallel_for and thrust::transform
(benchmark02/benchmark02.cc:73-128).  The in-place flavor updates x
(2 reads + 1 write, the JAX package's donated add); the functional flavor
writes a fresh tensor.
"""

from __future__ import annotations


def add_donated(x, y):
    """In-place x += y (Kokkos parallel_for analog); returns x."""
    return x.add_(y)


def add(x, y):
    """Functional out-of-place add (thrust::transform analog)."""
    return x + y
