"""K7: benchmark02's in-place streaming add (port of
tpu_bench/kernels/axpy.py).

    map2_inplace(x, y):  x <- f(x, y) elementwise, f = add; returns x

The kernel's functor is add, the benchmark's.  One CUDA kernel
(csrc/stream.cu) serves the TPU kernels of _tiled_map2
with scalar loads (add_inplace, map2_inplace) or, in its 16-byte form,
through the cp.async.bulk ring of kernels/ring.py (add_inplace_wide, and
stream.add_inplace_manual).  The JAX package
aliases its output to x by donation; here x is updated in place.  The f64
columns, which the JAX package runs on (hi, lo) f32 pairs
(df2stream.add_pair, add_pair_wide, map2_pair), are the same kernel built
in double.

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the kernel, which raises rather than fall back when it
cannot run.
"""

from __future__ import annotations

import torch

from tpu_bench_torch.kernels import build, ring


def map2_inplace_plain(x, y):
    """Plain PyTorch version: x += y; returns x."""
    return x.add_(y)


def add_inplace(x, y):
    """x += y with scalar loads (b02 Pallas, the scalar-load analog)."""
    return map2(x, y, vector=False, name="add_inplace")


def add_inplace_wide(x, y):
    """x += y with 16-byte loads (the float4/double2 vector-load analog)."""
    return map2(x, y, vector=True, name="add_inplace_wide")


def map2_inplace(x, y):
    """Functor kernel (b02 Pallas(functor), vector_kernel analog): the
    kernel's template with the add functor, scalar loads."""
    return map2(x, y, vector=False, name="map2_inplace")


def map2(x, y, *, vector, name):
    """x += y in place by the kernel's scalar or 16-byte form; the latter
    through the ring at ring.RING's (chunk, depth)."""
    build.check_operands(name, (x, y))
    if x.shape != y.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} differ in shape")
    if x.is_cpu:
        return map2_inplace_plain(x, y)
    build.run("map2_inplace", x, x.data_ptr(), y.data_ptr(), x.numel(),
              int(vector), *ring.RING["add"])
    return x
