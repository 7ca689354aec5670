"""K6: the sum of squares of benchmark01 (port of
tpu_bench/kernels/reduction.py).

    sumsq(x, eps) = sum((x + eps)^2)   over every element of x

as a 0-d tensor, accumulated in f32 for f32 and in f64 for f64.  One CUDA
kernel (csrc/reduction.cu) serves the three TPU kernels in two forms:

    sumsq_two_pass    per-block partials, then one block sums them
                      (transform_reduce_two_pass)
    sumsq_wide,       16-byte loads, block sums added atomically into one
    sumsq_functor     accumulator (transform_reduce_one_pass; the functor
                      form is the kernel's template with square_eps)

The f64 columns, which the JAX package runs on (hi, lo) f32 pairs
(df2stream.sumsq_pair_*), are the same kernel built in double.  The
one-pass form's atomics land in another order on every run, so its f32
sum varies in the last bits.

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the kernel, which raises rather than fall back when it
cannot run.
"""

from __future__ import annotations

import torch

from tpu_bench_torch.kernels import build

# Most blocks of 256 threads a reduction launches: eight per SM of the
# H100's 132, enough resident warps to keep its reads in flight.
MAX_BLOCKS = 8 * 132


def square_eps(v, e):
    """(v + e)^2: the b01 functor; e is 0.0 in the benchmark."""
    w = v + e
    return w * w


def sumsq_plain(x, eps=0.0):
    """Plain PyTorch version: sum((x + eps)^2) in x's dtype, as a 0-d
    tensor."""
    return torch.sum(square_eps(x, eps), dtype=x.dtype)


def sumsq_two_pass(x, eps=0.0):
    """Two-pass form (b01 Pallas, transform_reduce_two_pass)."""
    return _sumsq("sumsq_two_pass", x, eps, one_pass=False)


def sumsq_wide(x, eps=0.0):
    """One-pass form with 16-byte loads (b01 Pallas(vl), the float4/double2
    analog)."""
    return _sumsq("sumsq_wide", x, eps, one_pass=True)


def sumsq_functor(x, eps=0.0):
    """Functor reduction (b01 Pallas(functor), reduceSumKernel analog): the
    one-pass kernel's template with the square_eps functor."""
    return _sumsq("sumsq_functor", x, eps, one_pass=True)


def _sumsq(name, x, eps, *, one_pass):
    build.check_operands(name, (x,))
    if x.is_cpu:
        return sumsq_plain(x, eps)
    # the sum, and after it the two-pass form's block partials, in one
    # allocation; the one-pass launcher zeroes the sum on the stream
    buf = torch.empty(1 if one_pass else 1 + MAX_BLOCKS, dtype=x.dtype,
                      device=x.device)
    ptr = buf.data_ptr()
    build.run("sumsq", x, x.data_ptr(), x.numel(), float(eps), ptr,
              None if one_pass else ptr + x.element_size(), MAX_BLOCKS,
              int(one_pass))
    return buf[0]
