"""Deterministic benchmark inputs (port of tpu_bench/ops/initdata.py).

The reference initializes every operand with fixed analytic formulas so that
validation norms are reproducible machine to machine:

  b01/b02 x: i%13 + (0.2 + 1e-5*(i%100191))   benchmark01/benchmark01.cc:178
  b02 y:     i%8  + (0.4 + 3e-5*(i%100721))   benchmark02/benchmark02.cc:143
  b03 A:     sin(i*N + j + 1), x[j] = j       benchmark03/benchmark03.cc:161-167

The streams of b01/b02 are built on the run's device from an int32 ramp, in
the JAX package's order of operations, so no multi-GB host array is copied.
Each sum and product is one op in the run's dtype, as NumPy evaluates the
formula: in f64 that gives utils/native.py's bytes.  The JAX package's XLA
(f32) and its native library (f64, built with -march=native) fuse
`offset + scale*v` into one FMA, so their bytes differ from the port's by
at most one ulp, on 3-5% of the elements.  The matrix of b03 and the
BwdTrans inputs are evaluated in f64 on the host, then cast and copied onto
the device, so the port and the JAX package start from the same bytes.
Nothing is padded: the kernels take ragged sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bench_torch.utils import native


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _mod_ramp(n: int, period: int, scale: float, offset: float,
              fine_period: int, dtype, device) -> torch.Tensor:
    """i%period + (offset + scale*(i%fine_period)) for i < n, the product
    and the two sums each one rounded op in `dtype`, the int32 modulos
    converted first."""
    i = torch.arange(n, dtype=torch.int32, device=device)
    v = (i % fine_period).to(dtype)
    v.mul_(scale).add_(offset)
    return v.add_((i % period).to(dtype))


def device_x(n: int, dtype, device) -> torch.Tensor:
    """b01/b02 first operand, initialized on `device`."""
    return _mod_ramp(n, 13, 0.00001, 0.2, 100191, dtype, device)


def device_y(n: int, dtype, device) -> torch.Tensor:
    """b02 second operand, initialized on `device`."""
    return _mod_ramp(n, 8, 0.00003, 0.4, 100721, dtype, device)


def host_matrix_sin1(shape, dtype, device) -> torch.Tensor:
    """A[l] = sin(l+1) in row-major order, evaluated in f64 on the host,
    cast to dtype and put on `device`."""
    a = native.init_sin1(int(np.prod(shape))).reshape(shape)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def host_x_linear(n: int, dtype, device) -> torch.Tensor:
    """b03 vector x[j] = j (benchmark03/benchmark03.cc:167)."""
    return torch.arange(n, dtype=torch.float64).to(device=device, dtype=dtype)


def host_basis_cos(nm: int, nq: int, dtype, device) -> torch.Tensor:
    """B[m, n] = cos(m*nq + n) as an (nm, nq) matrix on `device`."""
    b = native.init_cos(nm * nq).reshape(nm, nq)
    return torch.from_numpy(b).to(device=device, dtype=dtype)
