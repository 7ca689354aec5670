"""Deterministic benchmark inputs (port of tpu_bench/ops/initdata.py).

The reference initializes every operand with fixed analytic formulas so that
validation norms are reproducible machine to machine.  The BwdTrans inputs
are evaluated in f64 on the host by the port's utils/native.py (NumPy), then
cast and copied onto the run's device, so the port and the JAX package start
from the same bytes.
"""

from __future__ import annotations

import torch

from tpu_bench_torch.utils import native


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def host_basis_cos(nm: int, nq: int, dtype, device) -> torch.Tensor:
    """B[m, n] = cos(m*nq + n) as an (nm, nq) matrix on `device`."""
    b = native.init_cos(nm * nq).reshape(nm, nq)
    return torch.from_numpy(b).to(device=device, dtype=dtype)
