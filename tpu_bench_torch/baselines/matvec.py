"""Library-tier matvec for benchmark03 (port of
tpu_bench/baselines/matvec.py).

Reference tiers: Kokkos hierarchical TeamPolicy reduction per row
(benchmark03/benchmark03.cc:130-149) and legacy cuBLAS gemv in row-major
('T') and column-major ('N') layouts (:181-186, :225-230):

  * rowsum:  broadcast-multiply, then a per-row sum
  * gemv_rm: torch.mv on row-major A (cuBLAS gemv)
  * gemv_cm: torch.mv on the column-major copy a_cm = A^T, viewed back as
             A: the layout comparison the reference's two cuBLAS calls make

benchmark03 runs them under Config.library_precision.
"""

from __future__ import annotations

import torch


def rowsum(a, x):
    return (a * x).sum(1)


def gemv_rm(a, x):
    return torch.mv(a, x)


def gemv_cm(a_cm, x):
    """a_cm is A transposed, stored (N, M)."""
    return torch.mv(a_cm.t(), x)
