"""K8 and K9: benchmark03's matrix-vector products (port of
tpu_bench/kernels/matvec.py).

    matvec_rm(a, x)     y = A x, A (M, N) row-major         (K8; replaces
                        matvec_vpu, b03 Pallas(vpu))
    matvec_cm(a_cm, x)  y = A x from a_cm (N, M) = A^T      (K9; replaces
                        matvec_mxu, b03 Pallas(mxu))

(csrc/matvec.cu).  K8 gives each row one warp; K9 runs its threads along
the rows of a_cm and splits them across blocks, which add their partial
sums atomically into y, so its f32 y varies in the last bits.  The f64
columns, which the JAX package runs on (hi, lo) f32 pairs
(df2stream.matvec_pair_rm, matvec_pair_cm), are the same kernels built in
double.  Neither uses the tensor cores: A is read once, and the bytes
bound both.

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the kernel, which raises rather than fall back when it
cannot run.
"""

from __future__ import annotations

import torch

from tpu_bench_torch.kernels import build


def matvec_rm_plain(a, x):
    """Plain PyTorch version of matvec_rm."""
    return a @ x


def matvec_cm_plain(a_cm, x):
    """Plain PyTorch version of matvec_cm."""
    return a_cm.t() @ x


def matvec_rm(a, x):
    """y (M,) = A (M, N) @ x (N,)."""
    m, n = _check("matvec_rm", a, x, contracted=1)
    if a.device.type == "cpu":
        return matvec_rm_plain(a, x)
    y = torch.empty(m, dtype=a.dtype, device=a.device)
    build.run("matvec_rm", a, a.data_ptr(), x.data_ptr(), y.data_ptr(), m, n)
    return y


def matvec_cm(a_cm, x):
    """y (M,) = A_cm (N, M)^T @ x (N,)."""
    n, m = _check("matvec_cm", a_cm, x, contracted=0)
    if a_cm.device.type == "cpu":
        return matvec_cm_plain(a_cm, x)
    y = torch.zeros(m, dtype=a_cm.dtype, device=a_cm.device)
    build.run("matvec_cm", a_cm, a_cm.data_ptr(), x.data_ptr(), y.data_ptr(),
              n, m)
    return y


def _check(name, a, x, *, contracted):
    """The matrix's (rows, columns) once a and x are fit for the kernel;
    x runs along axis `contracted` of a."""
    build.check_operands(name, (a, x))
    if a.dim() != 2 or x.dim() != 1 or x.shape[0] != a.shape[contracted]:
        raise ValueError(f"{name}: A {tuple(a.shape)} and x "
                         f"{tuple(x.shape)} do not multiply")
    if max(a.shape) >= 2**31:
        raise ValueError(f"{name}: A {tuple(a.shape)} exceeds the kernel's "
                         "32-bit extents")
    return a.shape
