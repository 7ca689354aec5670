"""K8 and K9: benchmark03's matrix-vector products (port of
tpu_bench/kernels/matvec.py).

    matvec_rm(a, x)     y = A x, A (M, N) row-major         (K8; replaces
                        matvec_vpu, b03 Pallas(vpu))
    matvec_cm(a_cm, x)  y = A x from a_cm (N, M) = A^T      (K9; replaces
                        matvec_mxu, b03 Pallas(mxu))

(csrc/matvec.cu).  K8 gives each row one warp; K9 gives a block 512
bytes of columns of a_cm and one of `splits` equal shares of its rows, in
one wave (cm_splits); the shares' sums go into a workspace and a second
pass adds them in order, so y is the same bits on every run.  The f64
columns, which the JAX package runs on (hi, lo) f32 pairs
(df2stream.matvec_pair_rm, matvec_pair_cm), are the same kernels built in
double.  Neither uses the tensor cores: A is read once, and the bytes
bound both.

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the kernel, which raises rather than fall back when it
cannot run.
"""

from __future__ import annotations

import functools

import torch

from tpu_bench_torch.kernels import build

# K9's rows in flight a thread (its UNROLL) and the warps that share a
# block's columns (csrc/matvec.cu).  (Chosen on an NVIDIA H100 80GB HBM3,
# 700.00 W, by benchmarks/kernel_blocks.py; PERF.md section 6.)
CM_UNROLLS = (4, 8, 16)
CM_UNROLL = 8
CM_WARPS = 8


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


def matvec_cm(a_cm, x, *, unroll=None, splits=None):
    """y (M,) = A_cm (N, M)^T @ x (N,).  `unroll`: rows in flight, one of
    CM_UNROLLS (default CM_UNROLL); `splits`: row shares (default
    cm_splits' one wave)."""
    n, m = _check("matvec_cm", a_cm, x, contracted=0)
    unroll = unroll or CM_UNROLL
    if unroll not in CM_UNROLLS:
        raise ValueError(f"matvec_cm: unroll={unroll} is not one of "
                         f"{CM_UNROLLS}")
    if splits is not None and splits < 1:
        raise ValueError(f"matvec_cm: splits={splits} is below 1")
    if a_cm.device.type == "cpu":
        return matvec_cm_plain(a_cm, x)
    size = a_cm.element_size()
    if splits is None:
        splits = cm_splits(n, m, size, cm_blocks(a_cm.device, size, unroll),
                           unroll)
    y = torch.empty(m, dtype=a_cm.dtype, device=a_cm.device)
    ws = (torch.empty(splits * m, dtype=a_cm.dtype, device=a_cm.device)
          if splits > 1 else y)
    build.run("matvec_cm", a_cm, a_cm.data_ptr(), x.data_ptr(), y.data_ptr(),
              ws.data_ptr(), n, m, splits, unroll)
    return y


def cm_columns(itemsize) -> int:
    """Columns of a K9 block: one 16-byte vector a lane."""
    return 32 * 16 // itemsize


def cm_splits(n, m, itemsize, blocks, unroll=CM_UNROLL) -> int:
    """K9's row shares for A_cm (n, m): as many as the `blocks` the card
    holds at once leave room for beside the column blocks (one wave), but
    no more than give each warp `unroll` rows; at least one."""
    col_blocks = -(-m // cm_columns(itemsize))
    return max(1, min(blocks // col_blocks, n // (CM_WARPS * unroll)))


def cm_rows(n, splits) -> list:
    """[start, end) of each share's rows, as csrc/matvec.cu deals them:
    share s is [s * n // splits, (s + 1) * n // splits)."""
    return [(s * n // splits, (s + 1) * n // splits) for s in range(splits)]


@functools.cache
def cm_blocks(device, itemsize, unroll) -> int:
    """Blocks of K9's vector form the card holds at once (the occupancy
    API's blocks an SM times the SMs)."""
    with torch.cuda.device(device):
        blocks = build.library().tbt_matvec_cm_blocks(itemsize, unroll)
    if blocks < 1:
        raise RuntimeError(f"matvec_cm: no occupancy for unroll={unroll}")
    return blocks


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
