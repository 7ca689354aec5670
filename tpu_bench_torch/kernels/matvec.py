"""K8 and K9: benchmark03's matrix-vector products (port of
tpu_bench/kernels/matvec.py).

    matvec_rm(a, x)     y = A x, A (M, N) row-major         (K8; replaces
                        matvec_vpu, b03 Pallas(vpu))
    matvec_cm(a_cm, x)  y = A x from a_cm (N, M) = A^T      (K9; replaces
                        matvec_mxu, b03 Pallas(mxu))

(csrc/matvec.cu).  K8 gives a team of up to a block's lanes (fewer for
short rows: rm_lanes) `rows` rows at a time, which share each load of x,
on a one-wave grid (rm_grid, rm_groups); K9 gives a block 512 bytes of
columns of a_cm and one of `splits` equal shares of its rows, in one wave
(cm_splits); the shares' sums go into a workspace and a second pass adds
them in order.  Both sum in a fixed order, so y is the same bits on every
run.  The f64 columns, which the JAX package runs on (hi, lo) f32 pairs
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

# K8's rows a team of lanes owns at a time and 16-byte vectors a lane takes
# a step, with their defaults, and threads a block (csrc/matvec.cu).
# (Chosen on an NVIDIA H100 80GB HBM3, 700.00 W, by
# benchmarks/kernel_blocks.py --only k8; PERF.md section 6.)
RM_ROWS = (2, 4)
RM_ROW = 2
RM_UNROLLS = (1, 2)
RM_UNROLL = 2
RM_THREADS = 256
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


def matvec_rm(a, x, *, rows=None, unroll=None):
    """y (M,) = A (M, N) @ x (N,).  `rows`: rows a team of lanes owns at a
    time, one of RM_ROWS (default RM_ROW); `unroll`: 16-byte vectors a
    lane takes a step, one of RM_UNROLLS (default RM_UNROLL)."""
    m, n = _check("matvec_rm", a, x, contracted=1)
    rows = rows or RM_ROW
    unroll = unroll or RM_UNROLL
    if rows not in RM_ROWS:
        raise ValueError(f"matvec_rm: rows={rows} is not one of {RM_ROWS}")
    if unroll not in RM_UNROLLS:
        raise ValueError(f"matvec_rm: unroll={unroll} is not one of "
                         f"{RM_UNROLLS}")
    if a.is_cpu:
        return matvec_rm_plain(a, x)
    y = torch.empty(m, dtype=a.dtype, device=a.device)
    size = a.element_size()
    vector = build.vector16(n, size, a.data_ptr(), x.data_ptr())
    lanes = rm_lanes(n * size // 16 if vector else n, unroll)
    blocks = rm_grid(m, rows, lanes,
                     rm_wave(a.get_device(), size, vector, rows, unroll))
    build.run("matvec_rm", a, a.data_ptr(), x.data_ptr(), y.data_ptr(), m, n,
              rows, unroll, lanes, int(vector), blocks)
    return y


@functools.cache
def rm_lanes(units, unroll) -> int:
    """Lanes of a K8 team for rows of `units` vectors (or values, in the
    scalar form): the largest power of two from 8 to RM_THREADS that
    leaves each lane at least `unroll` units of a row."""
    lanes = 8
    while lanes < RM_THREADS and 2 * lanes * unroll <= units:
        lanes *= 2
    return lanes


@functools.cache
def rm_grid(m, rows, lanes, wave) -> int:
    """K8's blocks: the fewest rounds of row groups of `rows` rows that a
    wave (`wave`, the blocks the card holds at once) of teams of `lanes`
    lanes needs, and as few blocks as give each team that many rounds, so
    every team takes the same number of row groups to within one; at
    least one."""
    blocks = -(-(-(-m // rows)) // (RM_THREADS // lanes))
    rounds = -(-blocks // wave)
    return max(1, -(-blocks // rounds))


def rm_groups(m, rows, lanes, blocks) -> list:
    """The rows of each team of the grid, as csrc/matvec.cu deals them:
    team slot s of S = blocks * RM_THREADS // lanes takes row groups s,
    s + S, ..., row group g being rows [g * rows, min((g + 1) * rows,
    m))."""
    slots = blocks * (RM_THREADS // lanes)
    groups = -(-m // rows)
    return [[r for g in range(s, groups, slots)
             for r in range(g * rows, min((g + 1) * rows, m))]
            for s in range(slots)]


@functools.cache
def rm_wave(device, itemsize, vector, rows, unroll) -> int:
    """Blocks of K8's instance the card holds at once (the occupancy API's
    blocks an SM times the SMs)."""
    with torch.cuda.device(device):
        blocks = build.library().tbt_matvec_rm_wave(itemsize, int(vector),
                                                    rows, unroll)
    if blocks < 1:
        raise RuntimeError(f"matvec_rm: no occupancy for rows={rows}, "
                           f"unroll={unroll}")
    return blocks


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
    if a_cm.is_cpu:
        return matvec_cm_plain(a_cm, x)
    size = a_cm.element_size()
    if splits is None:
        blocks = cm_blocks(a_cm.get_device(), size, unroll)
        splits = cm_splits(n, m, size, blocks, unroll)
    y = torch.empty(m, dtype=a_cm.dtype, device=a_cm.device)
    ws = (torch.empty(splits * m, dtype=a_cm.dtype, device=a_cm.device)
          if splits > 1 else y)
    build.run("matvec_cm", a_cm, a_cm.data_ptr(), x.data_ptr(), y.data_ptr(),
              ws.data_ptr(), n, m, splits, unroll)
    return y


def cm_columns(itemsize) -> int:
    """Columns of a K9 block: one 16-byte vector a lane."""
    return 32 * 16 // itemsize


@functools.cache
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
