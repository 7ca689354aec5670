"""The 3D QP kernels of benchmark05 (port of tpu_bench/kernels/bwdtrans3d.py).
benchmark04 calls qp_shared3d, qp_global3d and qp1d_fused for its 2D QP
columns: the 2D contraction is K1's with nrq = nm1 and C12T = B1^T, and
its QP-1D chain has two stages.

K1 (qp_fused3d), the Pallas(QP/Shared) column, ports qp_shared3d and
qp_shared3d_flat.  Both compute, for every element e and output plane i,

    out[i] = C12T @ (sum_p B0[p, i] * in[p])

with the p-major coalesced input (nm0, nrq, E), nrq = nm2*nm1, and the
i-major output (nq0, nkj, E), nkj = nq2*nq1.  The flat wrapper takes the
same bytes viewed as (nm0*nrq, E) and returns (nq0*nkj, E), so one CUDA
kernel (csrc/bwdtrans3d.cu) serves both.

qp_global3d, the Pallas(QP) column, is the same contraction in two kernels
with the workspace w (nm0, nkj, E) in device memory: K2 (kernels/
bwdtrans2d.py) for w[p] = C12T @ in[p], then K4 (qp_stage2_3d,
csrc/bwdtrans3d.cu) for out[i] = sum_p B0[p, i] * w[p].

qp1d_shared3d (K5, qp1d_fused3d, csrc/qp1d_fused3d.cu; qp1d_fused
takes two or three stages), the Pallas(QP-1D/Shared) column, and
qp1d_global3d (three K3 launches), the Pallas(QP-1D) column, compute the
element-major chain
out (E, nqTot) = ((in (E, nmTot) @ S1) @ S2) @ S3.

Each kernel is built for f32, f64 and bf16.  In bf16 the values are
stored in bf16 and summed in f32, and rounded to bf16 where the JAX
kernels round: K1's v before the C12T stage and each output; K4's output
(its workspace w arrives rounded from K2); K5's workspaces w1 and w2 and
its output.  The plain versions compute the same cast points in f32.

A tensor on the CPU goes to the plain PyTorch version in this module; a
tensor on a CUDA device goes to the kernel, which raises rather than fall
back when it cannot run.
"""

from __future__ import annotations

import functools

import torch

from tpu_bench_torch.core import spans
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import build

# K1 (csrc/bwdtrans3d.cu): its element tiles (the elements a block owns
# and stages in shared memory) by element size, largest first; its plane
# groups (output planes of one pass); its block, stage-2 micro-tile (kj
# rows x elements) and the H100's shared memory: the most one block may
# opt in to, an SM's total, and what the card reserves of it for each
# block.  qp_config picks a tile and a group for each shape; the rule rests
# on benchmarks/kernel_blocks.py (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 6).
QP_TILES = {2: (128, 64, 32, 16), 4: (128, 64, 32, 16), 8: (64, 32, 16, 8)}
QP_PLANE_GROUPS = (4, 8)
QP_THREADS = 256
QP_TK, QP_TE = 8, 4
SMEM_BLOCK = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
# The element tile: None takes qp_config's choice.
EPB = None
# K1's (element tile, plane group) at the shapes benchmarks/kernel_blocks.py
# sweeps, by (itemsize, nm0, nrq, nq0, nkj): its fastest setting in one
# run (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).  The rule of
# qp_config gave the same at 4^3, 8^3 and 10^3 in f32 and 10^3, 8^2 and
# 32^2 in f64, and elsewhere a setting 1.5-32% slower (f64 b04 16^2:
# 2.0687 ms against 1.5636).
QP_MEASURED = {
    (4, 3, 9, 4, 16): (128, 4), (4, 5, 25, 6, 36): (32, 8),
    (4, 7, 49, 8, 64): (32, 4), (4, 9, 81, 10, 100): (16, 4),
    (4, 7, 7, 8, 8): (128, 4), (4, 15, 15, 16, 16): (64, 4),
    (4, 31, 31, 32, 32): (16, 8),
    (8, 3, 9, 4, 16): (64, 4), (8, 5, 25, 6, 36): (32, 8),
    (8, 7, 49, 8, 64): (16, 8), (8, 9, 81, 10, 100): (16, 4),
    (8, 7, 7, 8, 8): (64, 8), (8, 15, 15, 16, 16): (32, 8),
    (8, 31, 31, 32, 32): (16, 8),
}
# K4 (csrc/bwdtrans3d.cu): threads a block; the 16-byte vectors a thread
# takes a step (its U), and the default, from benchmarks/kernel_blocks.py
# --only k4 (PERF.md section 6); the largest nm0 kept whole in registers
# (every 3D order to 10^3), and the chunks of p and i above it, where U is
# at most QP2_CHUNKED_UNROLL.  A bf16 vector holds 8 values, which take 8
# f32 registers, so bf16 takes half of each U (qp2_unrolls).
QP2_THREADS = 256
QP2_UNROLLS = (1, 2, 4)
QP2_UNROLL = 4
QP2_EXACT = 9
QP2_CHUNK = 8
QP2_CHUNKED_UNROLL = 2
# B0 in shared memory: the most K4 takes without opting in to more
QP2_MAX_B0_BYTES = 48 * 1024
# K5: element tiles it is built for, by element size, in order of
# preference; it takes the first whose workspaces fit the card's opt-in
# shared memory.  Multiples of the mma tile's M side (16 rows for TF32 and
# bf16, 8 for f64); the smallest exist for b04 nq=32 (workspaces 961 and
# 992 wide), where only 16 fits in f32 and 8 in f64.
QP1D_TILES = {2: (64, 32, 16), 4: (64, 32, 16), 8: (32, 16, 8)}
# K5's S tiles (QP1D_STEP: BK deep, BN wide, and the workspace rows'
# padding past a multiple of BK, by element size), its ring of S tiles and
# their row padding (csrc/qp1d_fused3d.cu Tile, RING, SPAD)
QP1D_STEP = {2: (32, 128, 8), 4: (32, 128, 4), 8: (8, 64, 4)}
QP1D_RING, QP1D_SPAD = 3, 8


def qp_shared3d_plain(in_pcoa3, b0, c12t):
    """Plain PyTorch version of qp_shared3d: v in the sum's type (f32 for
    bf16), rounded to the input's dtype, then C12T @ v."""
    b0w, xw = k2.widened(b0, in_pcoa3)
    v = torch.einsum("pi,pre->ire", b0w, xw)       # (nq0, nrq, E)
    return k2.mm(c12t, v.to(in_pcoa3.dtype))       # (nq0, nkj, E)


def qp_shared3d_flat_plain(in_pflat, b0, c12t, *, nrq):
    """Plain PyTorch version of qp_shared3d_flat."""
    nm_tot, e = in_pflat.shape
    out = qp_shared3d_plain(in_pflat.reshape(nm_tot // nrq, nrq, e), b0, c12t)
    return out.reshape(-1, e)


def qp_shared3d(in_pcoa3, b0, c12t, *, epb=EPB, planes=None):
    """out (nq0, nkj, E) from in (nm0, nrq, E), b0 (nm0, nq0),
    c12t (nkj, nrq).  `epb`: K1's element tile, one of QP_TILES for the
    dtype, and `planes`, one of QP_PLANE_GROUPS; None takes qp_config's
    choice."""
    if in_pcoa3.dim() != 3:
        raise ValueError(f"in_pcoa3 must be (nm0, nrq, E), got "
                         f"{tuple(in_pcoa3.shape)}")
    nm0, nrq, e = in_pcoa3.shape
    out = qp_shared3d_flat(in_pcoa3.reshape(nm0 * nrq, e), b0, c12t, nrq=nrq,
                           epb=epb, planes=planes)
    return out.reshape(-1, c12t.shape[0], e)


def qp_shared3d_flat(in_pflat, b0, c12t, *, nrq, epb=EPB, planes=None):
    """out (nq0*nkj, E) from in (nm0*nrq, E), rows p*nrq + rq; under the
    span tbt.qp_shared3d_flat while a profiler records (core/spans.py)."""
    if spans.profiler._is_profiler_enabled:
        with spans.span("tbt.qp_shared3d_flat"):
            return _qp_shared3d_flat(in_pflat, b0, c12t, nrq, epb, planes)
    return _qp_shared3d_flat(in_pflat, b0, c12t, nrq, epb, planes)


def _qp_shared3d_flat(in_pflat, b0, c12t, nrq, epb, planes):
    _check(in_pflat, b0, c12t, nrq)
    if in_pflat.is_cpu:
        return qp_shared3d_flat_plain(in_pflat, b0, c12t, nrq=nrq)
    if not in_pflat.is_cuda:
        raise ValueError(f"qp_shared3d: no kernel for device {in_pflat.device}")
    return _launch(in_pflat, b0, c12t, nrq, epb, planes)


def _check(x, b0, c12t, nrq):
    """in, b0 and c12t: one dtype and device, contiguous (check_operands),
    2D, and of shapes that agree with nrq."""
    build.check_operands("qp_shared3d", (x, b0, c12t), bf16=True)
    if x.dim() != 2 or b0.dim() != 2 or c12t.dim() != 2:
        raise ValueError("qp_shared3d: in, b0 and c12t must be 2D")
    if x.shape[0] != b0.shape[0] * nrq or c12t.shape[1] != nrq:
        raise ValueError(f"qp_shared3d: shapes in {tuple(x.shape)}, b0 "
                         f"{tuple(b0.shape)}, c12t {tuple(c12t.shape)} do not "
                         f"agree with nrq={nrq}")


def _round_up(n, m):
    return -(-n // m) * m


def qp_smem(itemsize, et, g, nm0, nrq, nq0, nkj) -> int:
    """Shared memory of one K1 block (csrc/bwdtrans3d.cu qp_smem_bytes):
    the element tile's input slab, V for g planes, C12T^T with nkj padded
    to QP_TK, and B0 with nq0 padded to g."""
    return itemsize * (nm0 * nrq * et + g * nrq * et
                       + nrq * _round_up(nkj, QP_TK)
                       + nm0 * _round_up(nq0, g))


def qp_planes(et, nkj) -> int:
    """K1's plane group for tile et: 8 where the stage-2 micro-tiles of 4
    planes would keep at most half the block busy, else 4."""
    tiles = 4 * _round_up(nkj, QP_TK) // QP_TK * (et // QP_TE)
    return 8 if tiles <= QP_THREADS // 2 else 4


@functools.cache
def qp_config(itemsize, nm0, nrq, nq0, nkj, block_limit=SMEM_BLOCK,
              sm_limit=SMEM_SM):
    """K1's (element tile, plane group) for a shape: QP_MEASURED's where
    the sweep measured the shape; else the largest tile of
    QP_TILES[itemsize], with qp_planes' group, whose buffers fit two blocks
    an SM of `sm_limit` bytes (each block also costs SMEM_RESERVED) while
    stage 1 keeps at least half the block busy (nrq * et / QP_TE
    positions), else the largest that fits one block's `block_limit`; None
    if none fits."""
    measured = QP_MEASURED.get((itemsize, nm0, nrq, nq0, nkj))
    if measured and qp_smem(itemsize, *measured, nm0, nrq, nq0,
                            nkj) <= block_limit:
        return measured
    sizes = {}
    for et in QP_TILES[itemsize]:
        g = qp_planes(et, nkj)
        sizes[(et, g)] = qp_smem(itemsize, et, g, nm0, nrq, nq0, nkj)
    fits = [c for c, b in sizes.items() if b <= block_limit]
    two = [(et, g) for et, g in fits
           if 2 * (sizes[(et, g)] + SMEM_RESERVED) <= sm_limit
           and nrq * et // QP_TE >= QP_THREADS // 2]
    return (two or fits or [None])[0]


@functools.cache
def qp_launch_config(itemsize, nm0, nrq, nq0, nkj, epb, planes,
                     block=SMEM_BLOCK, sm=SMEM_SM) -> tuple:
    """K1's (element tile, plane group) for a launch: `epb` and `planes`
    where given (qp_planes' group for a given tile), else qp_config's,
    under the card's `block` and `sm` bytes of shared memory; raises if
    the knobs are not the kernel's or the tile does not fit."""
    tiles = QP_TILES[itemsize]
    if epb is not None and epb not in tiles:
        raise ValueError(f"qp_shared3d: epb={epb} is not one of the "
                         f"kernel's element tiles {tiles} for itemsize "
                         f"{itemsize}")
    if planes is not None and planes not in QP_PLANE_GROUPS:
        raise ValueError(f"qp_shared3d: planes={planes} is not one of "
                         f"{QP_PLANE_GROUPS}")
    et, g = qp_config(itemsize, nm0, nrq, nq0, nkj, block, sm) or (None, None)
    et = epb or et
    g = planes or (qp_planes(et, nkj) if epb else g)
    if et is None or qp_smem(itemsize, et, g, nm0, nrq, nq0, nkj) > block:
        raise ValueError(f"qp_shared3d: element tile {epb or 'of any size'}"
                         f" of nm0*nrq = {nm0 * nrq} input rows does not fit "
                         f"the card's {block} B of shared memory")
    return et, g


def _launch(x, b0, c12t, nrq, epb, planes):
    nm0, nq0 = b0.shape
    nkj = c12t.shape[0]
    e = x.shape[1]
    et, g = qp_launch_config(x.element_size(), nm0, nrq, nq0, nkj, epb,
                             planes, *build.smem_limits(x.get_device()))
    if spans.profiler._is_profiler_enabled:
        out = spans.alloc((nq0 * nkj, e), x,
                          build.key("qp_fused3d", x.dtype))
    else:
        out = torch.empty((nq0 * nkj, e), dtype=x.dtype, device=x.device)
    build.run("qp_fused3d", x, x.data_ptr(), b0.data_ptr(), c12t.data_ptr(),
              out.data_ptr(), nm0, nrq, nq0, nkj, e, et, g)
    return out


# ---- Pallas(QP): K2 then K4, workspace in device memory ------------------


def qp_stage2_3d_plain(w, b0):
    """Plain PyTorch version of qp_stage2_3d: sums in f32 for bf16,
    rounded to w's dtype."""
    return torch.einsum("pi,pke->ike", *k2.widened(b0, w)).to(w.dtype)


def qp_stage2_3d(w, b0, *, unroll=None, out=None):
    """out (nq0, nkj, E) = sum_p B0[p, i] * w[p] from w (nm0, nkj, E) and
    b0 (nm0, nq0).  `unroll`: K4's 16-byte vectors a thread a step, one of
    qp2_unrolls (default QP2_UNROLL or the largest below it); `out`: a
    contiguous (nq0, nkj, E) tensor to write into, None allocates one."""
    build.check_operands("qp_stage2_3d", (w, b0), bf16=True)
    if w.dim() != 3 or b0.dim() != 2 or b0.shape[0] != w.shape[0]:
        raise ValueError(f"qp_stage2_3d: w {tuple(w.shape)} and b0 "
                         f"{tuple(b0.shape)} are not (nm0, nkj, E) and "
                         "(nm0, nq0)")
    nm0, nkj, e = w.shape
    nq0 = b0.shape[1]
    takes = qp2_unrolls(w.element_size(), nm0)
    if unroll is None:
        unroll = min(QP2_UNROLL, takes[-1])
    if unroll not in QP2_UNROLLS:
        raise ValueError(f"qp_stage2_3d: unroll={unroll} is not one of "
                         f"{QP2_UNROLLS}")
    if unroll not in takes:
        raise ValueError(f"qp_stage2_3d: unroll={unroll} with nm0={nm0} "
                         f"in {w.dtype}: the kernel takes at most "
                         f"{takes[-1]}")
    if out is not None:
        build.check_operands("qp_stage2_3d", (w, out), bf16=True)
        if out.shape != (nq0, nkj, e):
            raise ValueError(f"qp_stage2_3d: out {tuple(out.shape)} is not "
                             f"{(nq0, nkj, e)}")
    if w.is_cpu:
        ref = qp_stage2_3d_plain(w, b0)
        return ref if out is None else out.copy_(ref)
    size = w.element_size()
    if qp2_smem(size, nm0, nq0) > QP2_MAX_B0_BYTES:
        raise ValueError(f"qp_stage2_3d: b0 {tuple(b0.shape)} exceeds "
                         f"{QP2_MAX_B0_BYTES} B of shared memory")
    if out is None:
        out = torch.empty((nq0, nkj, e), dtype=w.dtype, device=w.device)
    f = nkj * e
    vector = build.vector16(f, size, w.data_ptr(), out.data_ptr())
    u = unroll if vector else 1
    blocks = qp2_grid(qp2_units(f, size, vector), u,
                      qp2_wave(w.get_device(), size, vector, nm0, nq0, u))
    build.run("qp_stage2_3d", w, w.data_ptr(), b0.data_ptr(), out.data_ptr(),
              nm0, nq0, f, u, int(vector), blocks)
    return out


def qp2_unrolls(itemsize, nm0) -> tuple:
    """The unrolls of QP2_UNROLLS K4 is built for at (element size, nm0):
    up to the largest, or QP2_CHUNKED_UNROLL where nm0 > QP2_EXACT; in bf16
    up to half of that, so a thread holds as many f32 registers of w as in
    f32."""
    top = QP2_UNROLLS[-1] if nm0 <= QP2_EXACT else QP2_CHUNKED_UNROLL
    if itemsize == 2:
        top //= 2
    return tuple(u for u in QP2_UNROLLS if u <= top)


def qp2_smem(itemsize, nm0, nq0) -> int:
    """K4's shared memory, B0: (nm0, nq0), or for nm0 > QP2_EXACT both
    padded with zeros to whole chunks of QP2_CHUNK."""
    if nm0 > QP2_EXACT:
        nm0, nq0 = _round_up(nm0, QP2_CHUNK), _round_up(nq0, QP2_CHUNK)
    return itemsize * nm0 * nq0


def qp2_units(f, itemsize, vector) -> int:
    """The units K4 deals out to blocks: F's 16-byte vectors, or its
    values in the scalar form."""
    return f * itemsize // 16 if vector else f


@functools.cache
def qp2_grid(nv, unroll, wave) -> int:
    """K4's blocks for nv units at `unroll` a thread: one wave (`wave`,
    the blocks the card holds at once), but no more than give each block
    one tile of QP2_THREADS * unroll units; at least one."""
    return max(1, min(wave, -(-nv // (QP2_THREADS * unroll))))


def qp2_shares(nv, blocks) -> list:
    """[start, end) of each block's units, as csrc/bwdtrans3d.cu deals
    them: block b owns [b * nv // blocks, (b + 1) * nv // blocks)."""
    return [(b * nv // blocks, (b + 1) * nv // blocks) for b in range(blocks)]


@functools.cache
def qp2_wave(device, itemsize, vector, nm0, nq0, unroll) -> int:
    """Blocks of K4's instance for (vector form, nm0, nq0, unroll) the card
    holds at once (the occupancy API's blocks an SM times the SMs)."""
    with torch.cuda.device(device):
        blocks = build.library().tbt_qp_stage2_wave(
            itemsize, int(vector), nm0, nq0, unroll)
    if blocks < 1:
        raise RuntimeError(f"qp_stage2_3d: no occupancy for nm0={nm0}, "
                           f"unroll={unroll}")
    return blocks


def qp_global3d_plain(in_pcoa3, b0, c12t):
    """Plain PyTorch version of qp_global3d (the workspace rounded to the
    dtype)."""
    return qp_stage2_3d_plain(k2.mm(c12t, in_pcoa3), b0)


def qp_global3d(in_pcoa3, b0, c12t, *, unroll=None):
    """out (nq0, nkj, E) from in (nm0, nrq, E), b0 (nm0, nq0) and c12t
    (nkj, nrq), through the workspace w (nm0, nkj, E) = C12T @ in[p].
    `unroll`: K4's vectors a thread a step."""
    return qp_stage2_3d(k2.kron_blocked(in_pcoa3, c12t), b0, unroll=unroll)


# ---- Pallas(QP-1D) and Pallas(QP-1D/Shared): element-major chain ---------


def qp1d3d_plain(in_em2, s1_em, s2_em, s3_em):
    """Plain PyTorch version of qp1d_shared3d and qp1d_global3d, each
    stage rounded to the dtype."""
    return k2.mm(k2.mm(k2.mm(in_em2, s1_em), s2_em), s3_em)


def qp1d_global3d(in_em2, s1_em, s2_em, s3_em, *, epb=None):
    """The chain as three K3 launches, w1 and w2 in device memory.
    `epb`: K3's elements per block (None or its tile height)."""
    w1 = k2.one_stage_em(in_em2, s1_em, epb=epb)
    w2 = k2.one_stage_em(w1, s2_em, epb=epb)
    return k2.one_stage_em(w2, s3_em, epb=epb)


def qp1d_tiles(in_em2, *ops) -> list:
    """The element tiles of QP1D_TILES for in_em2's dtype whose workspaces
    fit the card's opt-in shared memory for the chain in_em2 @ ops[0] @ ...
    (two or three stages), in order of preference."""
    n2 = ops[1].shape[1] if len(ops) == 3 else 0  # second workspace
    return qp1d_fits(in_em2.element_size(), in_em2.shape[1],
                     ops[0].shape[1], n2,
                     build.smem_limits(in_em2.get_device())[0])


def qp1d_smem(itemsize, et, k0, n1, n2) -> int:
    """Shared memory of one K5 block of element tile et (csrc/
    qp1d_fused3d.cu smem_bytes): w1, buffer B (X, then w2; n2 = 0 for the
    two-stage chain) with rows padded to a whole BK step plus the row
    padding, and the ring of S tiles."""
    bk, bn, pad = QP1D_STEP[itemsize]

    def ld(n):
        return _round_up(n, bk) + pad

    ld_b = max(ld(k0), ld(n2)) if n2 > 0 else ld(k0)
    return itemsize * (et * (ld(n1) + ld_b)
                       + QP1D_RING * bk * (bn + QP1D_SPAD))


@functools.cache
def qp1d_fits(itemsize, k0, n1, n2, limit=SMEM_BLOCK) -> list:
    """The tiles of QP1D_TILES[itemsize] whose buffers (qp1d_smem) fit
    `limit` bytes for a chain of input width k0 and workspaces n1 and n2
    (0: two stages), in order of preference."""
    return [et for et in QP1D_TILES[itemsize]
            if qp1d_smem(itemsize, et, k0, n1, n2) <= limit]


def qp1d_fused(in_em2, *ops, epb=None):
    """out (E, N) = in_em2 (E, K0) @ ops[0] @ ... in one K5 launch, the
    workspaces of each element tile in shared memory: three operators
    (benchmark05, entry qp1d_fused3d) or two (benchmark04, qp1d_fused2d).
    `epb`: the element tile, one of QP1D_TILES for the dtype; None takes
    the first that fits."""
    ops = (in_em2, *ops)
    build.check_operands("qp1d_fused", ops, bf16=True)
    if (len(ops) not in (3, 4) or any(t.dim() != 2 for t in ops)
            or any(a.shape[1] != b.shape[0] for a, b in zip(ops, ops[1:]))):
        raise ValueError("qp1d_fused: shapes "
                         f"{[tuple(t.shape) for t in ops]} do not chain "
                         "through two or three stages")
    tiles = QP1D_TILES[in_em2.element_size()]
    if epb is not None and epb not in tiles:
        raise ValueError(f"qp1d_fused: epb={epb} is not one of the "
                         f"kernel's element tiles {tiles} for {in_em2.dtype}")
    if in_em2.is_cpu:
        out = in_em2
        for s in ops[1:]:
            out = k2.mm(out, s)
        return out
    fits = qp1d_tiles(*ops)
    if epb is not None:
        fits = [et for et in fits if et == epb]
    if not fits:
        raise ValueError(f"qp1d_fused: element tile {epb or 'of any size'}"
                         " with workspaces of widths "
                         f"{[t.shape[1] for t in ops[1:-1]]} does not fit "
                         "the card's shared memory")
    e, k0 = in_em2.shape
    widths = [t.shape[1] for t in ops[1:]]
    out = torch.empty((e, widths[-1]), dtype=in_em2.dtype,
                      device=in_em2.device)
    name = "qp1d_fused3d" if len(ops) == 4 else "qp1d_fused2d"
    build.run(name, in_em2, *(t.data_ptr() for t in ops), out.data_ptr(), e,
              k0, *widths, fits[0])
    return out


def qp1d_shared3d(in_em2, s1_em, s2_em, s3_em, *, epb=None):
    """The three-stage chain in one K5 launch (qp1d_fused)."""
    return qp1d_fused(in_em2, s1_em, s2_em, s3_em, epb=epb)
