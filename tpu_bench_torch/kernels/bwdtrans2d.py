"""K2 and K3: the dense GEMMs over the element stream.

K2, benchmark05's Pallas(Coales) column and stage 1 of Pallas(QP), is the
port of tpu_bench/kernels/bwdtrans2d.py:kron_blocked:

    out[b] = C @ in[b]    in (nblk, nmTot, ce), C (nqTot, nmTot)
                          -> out (nblk, nqTot, ce)

K3 (em_gemm), benchmark05's Pallas(Uncoales) column and the three stages
of Pallas(QP-1D), is the port of kron_elem_major and _one_stage_em, the
element-major product with elements on rows:

    out (E, N) = in (E, K) @ S (K, N)

Both run one of two configurations: the small operator resident in shared
memory for the skinny products, else dense on the tensor cores.  The
wrapper picks it by a rule in pure Python (kron_config, em_config) and
passes it to the kernel, which runs the configuration it is given.  K2's
dense configuration has two bodies, picked the same way (dense_body):
3xTF32 on wgmma for f32 rows of whole 16-byte words, mma.sync for the
rest (and for K3).

The rest of tpu_bench/kernels/bwdtrans2d.py, benchmark04's 2D kernels, is
served by kernels that already compute each function on the same bytes;
the TPU kernels' differences were DMA, sublane or MXU-tile geometry:

    kron_coalesced                   kron_coalesced below: K2 on the
                                     (1, nmTot, E) view of the flat layout
    kron_wide4, kron_vpu_blocked     kron_wide4 below: K2 on a view of
                                     the 4D chunk layout
    qp_shared, qp_w, qp_w_flat,      K1, kernels/bwdtrans3d.qp_shared3d
    qp_mxu_grouped                   with nrq = nm1 and C12T = B1^T
    qp_global                        bwdtrans3d.qp_global3d: K2, then K4
    qp1d_shared                      bwdtrans3d.qp1d_fused: K5, two stages
    qp1d_global                      qp1d_global below: K3 twice

Both take f32, f64 and bf16.  In bf16 every product is exact and summed
in f32, and each output is rounded to bf16 once, as the JAX kernels'
`_dot` (bf16 operands, f32 accumulator) then `.astype` do; the plain
versions compute the same in f32 (`mm`).

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the kernel (csrc/), which raises rather than fall back when
it cannot run.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from tpu_bench_torch.core import spans
from tpu_bench_torch.kernels import build

# K2's C-resident configuration (csrc/bwdtrans2d.cu): its strip widths,
# its ring of strips, its micro-tile and its block; kron_config states
# which configuration a product runs.  (Chosen on an NVIDIA H100 80GB
# HBM3, 700.00 W, by benchmarks/kernel_blocks.py; PERF.md section 6.)
KRON_STRIPS = (64, 128, 256, 512)
KRON_RING = 3
KRON_TILE = 4      # rows and columns of a micro-tile
KRON_THREADS = 256
SMEM_BLOCK = 232448  # the H100's opt-in shared memory of one block
# K3's S-resident configuration (csrc/bwdtrans2d.cu): its element-tile
# heights, its ring of tiles, a warp's unit of rows x columns and the
# block's warps; em_config states which configuration a product runs.
# (Chosen on an NVIDIA H100 80GB HBM3, 700.00 W, by
# benchmarks/kernel_blocks.py; PERF.md section 6.)
EM_TILES = (32, 64, 128, 256)
EM_RING = 2
EM_UNIT = (32, 64)
EM_WARPS = 8
EM_EPB = 128  # the element block the JAX kernels take (`epb`)


class DenseTile(NamedTuple):
    """A block tile of the dense configuration: bm x bn outputs, bk deep a
    ring slot, `ring` slots, A's and B's rows padded by a_pad and b_pad
    values, `blocks` blocks an SM, on mma tiles of mma (M, N, K)."""
    bm: int
    bn: int
    bk: int
    ring: int
    a_pad: int
    b_pad: int
    blocks: int
    mma: tuple


# K2's and K3's dense configuration in f64 (csrc/bwdtrans2d.cu Dense<double>,
# DenseF64, dense_ring): 4 warps of 64 x 32 outputs on sm_90's m16n8k8
# DMMA, two blocks an SM.  (Chosen on an NVIDIA H100 80GB HBM3, 700.00 W,
# over tiles of 64-256 rows, warp tiles of 32 x 32 to 64 x 32, m16n8k8 and
# m16n8k16, depths 16 and 32 and rings of 2-4, at K2's and K3's five b05
# nq=8^3 products; PERF.md section 6.)
DENSE_F64 = DenseTile(bm=128, bn=64, bk=16, ring=2, a_pad=8, b_pad=2,
                      blocks=2, mma=(16, 8, 8))


class WgmmaTile(NamedTuple):
    """K2's f32 dense body on wgmma: tiles of `be` elements (columns of
    in[b]) by `bm` points (rows of C), `bk` deep a ring stage, `ring`
    stages; C's halves in groups of 4 k (bm x 4 values) padded by c_pad
    values, in's tile rows by in_pad, the consumer groups' staging rows by
    out_pad; `threads` a block, one block an SM."""
    be: int
    bm: int
    bk: int
    ring: int
    c_pad: int
    in_pad: int
    out_pad: int
    threads: int


# K2's f32 dense body on wgmma (csrc/bwdtrans2d.cu WgF32): two consumer
# warp groups of 64 elements x 128 points and a producer group.
WGMMA_F32 = WgmmaTile(be=128, bm=128, bk=32, ring=3, c_pad=4, in_pad=8,
                      out_pad=4, threads=384)

# K2's dense launches by (dtype, body) since the count was last reset:
# "wgmma" (f32 only) or "mma" (mma.sync, every dtype); dense_body's choice.
dense_bodies: collections.Counter = collections.Counter()
# K2's launches by (dtype, strip) since the count was last reset: the strip
# width of the C-resident configuration, or 0 for the dense one.
kron_strips: collections.Counter = collections.Counter()


def wgmma_smem(tile: WgmmaTile = WGMMA_F32) -> int:
    """Shared memory of one block of the wgmma body (csrc/bwdtrans2d.cu
    wgmma_smem): a ring of stages, each C's big and small halves (bm x bk,
    each group of 4 k padded) and in's tile (bk x be, rows padded); two
    consumer groups' staging of bm points x be / 2 elements (rows padded);
    two mbarriers a stage."""
    half = tile.bk // 4 * (tile.bm * 4 + tile.c_pad)
    stage = 2 * half + tile.bk * (tile.be + tile.in_pad)
    staging = 2 * tile.bm * (tile.be // 2 + tile.out_pad)
    return 4 * (tile.ring * stage + staging) + 8 * 2 * tile.ring


def dense_body(dtype, ce: int, ptr: int) -> str:
    """K2's dense body for in[b] of `dtype` with rows of ce values at
    address ptr: "wgmma" in f32 where the TMA can read in's rows (ce a
    multiple of 4, in on a 16-byte boundary: its stride rule), else "mma"
    (mma.sync: f64, bf16, ragged or misaligned rows)."""
    if dtype == torch.float32 and build.vector16(ce, 4, ptr):
        return "wgmma"
    return "mma"


def dense_smem(tile: DenseTile, itemsize: int = 8) -> int:
    """Shared memory of one block of the dense configuration
    (csrc/bwdtrans2d.cu kron_dense_smem): a ring of A (bm x bk) and B
    (bk x bn) tiles, their rows padded."""
    return itemsize * tile.ring * (tile.bm * (tile.bk + tile.a_pad)
                                   + tile.bk * (tile.bn + tile.b_pad))


def widened(*ts):
    """The tensors in the kernels' sum type: f32 for bf16, else as they
    are."""
    return [t.float() if t.dtype == torch.bfloat16 else t for t in ts]


def mm(a, b):
    """a @ b as the kernels compute it: in bf16 the operands widened to
    f32, the products summed in f32 and the result rounded to bf16 once;
    in f32 and f64 torch.matmul."""
    return torch.matmul(*widened(a, b)).to(a.dtype)


def kron_blocked_plain(in_blk, c_coa):
    """Plain PyTorch version of kron_blocked."""
    return mm(c_coa, in_blk)


def kron_blocked(in_blk, c_coa, *, strip=None):
    """out (nblk, nqTot, ce) = C (nqTot, nmTot) @ in (nblk, nmTot, ce).
    `strip`: None runs kron_config's configuration; 0 the dense one; one
    of KRON_STRIPS the C-resident one at that strip width.  The dense
    configuration runs dense_body's body.  Under the span tbt.kron_blocked
    while a profiler records (core/spans.py)."""
    if spans.profiler._is_profiler_enabled:
        with spans.span("tbt.kron_blocked"):
            return _kron_blocked(in_blk, c_coa, strip)
    return _kron_blocked(in_blk, c_coa, strip)


def _kron_blocked(in_blk, c_coa, strip):
    _check(in_blk, c_coa)
    if strip is not None and strip != 0 and strip not in KRON_STRIPS:
        raise ValueError(f"kron_blocked: strip={strip} is not 0 or one of "
                         f"{KRON_STRIPS}")
    if in_blk.is_cpu:
        return kron_blocked_plain(in_blk, c_coa)
    if not in_blk.is_cuda:
        raise ValueError(f"kron_blocked: no kernel for device {in_blk.device}")
    return _launch(in_blk, c_coa, strip)


def kron_resident_smem(itemsize, m, k, bn) -> int:
    """Shared memory of the C-resident configuration (csrc/bwdtrans2d.cu
    kron_resident_smem): C^T with M padded to KRON_TILE, the values
    rounded up to a whole 16-byte word (bf16 with K odd), and KRON_RING
    strips of k x bn."""
    word = 16 // itemsize
    ct = k * (-(-m // KRON_TILE) * KRON_TILE)
    return itemsize * (-(-ct // word) * word + KRON_RING * k * bn)


@functools.cache
def kron_config(itemsize, m, k, limit=SMEM_BLOCK) -> int:
    """K2's rule for C (m x k), which _launch passes to the kernel: the
    strip width of the C-resident configuration, the narrowest of
    KRON_STRIPS whose micro-tiles fill the block, narrowed until C^T and
    the ring fit `limit` bytes; 0, the dense configuration on the tensor
    cores, if they fit at none."""
    tiles = -(-m // KRON_TILE)
    bn = KRON_STRIPS[0]
    while bn < KRON_STRIPS[-1] and tiles * (bn // KRON_TILE) < KRON_THREADS:
        bn *= 2
    for width in reversed(KRON_STRIPS):
        if width <= bn and kron_resident_smem(itemsize, m, k, width) <= limit:
            return width
    return 0


def _check(x, c):
    if x.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"kron_blocked: dtype {x.dtype} is not supported")
    if c.dtype != x.dtype:
        raise TypeError("kron_blocked: in and C must share one dtype")
    if c.device != x.device:
        raise ValueError("kron_blocked: in and C must share one device")
    if x.dim() != 3 or c.dim() != 2 or c.shape[1] != x.shape[1]:
        raise ValueError(f"kron_blocked: in {tuple(x.shape)} and C "
                         f"{tuple(c.shape)} are not (nblk, nmTot, ce) and "
                         "(nqTot, nmTot)")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("kron_blocked: in and C must be contiguous")


def _launch(x, c, strip):
    nblk, nm_tot, ce = x.shape
    nq_tot = c.shape[0]
    if max(nblk, nm_tot, nq_tot, ce) >= 2**31:
        raise ValueError(f"kron_blocked: in {tuple(x.shape)} exceeds the "
                         "kernel's 32-bit extents")
    limit = build.smem_limits(x.get_device())[0]
    if strip is None:
        strip = kron_config(x.element_size(), nq_tot, nm_tot, limit)
    elif strip and kron_resident_smem(x.element_size(), nq_tot, nm_tot,
                                      strip) > limit:
        raise ValueError(f"kron_blocked: C ({nq_tot} x {nm_tot}) and "
                         f"strips of {strip} do not fit the card's "
                         f"{limit} B of shared memory")
    body = dense_body(x.dtype, ce, x.data_ptr()) if strip == 0 else None
    if spans.profiler._is_profiler_enabled:
        out = spans.alloc((nblk, nq_tot, ce), x,
                          build.key("kron_blocked", x.dtype))
    else:
        out = torch.empty((nblk, nq_tot, ce), dtype=x.dtype, device=x.device)
    build.run("kron_blocked", x, c.data_ptr(), x.data_ptr(), out.data_ptr(),
              nq_tot, nm_tot, ce, nblk, strip, int(body == "wgmma"))
    kron_strips[(build.SUFFIXES[x.dtype], strip)] += 1
    if body:
        dense_bodies[(build.SUFFIXES[x.dtype], body)] += 1
    return out


def kron_coalesced_plain(in_coa, c_coa):
    """Plain PyTorch version of kron_coalesced."""
    return mm(c_coa, in_coa)


def kron_coalesced(in_coa, c_coa, *, epb=None):
    """out (nqTot, E) = C (nqTot, nmTot) @ in (nmTot, E), the flat
    coalesced layout: K2 on the (1, nmTot, E) view.  `epb`, the TPU
    kernel's element block, is accepted and ignored."""
    if in_coa.dim() != 2:
        raise ValueError(f"kron_coalesced: in {tuple(in_coa.shape)} is not "
                         "(nmTot, E)")
    nm_tot, e = in_coa.shape
    out = kron_blocked(in_coa.view(1, nm_tot, e), c_coa)
    return out.view(c_coa.shape[0], e)


def kron_elem_major_plain(in_em2, c_em):
    """Plain PyTorch version of kron_elem_major and one_stage_em."""
    return mm(in_em2, c_em)


def kron_elem_major(in_em2, c_em, *, epb=None, tile=None):
    """out (E, nqTot) = in (E, nmTot) @ C_em (nmTot, nqTot): K3, `epb` and
    `tile` as one_stage_em's."""
    return _em_gemm("kron_elem_major", in_em2, c_em, epb, tile)


def one_stage_em(x, s, *, epb=None, tile=None):
    """One element-major stage, out (E, N) = x (E, K) @ s (K, N): K3.
    `epb`, the JAX kernel's element block, is None or EM_EPB and is
    ignored; `tile`: None runs em_config's configuration, 0 the dense one,
    one of EM_TILES the S-resident one at that tile height."""
    return _em_gemm("one_stage_em", x, s, epb, tile)


def em_resident_smem(itemsize, k, n, be) -> int:
    """Shared memory of K3's S-resident configuration (csrc/bwdtrans2d.cu
    em_resident_smem): S with N padded to a warp unit's columns, and
    EM_RING element tiles of be x k."""
    cols = EM_UNIT[1]
    return itemsize * (k * (-(-n // cols) * cols) + EM_RING * be * k)


@functools.cache
def em_config(itemsize, k, n, limit=SMEM_BLOCK) -> int:
    """K3's rule for S (k x n), which _em_launch passes to the kernel: the
    tile height of the S-resident configuration, the narrowest of EM_TILES
    whose warp units fill the block, narrowed until S and the ring fit
    `limit` bytes; 0, the dense configuration on the tensor cores, if they
    fit at none."""
    rows, cols = EM_UNIT
    chunks = -(-n // cols)
    be = EM_TILES[0]
    while be < EM_TILES[-1] and (be // rows) * chunks < EM_WARPS:
        be *= 2
    for height in reversed(EM_TILES):
        if height <= be and em_resident_smem(itemsize, k, n, height) <= limit:
            return height
    return 0


def _em_gemm(name, x, s, epb, tile):
    build.check_operands(name, (x, s), bf16=True)
    if x.dim() != 2 or s.dim() != 2 or s.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: in {tuple(x.shape)} and S "
                         f"{tuple(s.shape)} are not (E, K) and (K, N)")
    if epb not in (None, EM_EPB):
        raise ValueError(f"{name}: the kernel takes {EM_EPB} elements per "
                         f"block or None, not epb={epb}")
    if tile is not None and tile != 0 and tile not in EM_TILES:
        raise ValueError(f"{name}: tile={tile} is not 0 or one of "
                         f"{EM_TILES}")
    if x.is_cpu:
        return kron_elem_major_plain(x, s)
    return _em_launch(name, x, s, tile)


def _em_launch(name, x, s, tile):
    e, k = x.shape
    n = s.shape[1]
    if max(e, k, n) >= 2**31:
        raise ValueError(f"{name}: {tuple(x.shape)} @ {tuple(s.shape)} "
                         "exceeds the kernel's 32-bit extents")
    limit = build.smem_limits(x.get_device())[0]
    if tile is None:
        tile = em_config(x.element_size(), k, n, limit)
    elif tile and em_resident_smem(x.element_size(), k, n, tile) > limit:
        raise ValueError(f"{name}: S ({k} x {n}) and tiles of {tile} do not "
                         f"fit the card's {limit} B of shared memory")
    out = torch.empty((e, n), dtype=x.dtype, device=x.device)
    build.run("em_gemm", x, x.data_ptr(), s.data_ptr(), out.data_ptr(), e, k,
              n, tile)
    return out


# ---- benchmark04 (2D) ------------------------------------------------------


def kron_wide4_plain(in_blk4, c_coa):
    """Plain PyTorch version of kron_wide4."""
    nblk, nm, cr, lanes = in_blk4.shape
    out = mm(c_coa, in_blk4.reshape(nblk, nm, cr * lanes))
    return out.reshape(nblk, c_coa.shape[0], cr, lanes)


def kron_wide4(in_blk4, c_coa):
    """out (nblk, nqTot, cr, lanes) = C (nqTot, nmTot) @ in (nblk, nmTot,
    cr, lanes) per chunk: K2 on the contiguous bytes viewed (nblk, nmTot,
    cr*lanes)."""
    if in_blk4.dim() != 4 or not in_blk4.is_contiguous():
        raise ValueError(f"kron_wide4: in {tuple(in_blk4.shape)} is not a "
                         "contiguous (nblk, nmTot, cr, lanes) tensor")
    nblk, nm, cr, lanes = in_blk4.shape
    out = kron_blocked(in_blk4.view(nblk, nm, cr * lanes), c_coa)
    return out.view(nblk, c_coa.shape[0], cr, lanes)


def qp1d_plain(in_em2, s1_em, s2_em):
    """Plain PyTorch version of the two-stage chain (qp1d_global and
    bwdtrans3d.qp1d_fused with two operators): each stage rounded to the
    dtype, as the JAX kernels round their workspace."""
    return mm(mm(in_em2, s1_em), s2_em)


def qp1d_global(in_em2, s1_em, s2_em, *, epb=None):
    """The chain as two K3 launches, the workspace in device memory."""
    return one_stage_em(one_stage_em(in_em2, s1_em, epb=epb), s2_em, epb=epb)
