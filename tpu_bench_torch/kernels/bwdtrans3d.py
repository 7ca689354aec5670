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
kernel (csrc/qp_fused3d.cuh, its entries in csrc/bwdtrans3d.cu) serves
both.  While a torch profiler records, K1 runs its probe form instead
(csrc/qp_fused3d_probe.cu), whose blocks time their own phases in SM
cycles into a buffer on the card; qp_phases reads it back.

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

import collections
import functools
import typing

import torch

from tpu_bench_torch.core import spans
from tpu_bench_torch.kernels import bwdtrans2d as k2
from tpu_bench_torch.kernels import build

# K1 (csrc/qp_fused3d.cuh): its element tiles (the elements a block owns
# and stages in shared memory) by element size, largest first; its plane
# groups (output planes of one pass); its forms by element size, (slab
# slots, threads a block): depth 1, a block a tile, and depth 2, a
# persistent block that copies the next tile's slab while it computes one
# (in f64 of 256 threads only: at 512, 128 registers a thread spilled),
# built for the tiles QP_RING_TILES (two slabs of more elements fit only
# the smallest orders, where the sweep found depth 1 as fast); its
# depth-1 block, stage-2 micro-tile (kj rows x elements) and the H100's
# shared memory: the most one block may opt in to, an SM's total, and
# what the card reserves of it for each block.  qp_config picks a
# configuration for each shape; the rule rests on benchmarks/
# kernel_blocks.py (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
QP_TILES = {2: (128, 64, 32, 16), 4: (128, 64, 32, 16), 8: (64, 32, 16, 8)}
QP_PLANE_GROUPS = (4, 8)
QP_FORMS = {2: ((1, 256), (2, 256), (2, 512)),
            4: ((1, 256), (2, 256), (2, 512)), 8: ((1, 256), (2, 256))}
QP_RING_TILES = (32, 16)
QP_THREADS = 256
QP_TK, QP_TE = 8, 4
# K1's stage-2 bodies: the SIMT micro-tiles, in f64 sm_90's DMMA
# (mma.sync.m16n8k8 on f64), built for the tiles QP_DMMA_TILES at either
# depth, in bf16 the bf16 tensor cores (HMMA, mma.sync.m16n8k16 with f32
# sums), built for QP_HMMA_TILES at depth 1 and the ring's tiles at depth
# 2, and in f32 3xTF32 on wgmma (TF32, m64n64k8 with f32 sums), built for
# QP_TF32_TILES at either depth, each with the plane group of
# QP_TF32_COLUMNS columns (qp_tf32_planes: one warp group of a block's two
# takes half); where DMMA's C12T lives: staged in shared memory, or held in
# registers, each warp one m tile of QP_MMA_M rows and QP_MMA_STEPS k
# steps of QP_MMA_K (qp_dmma_takes); HMMA holds it so, QP_HMMA_STEPS k
# steps of QP_HMMA_K (qp_hmma_takes); TF32 holds its one m tile of
# QP_TF32_M rows, QP_TF32_STEPS k steps of QP_TF32_K (qp_tf32_takes);
# stage 1's bodies: the SIMT sums, and in f64 DMMA beside the held DMMA
# stage 2, built at QP_S1_DMMA_FORM alone (et, planes, depth, threads:
# groups of QP_S1_PLANES planes, one slab slot in a persistent block that
# copies the next tile's slab once the last group's stage 1 is done), for
# nm0 within QP_S1_STEPS k steps of QP_MMA_K (qp_s1_dmma_takes), its
# slab's rows padded by QP_S1_PAD values (qp_slab_ld); the entry's `body`
# argument for each (body, C12T, stage 1) triple.
QP_BODIES = ("simt", "dmma", "hmma", "tf32")
QP_C12T = ("smem", "regs")
QP_STAGE1 = ("simt", "dmma")
QP_ENTRY_BODIES = {("simt", "smem", "simt"): 0, ("dmma", "smem", "simt"): 1,
                   ("dmma", "regs", "simt"): 2, ("hmma", "regs", "simt"): 3,
                   ("tf32", "regs", "simt"): 4, ("dmma", "regs", "dmma"): 5}
QP_S1_PLANES = 16
QP_S1_DMMA_FORM = (16, QP_S1_PLANES, 1, 256)
QP_S1_STEPS, QP_S1_PAD = 4, 2
QP_DMMA_TILES = (32, 16)
QP_HMMA_TILES = (64, 32, 16)
QP_TF32_TILES = (32, 16)
QP_MMA_M, QP_MMA_K = 16, 8
QP_MMA_STEPS = 11
QP_HMMA_K, QP_HMMA_STEPS = 16, 6
QP_TF32_M, QP_TF32_K, QP_TF32_STEPS = 64, 8, 7
QP_TF32_COLUMNS = 128
SMEM_BLOCK = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
# In front of a depth-2 block's buffers: the tiles its two slots hold
QP_SLOT_TILES_BYTES = 16
# The element tile: None takes qp_config's choice.
EPB = None


class QPConfig(typing.NamedTuple):
    """K1's configuration of a launch."""
    et: int          # element tile
    planes: int      # plane group
    depth: int = 1   # slab slots of a block (1: a block a tile)
    threads: int = QP_THREADS
    body: str = "simt"  # stage 2's body, one of QP_BODIES
    c12t: str = "smem"  # where C12T lives, one of QP_C12T ("regs": DMMA,
                        # HMMA, TF32)
    stage1: str = "simt"  # stage 1's body, one of QP_STAGE1 ("dmma": f64,
                          # beside DMMA with C12T held, QP_S1_DMMA_FORM)


def qp_entry_body(cfg) -> int:
    """The entry's `body` argument of a QPConfig."""
    return QP_ENTRY_BODIES[cfg.body, cfg.c12t, cfg.stage1]


# K1's configuration at the shapes benchmarks/kernel_blocks.py sweeps, by
# (itemsize, nm0, nrq, nq0, nkj): its fastest (element tile, plane group)
# in one run, and (depth, threads) where the ring ran faster in two (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 6).  Depth 2 took 3-22% off
# the best depth-1 time at b05 6^3-10^3 in f32, 8^3 in f64 and 10^3 in
# bf16; elsewhere depth 1 was as fast or faster.  Before the ring, the
# depth-1 rule of qp_config gave the sweep's tile and group at 4^3, 8^3
# and 10^3 in f32 and 10^3, 8^2 and 32^2 in f64, and elsewhere a setting
# 1.5-32% slower (f64 b04 16^2: 2.0687 ms against 1.5636).  The f64 rows
# were swept again over both stage-2 bodies (PERF.md section 6): DMMA took
# b05 10^3 from 2.87 to 1.46 ms (E=131072), 6^3 from 0.19 to 0.16, b04
# 16^2 from 1.57 to 1.52 and 32^2 from 15.2 to 10.7; SIMT stayed fastest
# at b05 4^3 and b04 8^2.  Then over where DMMA's C12T lives: held in
# registers it took b05 10^3 to 1.10 ms in the ring (16, 4, 2), which fits
# only so (E = 524,288: 5.36-5.98 staged at depth 1, 4.20-4.33 held in
# the ring), b04 32^2 to 9.44-9.80, and b05 8^3 to (32, 4, 2), which ran
# a call of the cell's 1,048,576 elements in 3.21 ms back to back against
# the staged ring's 3.63 and (16, 4, 1)'s 3.13-3.33 at depth 1; staged it
# stays fastest at 6^3 ((32, 8, 1) now, 0.156 against the held form's
# 0.180) and b04 16^2 (1.515 against 1.929).  The bf16 rows over both
# bodies, then back to back at the cells' sizes (PERF.md section 6): at
# b05 8^3 (E = 1,048,576) HMMA (64, 4, 1) ran a call in
# 0.8055-0.8278 ms and (32, 8, 2) 0.8148-0.8294, against SIMT's 1.9719; at
# 10^3 (E = 524,288) HMMA (32, 4, 1) 1.1358-1.1509 against the SIMT ring's
# 3.6362-3.8224.  The f32 rows over SIMT and 3xTF32 on wgmma (TF32, C12T
# held), flushed and back to back at the sweep's sizes (PERF.md section
# 6): TF32 took b05 8^3 (E = 131,072) from the ring's (16, 8, 2) on SIMT,
# 0.2772-0.2810 ms flushed and 0.2716-0.2734 back to back, to (32, 4, 1),
# 0.2056-0.2080 and 0.1996-0.2092 (TF32's (16, 8, 2): 0.2052-0.2080 and
# 0.2045-0.2092); at every other f32 row SIMT stayed fastest, by 1.2-3.9x
# (its C12T fills at most 36 of the m64 tile's rows, or, at 10^3, does not
# fit it).  The f64 rows over both stage-1 bodies, flushed and back to back
# (PERF.md section 6): at b04 32^2 (E = 524,288) stage 1 on DMMA at (16,
# 16, 1) took a call from the held DMMA form's (16, 8, 1) on the SIMT
# stage 1, 4.82-4.91 ms, to 3.28-3.43; at b05 8^3 it swept faster than the
# ring (0.37 against 0.40 ms at E = 131,072), a candidate left to its own
# measurement at the cell's size; at b05 4^3, 6^3 and b04 8^2, 16^2 it was
# slower, and at 10^3 it does not fit.
QP_MEASURED = {
    (4, 3, 9, 4, 16): QPConfig(128, 4, 1, 256),
    (4, 5, 25, 6, 36): QPConfig(32, 8, 2, 256),
    (4, 7, 49, 8, 64): QPConfig(32, 4, 1, 256, "tf32", "regs"),
    (4, 9, 81, 10, 100): QPConfig(16, 8, 2, 512),
    (4, 7, 7, 8, 8): QPConfig(128, 4, 1, 256),
    (4, 15, 15, 16, 16): QPConfig(64, 4, 1, 256),
    (4, 31, 31, 32, 32): QPConfig(16, 8, 1, 256),
    (8, 3, 9, 4, 16): QPConfig(64, 4, 1, 256),
    (8, 5, 25, 6, 36): QPConfig(32, 8, 1, 256, "dmma"),
    (8, 7, 49, 8, 64): QPConfig(32, 4, 2, 256, "dmma", "regs"),
    (8, 9, 81, 10, 100): QPConfig(16, 4, 2, 256, "dmma", "regs"),
    (8, 7, 7, 8, 8): QPConfig(64, 8, 1, 256),
    (8, 15, 15, 16, 16): QPConfig(32, 8, 1, 256, "dmma"),
    (8, 31, 31, 32, 32): QPConfig(16, 16, 1, 256, "dmma", "regs", "dmma"),
    (2, 7, 49, 8, 64): QPConfig(64, 4, 1, 256, "hmma", "regs"),
    (2, 9, 81, 10, 100): QPConfig(32, 4, 1, 256, "hmma", "regs"),
}
# K1's launches by the depth they took (a launch of the depth-2 form counts
# under 2), since the count was last reset: how often the slab ring runs.
qp_depths: collections.Counter = collections.Counter()
# K1's launches by (dtype, body) since the count was last reset: "simt",
# "dmma" (f64 only, either form), "hmma" (bf16 only) or "tf32" (f32 only),
# qp_config's choice.
qp_bodies: collections.Counter = collections.Counter()
# K1's launches by (dtype, stage-1 body) since the count was last reset:
# "simt", or "dmma" (f64 only, beside DMMA with C12T held).
qp_stage1_bodies: collections.Counter = collections.Counter()
# K1's DMMA launches by where C12T lived ("smem" or "regs") since the count
# was last reset.
qp_dmma_c12t: collections.Counter = collections.Counter()
# K1's probe form (csrc/qp_fused3d.cuh, P = true), which _launch takes in
# place of the plain form only while a torch profiler records: the phases
# whose SM cycles its blocks sum (the block, the wait for the slab, stage
# 1, stage 2 with its stores), and the layout of its buffer in device
# memory, of 64-bit words (csrc/qp_fused3d.cuh QPProbe):
# QP_PROBE_HEAD head words (the newest launch's grid, resident block
# slots and number), QP_PROBE_ROWS rows of QP_PHASES totals, a ring of
# QP_PROBE_LAUNCHES launch spans (two words each), then QP_PROBE_RECORD
# words a block of the newest launch.  A device's buffer is made, zeroed,
# on its first probed launch and grown where a launch has more blocks than
# it holds records for (at least QP_PROBE_MIN_RECORDS).
QP_PHASES = ("block", "wait", "stage1", "stage2")
QP_PROBE_HEAD, QP_PROBE_ROWS = 4, 32
QP_PROBE_LAUNCHES, QP_PROBE_RECORD = 32768, 4
QP_PROBE_MIN_RECORDS = 8192
_WORD = 2**64


class QPProbe:
    """A device's probe buffer (`words`, int64 on the card), the block
    records it holds and K1's probed launches on the device so far."""

    def __init__(self, words: torch.Tensor, capacity: int, launches: int):
        self.words, self.capacity, self.launches = words, capacity, launches


# K1's probe buffers by device index.
qp_probes: dict = {}
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


def qp_shared3d(in_pcoa3, b0, c12t, *, epb=EPB, planes=None, depth=None,
                threads=None, body=None, where=None, stage1=None):
    """out (nq0, nkj, E) from in (nm0, nrq, E), b0 (nm0, nq0),
    c12t (nkj, nrq).  `epb`: K1's element tile, one of QP_TILES for the
    dtype, `planes`, one of QP_PLANE_GROUPS, `depth` and `threads`, a
    form of qp_forms, `body`, stage 2's body of qp_built_bodies, `where`,
    where C12T lives, one of qp_c12t_places, and `stage1`, stage 1's body,
    one of qp_stage1_places; None takes qp_config's choice."""
    if in_pcoa3.dim() != 3:
        raise ValueError(f"in_pcoa3 must be (nm0, nrq, E), got "
                         f"{tuple(in_pcoa3.shape)}")
    nm0, nrq, e = in_pcoa3.shape
    out = qp_shared3d_flat(in_pcoa3.reshape(nm0 * nrq, e), b0, c12t, nrq=nrq,
                           epb=epb, planes=planes, depth=depth,
                           threads=threads, body=body, where=where,
                           stage1=stage1)
    return out.reshape(-1, c12t.shape[0], e)


def qp_shared3d_flat(in_pflat, b0, c12t, *, nrq, epb=EPB, planes=None,
                     depth=None, threads=None, body=None, where=None,
                     stage1=None):
    """out (nq0*nkj, E) from in (nm0*nrq, E), rows p*nrq + rq; under the
    span tbt.qp_shared3d_flat while a profiler records (core/spans.py)."""
    knobs = (epb, planes, depth, threads, body, where, stage1)
    if spans.profiler._is_profiler_enabled:
        with spans.span("tbt.qp_shared3d_flat"):
            return _qp_shared3d_flat(in_pflat, b0, c12t, nrq, *knobs)
    return _qp_shared3d_flat(in_pflat, b0, c12t, nrq, *knobs)


def _qp_shared3d_flat(in_pflat, b0, c12t, nrq, epb, planes, depth, threads,
                      body, where, stage1):
    _check(in_pflat, b0, c12t, nrq)
    if in_pflat.is_cpu:
        return qp_shared3d_flat_plain(in_pflat, b0, c12t, nrq=nrq)
    if not in_pflat.is_cuda:
        raise ValueError(f"qp_shared3d: no kernel for device {in_pflat.device}")
    return _launch(in_pflat, b0, c12t, nrq, epb, planes, depth, threads,
                   body, where, stage1)


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


def qp_lda(nrq) -> int:
    """The staged DMMA form's C12T row stride: nrq padded to QP_MMA_K, then
    to 8 mod 16 values (its A fragments' loads conflict-free)."""
    kp = _round_up(nrq, QP_MMA_K)
    return kp if kp % 16 else kp + 8


def qp_smem(itemsize, et, g, nm0, nrq, nq0, nkj, depth=1, body="simt",
            where="smem", stage1="simt") -> int:
    """Shared memory of one K1 block (csrc/qp_fused3d.cuh qp_smem_bytes):
    `depth` input slabs of the element tile (nm0 nrq rows of qp_slab_ld
    values), V (nrq x et; HMMA's rows in whole pairs) for g planes, C12T's
    buffer and B0 with nq0 padded to g; at depth 2, and for the DMMA stage
    1's persistent blocks, the slots' tiles too.  C12T's buffer: C12T^T
    with nkj padded to QP_TK for SIMT; for DMMA with C12T `where` "smem",
    C12T with nkj padded to QP_MMA_M rows of qp_lda values, and with
    "regs" none.
    TF32's V: two halves (big and small) of its QP_TF32_STEPS k steps of
    QP_TF32_K rows, whatever nrq."""
    if body == "simt":
        c = nrq * _round_up(nkj, QP_TK)
    else:
        c = 0 if where == "regs" else _round_up(nkj, QP_MMA_M) * qp_lda(nrq)
    if body == "tf32":
        v = 2 * QP_TF32_STEPS * QP_TF32_K * g * et
    else:
        v = g * (_round_up(nrq, 2) if body == "hmma" else nrq) * et
    slots = depth > 1 or stage1 == "dmma"
    return (QP_SLOT_TILES_BYTES if slots else 0) + itemsize * (
        depth * nm0 * nrq * qp_slab_ld(et, stage1) + v + c
        + nm0 * _round_up(nq0, g))


def qp_slab_ld(et, stage1="simt") -> int:
    """Values of a K1 slab row in shared memory (csrc/qp_fused3d.cuh
    qp_slab_ld): et, and QP_S1_PAD more for the DMMA stage 1, whose A loads
    of a quarter warp (p = 2t apart) then hit distinct banks where nrq is
    odd."""
    return et + (QP_S1_PAD if stage1 == "dmma" else 0)


def qp_dmma_takes(nrq, nkj) -> bool:
    """Whether DMMA with C12T held in registers serves a shape: each warp
    of QP_THREADS holds one m tile of C12T (nkj <= 128) as A fragments of
    QP_MMA_STEPS k steps (nrq <= 88)."""
    return (nrq <= QP_MMA_K * QP_MMA_STEPS
            and _round_up(nkj, QP_MMA_M) // QP_MMA_M <= QP_THREADS // 32)


def qp_s1_dmma_takes(nm0, nrq, nkj) -> bool:
    """Whether the DMMA stage 1 serves a shape: the held DMMA form's
    (qp_dmma_takes), and nm0 within its QP_S1_STEPS k steps (nm0 <= 32)."""
    return qp_dmma_takes(nrq, nkj) and nm0 <= QP_MMA_K * QP_S1_STEPS


def qp_hmma_takes(nrq, nkj) -> bool:
    """Whether the HMMA body serves a shape: each warp of QP_THREADS holds
    one m tile of C12T (nkj <= 128) as m16n8k16 A fragments of
    QP_HMMA_STEPS k steps (nrq <= 96)."""
    return (nrq <= QP_HMMA_K * QP_HMMA_STEPS
            and _round_up(nkj, QP_MMA_M) // QP_MMA_M <= QP_THREADS // 32)


def qp_tf32_takes(nrq, nkj) -> bool:
    """Whether the TF32 body serves a shape: C12T within its one m tile
    of QP_TF32_M kj rows (nkj <= 64), held as A fragments of QP_TF32_STEPS
    k steps (nrq <= 56): b05 to 8^3, b04 to 32^2."""
    return nrq <= QP_TF32_K * QP_TF32_STEPS and nkj <= QP_TF32_M


def qp_tf32_planes(et) -> int:
    """The TF32 body's plane group at element tile et: QP_TF32_COLUMNS
    columns, half to each of a block's two warp groups."""
    return QP_TF32_COLUMNS // et


def qp_forms(itemsize, et, body="simt") -> tuple:
    """K1's (depth, threads) forms at element tile et: depth 2 at
    QP_RING_TILES only, and HMMA's and TF32's in blocks of QP_THREADS only
    (HMMA's 512-thread ring was the slowest of its forms at every order
    swept; TF32's block is two warp groups)."""
    forms = QP_FORMS[itemsize] if et in QP_RING_TILES else \
        QP_FORMS[itemsize][:1]
    return tuple(f for f in forms
                 if body not in ("hmma", "tf32") or f[1] == QP_THREADS)


def qp_built_bodies(itemsize, et) -> tuple:
    """K1's stage-2 bodies at element tile et: DMMA in f64 at
    QP_DMMA_TILES only, HMMA in bf16 at QP_HMMA_TILES only, TF32 in f32 at
    QP_TF32_TILES only."""
    if itemsize == 8 and et in QP_DMMA_TILES:
        return ("simt", "dmma")
    if itemsize == 2 and et in QP_HMMA_TILES:
        return ("simt", "hmma")
    if itemsize == 4 and et in QP_TF32_TILES:
        return ("simt", "tf32")
    return ("simt",)


def qp_c12t_places(body, nrq, nkj) -> tuple:
    """Where C12T may live for a body at a shape: staged in shared memory,
    and for DMMA also held in registers where qp_dmma_takes; HMMA and TF32
    hold it in registers, where qp_hmma_takes or qp_tf32_takes (else
    none)."""
    if body == "hmma":
        return QP_C12T[1:] if qp_hmma_takes(nrq, nkj) else ()
    if body == "tf32":
        return QP_C12T[1:] if qp_tf32_takes(nrq, nkj) else ()
    return QP_C12T if body == "dmma" and qp_dmma_takes(nrq, nkj) else \
        QP_C12T[:1]


def qp_stage1_places(itemsize, et, g, depth, threads, body, where, nm0,
                     nrq, nkj) -> tuple:
    """Stage 1's bodies K1 is built for beside a setting: SIMT at the
    plane groups of QP_PLANE_GROUPS; DMMA alone at QP_S1_DMMA_FORM (its
    group of QP_S1_PLANES planes), in f64 beside DMMA with C12T held, where
    qp_s1_dmma_takes the shape; else none."""
    if g in QP_PLANE_GROUPS:
        return QP_STAGE1[:1]
    if (itemsize == 8 and (et, g, depth, threads) == QP_S1_DMMA_FORM
            and (body, where) == ("dmma", "regs")
            and qp_s1_dmma_takes(nm0, nrq, nkj)):
        return QP_STAGE1[1:]
    return ()


def qp_settings(itemsize, nm0, nrq, nq0, nkj, limit=SMEM_BLOCK) -> list:
    """Every QPConfig K1 is built for whose buffers fit `limit` bytes at
    a shape (benchmarks/kernel_blocks.py sweeps them); TF32's at its plane
    group only (qp_tf32_planes); the DMMA stage 1's at QP_S1_DMMA_FORM
    only (qp_stage1_places)."""
    return [QPConfig(et, g, d, t, b, c, s) for et in QP_TILES[itemsize]
            for g in (*QP_PLANE_GROUPS, QP_S1_PLANES)
            for b in qp_built_bodies(itemsize, et)
            if b != "tf32" or g == qp_tf32_planes(et)
            for d, t in qp_forms(itemsize, et, b)
            for c in qp_c12t_places(b, nrq, nkj)
            for s in qp_stage1_places(itemsize, et, g, d, t, b, c, nm0, nrq,
                                      nkj)
            if qp_smem(itemsize, et, g, nm0, nrq, nq0, nkj, d, b, c,
                       s) <= limit]


def qp_planes(et, nkj) -> int:
    """K1's plane group for tile et: 8 where the stage-2 micro-tiles of 4
    planes would keep at most half the block busy, else 4."""
    tiles = 4 * _round_up(nkj, QP_TK) // QP_TK * (et // QP_TE)
    return 8 if tiles <= QP_THREADS // 2 else 4


@functools.cache
def qp_config(itemsize, nm0, nrq, nq0, nkj, block_limit=SMEM_BLOCK,
              sm_limit=SMEM_SM):
    """K1's QPConfig for a shape: QP_MEASURED's where the sweep measured
    the shape and it fits one block's `block_limit` bytes; else depth 1 on
    the DMMA body in f64, C12T staged in shared memory, where C12T holds a
    whole m16n8k8 tile (nkj >= QP_MMA_M, nrq >= QP_MMA_K) and a tile of
    QP_DMMA_TILES fits, on the HMMA body in bf16, C12T held, where C12T
    holds a whole m16n8k16 tile (nkj >= QP_MMA_M, nrq >= QP_HMMA_K),
    qp_hmma_takes the shape and a tile of QP_HMMA_TILES fits, else on the
    SIMT body, with the largest tile of that body's, with qp_planes'
    group, whose buffers fit two blocks an SM of `sm_limit` bytes (each
    block also costs SMEM_RESERVED) while stage 1 keeps at least half the
    block busy (nrq * et / QP_TE positions), else the largest that fits
    one block; None if none fits.  Depth 2, and stage 1 on DMMA, are
    taken only where the sweep measured them faster."""
    cfg = QP_MEASURED.get((itemsize, nm0, nrq, nq0, nkj))
    if cfg and qp_smem(itemsize, cfg.et, cfg.planes, nm0, nrq, nq0, nkj,
                       cfg.depth, cfg.body, cfg.c12t,
                       cfg.stage1) <= block_limit:
        return cfg
    bodies = [("simt", QP_TILES[itemsize])]
    if itemsize == 8 and nkj >= QP_MMA_M and nrq >= QP_MMA_K:
        bodies.insert(0, ("dmma", QP_DMMA_TILES))
    if (itemsize == 2 and nkj >= QP_MMA_M and nrq >= QP_HMMA_K
            and qp_hmma_takes(nrq, nkj)):
        bodies.insert(0, ("hmma", QP_HMMA_TILES))
    for body, tiles in bodies:
        where = "regs" if body == "hmma" else "smem"
        sizes = {}
        for et in tiles:
            g = qp_planes(et, nkj)
            sizes[QPConfig(et, g, body=body, c12t=where)] = qp_smem(
                itemsize, et, g, nm0, nrq, nq0, nkj, 1, body, where)
        fits = [c for c, b in sizes.items() if b <= block_limit]
        two = [c for c in fits
               if 2 * (sizes[c] + SMEM_RESERVED) <= sm_limit
               and nrq * c.et // QP_TE >= QP_THREADS // 2]
        if fits:
            return (two or fits)[0]
    return None


@functools.cache
def qp_launch_config(itemsize, nm0, nrq, nq0, nkj, epb, planes,
                     block=SMEM_BLOCK, sm=SMEM_SM, depth=None,
                     threads=None, body=None, where=None,
                     stage1=None) -> QPConfig:
    """K1's QPConfig for a launch: the knobs `epb`, `planes`, `depth`,
    `threads`, `body`, `where` (C12T's place) and `stage1` (stage 1's
    body) where given, else qp_config's choice under the card's `block`
    and `sm` bytes of shared memory; with a given tile, qp_planes' group
    (the TF32 body's, qp_tf32_planes), depth 1 and the SIMT body unless
    given too, C12T where the body first may keep it (qp_c12t_places:
    staged but for HMMA and TF32) unless given or the choice's, and stage
    1 the choice's where the rest is the choice's, else the first body
    built beside the rest (qp_stage1_places); stage 1 "dmma" given takes
    QP_S1_PLANES planes unless planes are given too.
    Raises if the knobs are not the kernel's or the buffers do not fit."""
    tiles = QP_TILES[itemsize]
    if epb is not None and epb not in tiles:
        raise ValueError(f"qp_shared3d: epb={epb} is not one of the "
                         f"kernel's element tiles {tiles} for itemsize "
                         f"{itemsize}")
    if planes is not None and planes not in (*QP_PLANE_GROUPS,
                                             QP_S1_PLANES):
        raise ValueError(f"qp_shared3d: planes={planes} is not one of "
                         f"{(*QP_PLANE_GROUPS, QP_S1_PLANES)}")
    if epb is None:
        choice = (qp_config(itemsize, nm0, nrq, nq0, nkj, block, sm)
                  or QPConfig(None, None))
    else:
        choice = QPConfig(epb, qp_planes(epb, nkj))
    et, g, d, t, b, c, s1 = choice
    if body == "tf32" and b != "tf32" and et is not None:
        g = qp_tf32_planes(et)
    if stage1 == "dmma" and s1 != "dmma":
        g = QP_S1_PLANES
    g = planes or g
    depth = depth or d
    threads = threads or (t if depth == d else QP_THREADS)
    body = body or b
    places = qp_c12t_places(body, nrq, nkj)
    where = where or (c if body == b else (places or ("smem",))[0])
    if et is not None and (depth, threads) not in qp_forms(itemsize, et,
                                                           body):
        raise ValueError(f"qp_shared3d: depth={depth}, threads={threads} "
                         "is not one of the kernel's forms "
                         f"{qp_forms(itemsize, et, body)} at element tile "
                         f"{et}, itemsize {itemsize}, body={body!r}")
    if et is not None and body not in qp_built_bodies(itemsize, et):
        raise ValueError(f"qp_shared3d: body={body!r} is not one of the "
                         f"kernel's bodies {qp_built_bodies(itemsize, et)} "
                         f"at element tile {et}, itemsize {itemsize}")
    if body == "tf32" and et is not None and g != qp_tf32_planes(et):
        raise ValueError(f"qp_shared3d: planes={g} with body='tf32' at "
                         f"element tile {et}: its plane group has "
                         f"{QP_TF32_COLUMNS} columns, {qp_tf32_planes(et)} "
                         "planes")
    if where not in places:
        raise ValueError(f"qp_shared3d: where={where!r} is not one of "
                         f"{places} for body={body!r} at nrq={nrq}, "
                         f"nkj={nkj} (DMMA holds C12T in registers for nrq "
                         f"<= {QP_MMA_K * QP_MMA_STEPS}, HMMA for nrq <= "
                         f"{QP_HMMA_K * QP_HMMA_STEPS}, each for nkj <= "
                         f"{QP_MMA_M * QP_THREADS // 32}; TF32 for nrq <= "
                         f"{QP_TF32_K * QP_TF32_STEPS}, nkj <= {QP_TF32_M})")
    if et is not None:
        bodies1 = qp_stage1_places(itemsize, et, g, depth, threads, body,
                                   where, nm0, nrq, nkj)
        same = (et, g, depth, threads, body, where) == tuple(choice[:6])
        stage1 = stage1 or (s1 if same else (*bodies1, "simt")[0])
        if stage1 not in bodies1:
            raise ValueError(
                f"qp_shared3d: stage1={stage1!r} is not one of {bodies1} at "
                f"{(et, g, depth, threads, body, where)}, itemsize "
                f"{itemsize}, nm0={nm0}, nrq={nrq}, nkj={nkj} (stage 1 "
                f"runs on DMMA in f64 only, at (et, planes, depth, threads) "
                f"{QP_S1_DMMA_FORM} beside body='dmma' with C12T in "
                f"registers, for nm0 <= {QP_MMA_K * QP_S1_STEPS}; on SIMT at "
                f"planes {QP_PLANE_GROUPS})")
    if et is None or qp_smem(itemsize, et, g, nm0, nrq, nq0, nkj, depth,
                             body, where, stage1) > block:
        raise ValueError(f"qp_shared3d: element tile {epb or 'of any size'}"
                         f" of nm0*nrq = {nm0 * nrq} input rows and depth "
                         f"{depth} does not fit the card's {block} B of "
                         "shared memory")
    return QPConfig(et, g, depth, threads, body, where, stage1)


def _launch(x, b0, c12t, nrq, epb, planes, depth=None, threads=None,
            body=None, where=None, stage1=None):
    nm0, nq0 = b0.shape
    nkj = c12t.shape[0]
    e = x.shape[1]
    cfg = qp_launch_config(x.element_size(), nm0, nrq, nq0, nkj, epb,
                           planes, *build.smem_limits(x.get_device()), depth,
                           threads, body, where, stage1)
    if spans.profiler._is_profiler_enabled:
        key = build.key("qp_fused3d", x.dtype)
        out = spans.alloc((nq0 * nkj, e), x, key)
        with spans.span(f"tbt.launch.{key}"):
            _launch_probe(x, b0, c12t, out, nrq, cfg)
    else:
        out = torch.empty((nq0 * nkj, e), dtype=x.dtype, device=x.device)
        build.run("qp_fused3d", x, x.data_ptr(), b0.data_ptr(),
                  c12t.data_ptr(), out.data_ptr(), nm0, nrq, nq0, nkj, e,
                  *cfg[:4], qp_entry_body(cfg))
    qp_depths[cfg.depth] += 1
    qp_bodies[(build.SUFFIXES[x.dtype], cfg.body)] += 1
    qp_stage1_bodies[(build.SUFFIXES[x.dtype], cfg.stage1)] += 1
    if cfg.body == "dmma":
        qp_dmma_c12t[cfg.c12t] += 1
    return out


def _launch_probe(x, b0, c12t, out, nrq, cfg):
    """K1's launch at `cfg` through its probe entry
    (tbt_qp_fused3d_probe_<dtype>) on the device's probe buffer, counted
    in build.launches under K1's key."""
    nm0, nq0 = b0.shape
    nkj, e = c12t.shape[0], x.shape[1]
    probe = _qp_probe(x, -(-e // cfg.et))
    err = build.call(build.entry("qp_fused3d_probe", x.dtype), x,
                     x.data_ptr(), b0.data_ptr(), c12t.data_ptr(),
                     out.data_ptr(), nm0, nrq, nq0, nkj, e, *cfg[:4],
                     qp_entry_body(cfg),
                     probe.words.data_ptr(), probe.launches, probe.capacity)
    build.launched(err, build.key("qp_fused3d", x.dtype))
    if e:  # no block ran on no element
        probe.launches += 1


def _qp_probe_words(capacity) -> int:
    """Words of a probe buffer that holds `capacity` block records."""
    return (QP_PROBE_HEAD + QP_PROBE_ROWS * len(QP_PHASES)
            + 2 * QP_PROBE_LAUNCHES + QP_PROBE_RECORD * capacity)


def _qp_probe(x, blocks) -> QPProbe:
    """x's device's probe buffer, made zeroed on the device's first probed
    launch, and grown (its head, totals and spans kept) where a launch of
    `blocks` blocks would outgrow its block records."""
    index = x.get_device()
    probe = qp_probes.get(index)
    if probe is not None and blocks <= probe.capacity:
        return probe
    capacity = max(blocks, QP_PROBE_MIN_RECORDS,
                   2 * probe.capacity if probe else 0)
    words = torch.zeros(_qp_probe_words(capacity), dtype=torch.int64,
                        device=x.device)
    launches = 0
    if probe is not None:
        kept = _qp_probe_words(0)
        words[:kept] = probe.words[:kept]
        launches = probe.launches
    probe = qp_probes[index] = QPProbe(words, capacity, launches)
    return probe


def qp_probed(in_pflat, b0, c12t, *, nrq):
    """qp_shared3d_flat at qp_config's choice through K1's probe form,
    whether or not a profiler records, on the device's probe buffer: the
    probe's cost beside the plain form (benchmarks/kernel_blocks.py
    --probe).  CUDA tensors only."""
    _check(in_pflat, b0, c12t, nrq)
    if not in_pflat.is_cuda:
        raise ValueError("qp_probed: K1's probe form runs on a CUDA device")
    nm0, nq0 = b0.shape
    nkj, e = c12t.shape[0], in_pflat.shape[1]
    cfg = qp_launch_config(in_pflat.element_size(), nm0, nrq, nq0, nkj, None,
                           None, *build.smem_limits(in_pflat.get_device()))
    out = torch.empty((nq0 * nkj, e), dtype=in_pflat.dtype,
                      device=in_pflat.device)
    _launch_probe(in_pflat, b0, c12t, out, nrq, cfg)
    return out


def qp_phases(device=None) -> dict | None:
    """K1's probe readings on the CUDA device of index `device` (None: the
    current device) as plain numbers (qp_probe_reduce); None where no
    probed launch ran there.  It waits for the device and copies the
    buffer to the host, so it never runs on the launch path."""
    if not qp_probes:
        return None
    index = torch.cuda.current_device() if device is None else device
    probe = qp_probes.get(index)
    if probe is None or not probe.launches:
        return None
    return qp_probe_reduce(probe.words.cpu().tolist(), probe.launches)


def qp_probe_reduce(words, launches) -> dict:
    """A probe buffer's words (int64, the card's unsigned 64-bit words as
    read back) after `launches` probed launches:

        launches  the probed launches;
        cycles    {phase of QP_PHASES: SM cycles summed over the blocks of
                  every probed launch};
        spans     [(first block's start, last block's exit)] in ns of
                  %globaltimer, of the newest min(launches,
                  QP_PROBE_LAUNCHES) launches, oldest first;
        grid, slots  the newest launch's blocks and resident block slots
                  (the occupancy API's blocks an SM times the SMs);
        blocks    [(start ns, exit ns, SM, cycles)] of the newest launch's
                  blocks, by block index, as many as the buffer holds."""
    def word(i):
        return words[i] % _WORD

    phases = len(QP_PHASES)
    cycles = {phase: sum(word(QP_PROBE_HEAD + r * phases + k)
                         for r in range(QP_PROBE_ROWS))
              for k, phase in enumerate(QP_PHASES)}
    ring = QP_PROBE_HEAD + QP_PROBE_ROWS * phases
    spans_ns = []
    for n in range(max(0, launches - QP_PROBE_LAUNCHES), launches):
        at = ring + 2 * (n % QP_PROBE_LAUNCHES)
        spans_ns.append((_WORD - 1 - word(at), word(at + 1)))
    records = ring + 2 * QP_PROBE_LAUNCHES
    held = min(word(0), (len(words) - records) // QP_PROBE_RECORD)
    blocks = [(word(at), word(at + 1), word(at + 3), word(at + 2))
              for at in range(records, records + QP_PROBE_RECORD * held,
                              QP_PROBE_RECORD)]
    return {"launches": launches, "cycles": cycles, "spans": spans_ns,
            "grid": word(0), "slots": word(1), "blocks": blocks}


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
