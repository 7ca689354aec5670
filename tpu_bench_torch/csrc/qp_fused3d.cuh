// K1 qp_fused3d: the fused 3D sum-factorization of benchmark05's BwdTrans.
// Its entries: csrc/bwdtrans3d.cu (tbt_qp_fused3d_<dtype>) and, for its
// probe form, csrc/qp_fused3d_probe.cu (tbt_qp_fused3d_probe_<dtype>),
// each its own nvcc process.
//
// Replaces the Pallas kernels tpu_bench/kernels/bwdtrans3d.py:qp_shared3d
// (_qp_fused_kernel3d) and qp_shared3d_flat (_qp_fused_flat_kernel3d).  Both
// hand over the same contiguous bytes, read here as in (nm0*nrq, E) and
// written as out (nq0*nkj, E), element index fastest:
//
//   out[i*nkj + kj, e] = sum_rq C12T[kj, rq] * sum_p B0[p, i] * in[p*nrq + rq, e]
//
// with nrq = nm2*nm1 and nkj = nq2*nq1 (49 and 64 at nq=8^3).
//
// It also serves benchmark04's Pallas(QP/Shared) column: the 2D
// sum-factorization is the same contraction with nrq = nm1, nkj = nq1 and
// C12T = B1^T, so one kernel replaces tpu_bench/kernels/bwdtrans2d.py:
// qp_shared, qp_w, qp_w_flat and qp_mxu_grouped, whose differences were TPU
// sublane and MXU-tile geometry.
//
// What bounds it on an H100: each element streams nm0*nrq values in and
// nq0*nkj out exactly once (343 + 512 at nq=8^3) and takes
// 2*nq0*nrq*(nm0 + nkj) FLOP (55,664 at nq=8^3).  Against 3.35 TB/s and
// FP32's 67 TFLOP/s the bytes bound it at every order (b05 8^3 f32: 0.134
// ms by bytes, 0.109 by FLOP; b04 32^2: 2.49 and 1.87), but only just, so
// the design must both read the input once and keep the FMA pipes fed; the
// tensor cores are not needed to reach the bound.
//   - A block copies a tile of ET elements' whole input slab (nm0*nrq
//     rows x ET) into shared memory once, by 16-byte cp.async along e
//     where every row starts on a 16-byte boundary (else one element a
//     copy), zero-filling past E.  The first
//     design gave each element a thread that re-read its input from L2
//     once per output plane (4 times at 8^3, 16 at b04 32^2): 0.88 ms at
//     8^3 and 52 ms at 32^2 in f32, 6.6x and 21x its bound.
//   - Stage 1 forms V = sum_p B0[p, i] * slab[p] for G planes (4 or 8) at
//     once: a thread owns 4 consecutive elements of one rq row, so each
//     16-byte shared load of the slab serves 4*G FMAs.
//   - Stage 2 is the GEMM C12T (nkj x nrq) @ V_i (nrq x ET) for those
//     planes, with 8 kj x 4 e register micro-tiles: two 16-byte loads of
//     C12T^T (kept transposed, nkj padded to 8) and one of V per rq feed
//     32 FMAs; the micro-tiles of the G planes are spread over the block,
//     e fastest.  G = 8 where 4 planes would leave half the block without
//     a micro-tile (b04 32^2, nkj = 32).  8 x 8 micro-tiles in f32 ran
//     slower than 8 x 4 at every order swept (benchmarks/kernel_blocks.py
//     on that variant, since dropped).
//   - Each output row segment is written once from registers, 16-byte
//     stores along e where aligned, masked past E.
//   - The slab ring.  At depth 1 a block of 256 threads owns one tile and
//     waits for its whole slab before it computes; only the other blocks
//     on the SM hide the copy and the stores.  At b05 8^3 in f64 (16
//     elements, 8 planes: 119,616 B) one block fills an SM, so nothing
//     hid them.  At depth 2 the grid is one wave (the occupancy API's
//     blocks an SM times the SMs) of persistent blocks with two slab slots
//     each: a block takes element tiles one after another from a counter
//     in device memory (the stream's counter of csrc/ring.cuh, which the
//     last block to finish sets back to zero), and copies tile j+1's slab
//     into the other slot (cp.async, a commit group a tile, wait_group 1)
//     while it computes tile j and stores its outputs.  The index runs two
//     tiles ahead: thread 0 takes the first two before the loop, and at
//     the top of tile j's iteration, before its share of tile j+1's copy,
//     one atomicAdd for tile j+2, whose result it keeps in a register and
//     stores into tile j's slot word only before the closing barrier of
//     tile j's last plane group (QPAhead, qp_publish); the word is first
//     read after that barrier, at tile j+1's start.  So no warp waits on
//     the atomic's round trip, which returns behind the SM's cp.async
//     requests for the next slab: stored right after the wait's barrier,
//     it held warp 0, and at stage 1's barrier the block.  Measured
//     flushed (kernel_blocks --only k1 --probe; NVIDIA H100 80GB HBM3,
//     700 W), thread 0's share of the block outside the probe's phases
//     fell from 21.9 to 7.1% at b05 8^3 f32, 14.7 to 2.9% at 8^3 f64 and
//     30.8 to 23.3% at 10^3 f64, and K1 ran 3.6-6.4% faster there.  A
//     slot is refilled only after the barrier that ends its tile; B0 and
//     C12T^T are staged once a block.  Blocks of 256 or 512
//     threads, 128 registers a thread either way, but for f64's depth-2
//     blocks (256 threads, one an SM), which spilled at 128.  Measured at
//     b05 8^3 with calls back to back (port_bench; NVIDIA H100 80GB HBM3,
//     700 W): a 16-element f64 tile took an SM 13.2 us at depth 1 and 9.9
//     us at depth 2 (its bytes alone 4.3 us, its FMAs 3.5 us); in f32 a
//     32-element tile took 11.7 us at depth 1, two 16-element tiles 9.2 us
//     at depth 2 (two blocks an SM).
//   - kernels/bwdtrans3d.qp_config picks (ET, G, depth, threads, body): the
//     fastest of benchmarks/kernel_blocks.py's sweep at the benchmarks'
//     main orders (QP_MEASURED), else depth 1 with the largest tile that
//     fits two blocks an SM, else one.  Full FP32/FP64 FMA throughout.
//   - bf16 (benchmarks 04 and 05 with --dtype bf16): the slab, V, C12T
//     and B0 are stored in bf16 and widened to f32 on load, every sum is
//     f32, and V is rounded to bf16 when it is stored, before stage 2,
//     where the JAX kernel rounds its f32 v (bwdtrans3d.py:90); each
//     output is rounded once.  The bf16 bytes halve the bound (0.067 ms
//     at b05 8^3 against 0.134 in f32), but on the SIMT body, which widens
//     each value it loads, bf16 took f32's time (0.2742 ms at b05 8^3, E =
//     131,072, flushed), stage 2 half of each block.  Stage 2's operands
//     are exactly bf16, so it runs on the bf16 tensor cores (QP_HMMA,
//     qp_stage2_hmma): mma.sync.m16n8k16 with f32 sums, whose products of
//     two bf16 values are exact in f32; only the order of the f32 sums in
//     a 16-deep k step differs from the SIMT body's, a few f32 ulps under
//     the one bf16 rounding of each output.  C12T is held in registers as
//     each warp's A fragments (as QP_DMMA_HELD, below: QP_HMMA_STEPS k
//     steps, 24 registers a lane), and a stage 1 of its own
//     (qp_stage1_pairs) stores V in pair rows (qp_h_col), so that one
//     16-byte shared load gives a lane its B registers of four n tiles and
//     the products leave it 8 neighbouring outputs of a row, one 16-byte
//     st.global.cs.  qp_config takes it where C12T fills an m16n8k16 tile
//     (nkj >= 16, nrq >= 16) and qp_hmma_takes the shape; it is built at
//     depth 1 and in the ring, in blocks of 256 threads (its 512-thread
//     ring was its slowest form at every order).  Measured (NVIDIA H100
//     80GB HBM3, 700 W): at b05 8^3, E = 131,072, 0.1158-0.1183 ms
//     flushed (57% of the bytes bound); at the cell's 1,048,576 elements
//     back to back (64, 4, 1) took 0.8055-0.8278 ms a call against
//     SIMT's 1.9719 (bytes 0.5352); at 10^3, E = 524,288, (32, 4, 1)
//     1.1358-1.1509 against the SIMT ring's 3.6362-3.8224; at b04 32^2,
//     E = 1,048,576, 3.3100 flushed against SIMT's 4.3414.
//   - f64 at b05 10^3: the operations, not the bytes, bound the SIMT form.
//     An element takes 2*nq0*nrq*(nm0 + nkj) = 176,580 FLOP, 162,000 of
//     them (92%) in stage 2, 92.6 GFLOP a call of 524,288 elements: 2.76
//     ms at FP64's 33.5 TFLOP/s on the CUDA cores, above its 2.165 ms of
//     bytes.  The SIMT micro-tile ran it at 8.0 TFLOP/s (11.5 ms a call;
//     a 16-element tile took an SM 46.4 us against 8.7 of bytes): its
//     shared-memory loads match its FMAs, and one block of 8 warps an SM
//     hides no latency.  So in f64 stage 2 runs on sm_90's DMMA
//     (mma.sync.m16n8k8 on f64, 66.7 TFLOP/s, IEEE FP64 FMAs as the SIMT
//     body's; qp_stage2_dmma).  Stage 1, 2*nq0*nrq*nm0 FLOP an element,
//     stays SIMT where it is a small share (8% at 10^3, 10% at b05 8^3),
//     but not at b04 32^2 (49%; below).  The body is a template
//     argument; kernels/bwdtrans3d.qp_config picks it from the shape
//     (QP_MEASURED, else DMMA in f64 where nkj >= 16, nrq >= 8 and the
//     body serves the shape); f32 takes 3xTF32 on wgmma where QP_MEASURED
//     names it (below).  Its first form staged C12T in
//     shared memory (nkj padded to 112 rows of 88 values at 10^3) and
//     padded V's rows to 8 and to ET + 2 values: 5.37 ms at b05 10^3, E =
//     524,288 (L2 flushed), a tile 21.6 us an SM, whose slab copy,
//     products and stores took turns in the one depth-1 block an SM, as no
//     ring fitted beside those buffers (317,040 B).
//   - C12T in registers, so that the ring fits at 10^3 f64 (QP_DMMA_HELD).
//     Each warp holds one m tile (16 kj rows) of C12T as its m16n8k8 A
//     fragments, QP_MMA_STEPS = 11 k steps of 4 values, 88 registers a
//     lane, read once a block from global memory and live for every tile
//     the block takes; rows past nkj and columns past nrq are zero.  Warp
//     w holds m tile w mod the m tiles and takes only that tile's units
//     (at 10^3, 7 m tiles for 8 warps: warps 0 and 7 share m tile 0).  A
//     lane then loads only V from shared memory: 8 values a k step of a
//     unit, where it loaded 12 with C12T staged.  V, in either DMMA form,
//     is nrq x ET a plane, unpadded, its 16-byte words XORed with rq mod 8
//     (qp_v_col), and the last k step, partial where nrq is no multiple of
//     8, reads rows past nrq as zero in registers.  The block loses C12T's
//     buffer and V's padding: at 10^3 (16, 4) the ring's two slabs fit,
//     228,976 B of 232,448.  The held form serves nrq <= 88 and nkj <= 128
//     (qp_dmma_takes: every b05 order to 10^3, b04 to 32^2), one block an
//     SM, 197-236 registers a thread and no spill ((16, 4, 2): 232).
//     Measured (NVIDIA H100 80GB HBM3, 700 W; L2 flushed, least of 20):
//     at b05 10^3, E = 524,288, the staged form's 5.36-5.98 ms went to
//     4.48-4.53 held at depth 1 and 4.20-4.33 in the ring; at b04 32^2 in
//     f64, E = 524,288, 5.35-5.39 to 4.81 held.  Where C12T is small and
//     the staged form's blocks (at most 128 registers) run two an SM, it
//     stays faster (b05 6^3: 0.156 ms against 0.180 held; b04 16^2: 1.517
//     against 1.929), so both forms are built and qp_config picks one by
//     the shape (QP_MEASURED), as it picks the depth.
//   - f64 stage 1 on DMMA (QP_DMMA_S1, qp_stage1_dmma): at b04 32^2 stage
//     1 (nm0 = 31) is 61,504 of an element's 124,992 FLOP, and the SIMT
//     form, a thread an rq row by 4 elements, gave 124 work items to 256
//     threads: 46.5% of the held DMMA form's block (the probe).  On DMMA
//     each rq row's V^T (16 elements x 16 planes) is one m tile by two n
//     tiles of m16n8k8 products over k = p (4 steps, p = 31 zero in
//     registers), a warp a row at a time, its A fragments two 16-byte
//     loads a step from slab rows padded to 18 values (qp_slab_ld), its
//     sums stored into V at qp_v_col_s1, which stage 2 reads as it reads
//     qp_v_col.  That stage alone took a call at b04 32^2, E = 524,288,
//     from 4.87 to 4.38 ms (flushed; NVIDIA H100 80GB HBM3, 700 W): at
//     depth 1 the one block an SM then waits longer for its slab than it
//     computes (wait 36% of the block).  Its blocks are therefore
//     persistent (a one-wave grid on the stream's counter, as the ring's)
//     with one slab slot, whose next slab is copied as soon as the last
//     plane group's stage 1 has read the slab (QPNext): the copy runs
//     under that group's stage 2 and its stores, which groups of 16
//     planes make half of stage 2 (V 63.5 KB; slab 138 KB; 209,824 B a
//     block, where two slabs, 276 KB, fit no ring).  Measured at b04 32^2,
//     E = 524,288 (kernel_blocks --only k1 --back-to-back): 3.4008 /
//     3.4014 ms flushed and 3.4269 / 3.4317 back to back, against the held
//     DMMA form's 4.8505 / 4.8465 and 4.8788 / 4.8780, the card at its
//     700 W cap (SM clock 1575-1965 MHz; 1980 MHz and 660 W before); in
//     the cell quad32-f64-qp (port_bench, ten seeds) gdof_s 101.90-102.81
//     -> 147.80-148.86 and call_ms_p95 4.99-5.18 -> 3.44-3.58 ms.
//     qp_config takes it only where QP_MEASURED names it (b04 32^2); at
//     b05 8^3 it swept faster than the rule's ring (0.3728 / 0.3726
//     against 0.4010 / 0.3986 ms flushed at E = 131,072), a candidate left
//     to a run at the cell's size; 220 registers, no spill.
//   - f32 at b05 8^3: the FP32 lanes, not the bytes, bound the SIMT form.
//     Stage 2 takes 2*nq0*nrq*nkj = 50,176 of an element's 55,664 FLOP,
//     6.58 GFLOP a call of 131,072 elements, 0.11 ms at the lanes' 59
//     TFLOP/s under the 700 W cap; with stage 1, 93% of the 0.134 ms of
//     bytes.  The SIMT body ran stage 2 at about 34 TFLOP/s, 69% of each
//     block (the probe), and K1 at 49% of its bytes bound.  So stage 2
//     runs as 3xTF32 on wgmma (QP_TF32, qp_stage2_tf32): C12T and V each
//     split into big (rounded to TF32) and small halves (tbt::split_tf32),
//     and small*big + big*small + big*big summed in f32, which keeps the
//     f32 result (K2's f32 dense body does the same; one TF32 pass would
//     miss the benchmark's limit 60-fold).  Three products a k step and
//     k padded 49 -> 56 ask 3.4x the lanes' work of the units, which
//     K2's wgmma body runs at about 310 TFLOP/s (mma.sync's 3xTF32 about
//     120).  C12T (nkj = 64 rows: one m64 tile) is held in registers as
//     both halves of the A fragments, 56 registers a lane, split once a
//     block; a stage 1 of its own (qp_stage1_tf32) stores V's halves
//     K-major (qp_tf32_col), as tf32 wgmma reads B; a plane group is 128
//     columns, (16, 8) or (32, 4), and each of the block's two warp
//     groups takes 64 of them, m64n64k8 products into 32 f32 sums a lane,
//     so that two blocks fit an SM at 128 registers (124-128, no spill; a
//     stage 1 of more sums a thread, or a k step's wgmma behind a branch,
//     which ptxas serializes, spilled or ran slower).  The units' sums
//     truncate, so the small products of every k step go first and the
//     seven big ones after (within 3.3e-7 of f64 at 8^3 in emulation,
//     against 7.1e-7 for K2's order, a k step's three products together;
//     on the card 3.46e-7 against SIMT's 3.34e-7).  Stage 1 stays SIMT,
//     the stores st.global.cs.  Measured at b05 8^3, E = 131,072 (NVIDIA
//     H100 80GB HBM3, 700 W): (32, 4, 1) 0.2056-0.2061 ms flushed and
//     0.2008-0.2032 back to back, against the SIMT ring's 0.2804-0.2810
//     and 0.2716-0.2734; of its block, stage 1 took 29%, stage 2 31% and
//     the wait for the slab 33% (the probe).  Built for (16, 8) and (32,
//     4) at depth 1 and in the ring, in f32 only, where qp_tf32_takes
//     (nrq <= 56, nkj <= 64: b05 to 8^3, b04 to 32^2); qp_config takes it
//     only where QP_MEASURED names it (b05 8^3: at every other f32 order
//     swept, whose C12T fills at most 36 of the m64 tile's rows, SIMT
//     stayed faster).
//   - The probe form (template argument P = true; kernels/bwdtrans3d.py
//     launches it only while a torch profiler records): the threads read
//     the SM's clock right after barriers the kernel already has, and sum
//     per block the cycles of its phases (QPPhase): the block, from its
//     first instruction to its exit; the wait, at depth 2 each tile from
//     the loop's top to the barrier after cp.async.wait_group 1 (the time
//     its slab had not arrived), at depth 1 from the block's start to the
//     barrier after its whole load (copy, operator staging and wait), for
//     the DMMA stage 1's persistent blocks from the loop's top to the
//     barrier after cp.async.wait_group 0; stage 1 of each plane group, to
//     the barrier after it (for the DMMA stage 1's last group, also the
//     issue of the next tile's copy after that barrier); and stage 2,
//     stores included, to the group's closing barrier.  A stamp adds the
//     clock to the sum of the phase it closes and takes it from the one it
//     opens, in four registers (QPSums, exact below 2^32 cycles, about 2 s
//     a block), every thread alike, so it takes no branch and no memory
//     access.  At its exit thread 0 adds the block's sums to the buffer's
//     totals (64-bit atomics, a row of totals for the SMs of one residue
//     modulo QP_PROBE_ROWS) and writes its record of the newest launch:
//     its cycles and SM, and, for a block of the first or last wave of
//     resident slots (qp_timed), its %globaltimer at start and exit, which
//     hold the launch's span.  The probe adds no barrier and no shared
//     memory, and keeps the plain form's blocks an SM (qp_probe_min_blocks;
//     chip_smoke.py holds the cells' instances to it).  Measured
//     (kernel_blocks --only k1 --probe; NVIDIA H100 80GB HBM3, 700 W): the
//     probe form ran within -2.0 to +1.4% of the plain form's flushed time
//     at the five qp cells' shapes; with its sums or clocks in shared
//     memory, 1-10% slower.  With P = false the kernel is the one above,
//     instruction for instruction.
// Later work: TMA for the slab.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int QP_THREADS = 256;  // the block of the depth-1 form
constexpr int QP_TK = 8;  // kj rows of a stage-2 micro-tile
constexpr int QP_TE = 4;  // elements of a micro-tile (16 or 32 bytes)
// In front of a depth-2 block's buffers: the tiles its two slots hold
// (two long longs, so the buffers stay on 16-byte boundaries).
constexpr int QP_SLOT_TILES_BYTES = 16;

__host__ __device__ constexpr int round_up(int n, int m) {
    return (n + m - 1) / m * m;
}

// Stage 2's bodies (kernels/bwdtrans3d.QP_BODIES): the SIMT micro-tiles,
// or in f64 sm_90's DMMA, on m16n8k8 tiles of QP_MMA_M kj rows, 8
// elements and QP_MMA_K rq, a warp's unit one m tile by QP_MMA_PAIRS pairs
// of n tiles (16 elements a pair).  C12T's A fragments are staged in
// shared memory (QP_DMMA) or held in registers (QP_DMMA_HELD): each warp
// keeps one m tile's, QP_MMA_STEPS k steps of them, so the held form
// serves nrq <= QP_MMA_K * QP_MMA_STEPS and nkj <= QP_MMA_M * warps
// (kernels/bwdtrans3d.qp_dmma_takes).  In bf16 the bf16 tensor cores
// (QP_HMMA): m16n8k16 tiles of QP_MMA_M kj rows, 8 elements and QP_HMMA_K
// rq, with f32 sums, C12T held as in QP_DMMA_HELD, QP_HMMA_STEPS k steps a
// lane (kernels/bwdtrans3d.qp_hmma_takes).
// In f32 3xTF32 on wgmma (QP_TF32): m64nNk8 products of C12T (one m tile
// of QP_TF32_M kj rows, its A fragments held in registers as big and small
// halves, QP_TF32_STEPS k steps of QP_TF32_K rq) by V's halves in shared
// memory, each of a block's two warp groups QP_TF32_N columns of a plane
// group (kernels/bwdtrans3d.qp_tf32_takes).
// QP_DMMA_S1 is QP_DMMA_HELD with stage 1 on DMMA too (qp_stage1_dmma):
// m16n8k8 products of each rq row's slab (16 elements by QP_S1_STEPS k
// steps of p) by B0's QP_S1_PLANES planes, a warp a row at a time, the
// slab's rows padded by QP_S1_PAD values (qp_slab_ld); its
// blocks are persistent, with one slab slot that takes the next tile's
// slab as soon as the last plane group's stage 1 is done (QPNext).  Built
// at (16, QP_S1_PLANES, 1, QP_THREADS) alone
// (kernels/bwdtrans3d.qp_s1_dmma_takes).
enum QPBody : int {
    QP_SIMT = 0,
    QP_DMMA = 1,
    QP_DMMA_HELD = 2,
    QP_HMMA = 3,
    QP_TF32 = 4,
    QP_DMMA_S1 = 5
};
constexpr int QP_MMA_M = 16;
constexpr int QP_MMA_K = 8;
constexpr int QP_MMA_PAIRS = 2;
constexpr int QP_MMA_STEPS = 11;
constexpr int QP_HMMA_K = 16;
constexpr int QP_HMMA_STEPS = 6;
constexpr int QP_TF32_M = 64;
constexpr int QP_TF32_K = 8;
constexpr int QP_TF32_STEPS = 7;
constexpr int QP_TF32_N = 64;
constexpr int QP_S1_STEPS = 4;
constexpr int QP_S1_PAD = 2;
constexpr int QP_S1_PLANES = 16;

// What a thread holds of C12T from tile to tile: the held form's A
// fragments; nothing where C12T is staged in shared memory.
template <QPBody B>
struct QPHeld {};

template <>
struct QPHeld<QP_DMMA_HELD> {
    double a[QP_MMA_STEPS][4];
};

template <>
struct QPHeld<QP_DMMA_S1> : QPHeld<QP_DMMA_HELD> {};

template <>
struct QPHeld<QP_HMMA> {
    unsigned a[QP_HMMA_STEPS][4];  // two bf16 a register
};

template <>
struct QPHeld<QP_TF32> {
    unsigned big[QP_TF32_STEPS][4];    // C12T rounded to TF32
    unsigned small[QP_TF32_STEPS][4];  // the rest, truncated by the units
};

// DMMA's V (either form), nrq x ET a plane with no padding: element e of row rq lies at
// column e ^ 2 (rq % 8), the row's 16-byte words XORed with rq % 8, so a
// quarter warp's 16-byte B loads (rows 2t + r of a k step, words g ^ (2t
// + r)) and stage 1's stores (two rows, every other word) hit distinct
// banks.
__host__ __device__ constexpr int qp_v_col(int rq, int e) {
    return e ^ ((rq & 7) << 1);
}

// The DMMA stage 1's V (QP_DMMA_S1): element e of row rq of plane g (of
// the group) at qp_v_col's column, its 16-byte word also XORed with 2 (g /
// 2 % 4), so that the stage's 16-byte stores of a quarter warp (planes 8n
// + 2t and 8n + 2t + 1 of one row, words g = 0, 1) hit distinct banks.
// Stage 2's loads each read one plane, so a constant more in the XOR keeps
// them as qp_v_col's.
__host__ __device__ constexpr int qp_v_col_s1(int g, int rq, int e) {
    return qp_v_col(rq, e) ^ ((g >> 1 & 3) << 2);
}

// A slab row's values in shared memory: et, and QP_S1_PAD more for the
// DMMA stage 1, whose A loads of a quarter warp lie p = 2t apart (t =
// 0..3), 2 nrq rows: at 18 values a row that is 4t nrq mod 16 values,
// distinct banks where nrq is odd (every b05 and b04 order of even nq;
// at 16 values a row, t = 0..3 on the same banks).
__host__ __device__ constexpr int qp_slab_ld(QPBody b, int et) {
    return et + (b == QP_DMMA_S1 ? QP_S1_PAD : 0);
}

// HMMA's V, round_up(nrq, 2) x ET values a plane, in pair rows: pair row
// pr holds rows 2pr and 2pr + 1 of V as one 32-bit word an element (the
// even row in the low half, the odd one zero past nrq), so that a word is
// one register of an m16n8k16 B fragment.  Element e of pair row pr lies
// at word qp_h_col(pr, e): its 16-byte words (4 elements each) are XORed
// with 2 (pr % 4), or 2 (pr % 4 / 2) where a pair row holds 4 words (ET =
// 16), so a quarter warp's 16-byte B loads (pair rows t = 0..3, words g =
// 0, 1 or 2, 3 of a k step) and stage 1's 8-byte stores hit distinct
// banks.
template <int ET>
__host__ __device__ constexpr int qp_h_col(int pr, int e) {
    constexpr int W = ET / 4 < 8 ? ET / 4 : 8;  // a pair row's words, to 8
    return e ^ (2 * ((pr & 3) * W / 8) << 2);
}

// The TF32 body's V: two halves (big, then small) of QP_TF32_K *
// QP_TF32_STEPS rows (zero past nrq) by the plane group's N = G ET
// columns, K-major as tf32 wgmma reads B: k group kg (rq 4kg .. 4kg + 3)
// holds N rows of 16 bytes, column n's at (kg N + n) 16 bytes, so that its
// core matrices (8 columns by 4 rq, 128 contiguous bytes, which a
// descriptor read takes whole) lie SBO = 128 bytes apart along n and LBO
// = 16 N along k.  Columns g ET .. g ET + ET - 1 are plane g's, and
// element e of a plane lies at column qp_tf32_col(e): within each 16,
// element 4t + 2j + r at column 8j + 2t + r, so that lane 4g + t of the
// m64n64 products holds elements 4t .. 4t + 3 of a row, one 16-byte
// store.
__host__ __device__ constexpr int qp_tf32_col(int e) {
    return (e & ~15) | (e & 2) << 2 | (e & 12) >> 1 | (e & 1);
}

// V's rows a plane: nrq, HMMA's in whole pairs.
__host__ __device__ constexpr int qp_v_rows(QPBody b, int nrq) {
    return b == QP_HMMA ? round_up(nrq, 2) : nrq;
}

// V's values for g planes of et elements: qp_v_rows a plane, TF32's two
// halves of QP_TF32_STEPS k steps whatever nrq.
__host__ __device__ constexpr size_t qp_v_size(QPBody b, int g, int nrq,
                                               int et) {
    return b == QP_TF32
               ? static_cast<size_t>(2 * QP_TF32_STEPS * QP_TF32_K * g * et)
               : static_cast<size_t>(g) * qp_v_rows(b, nrq) * et;
}

// The staged DMMA form's C12T row stride: nrq padded to QP_MMA_K, then to
// 8 mod 16 values, so the A fragments' 16-byte loads of a quarter warp
// hit distinct banks.
__host__ __device__ constexpr int qp_lda(int nrq) {
    const int kp = round_up(nrq, QP_MMA_K);
    return kp % 16 ? kp : kp + 8;
}

// C12T's buffer in shared memory: C12T^T (nrq x nkj padded to QP_TK) for
// SIMT, C12T (nkj padded to QP_MMA_M rows of qp_lda values, zero past nkj
// and nrq) for the staged DMMA form, none for the held ones.
__host__ __device__ constexpr int qp_c_size(QPBody b, int nrq, int nkj) {
    return b == QP_DMMA_HELD || b == QP_DMMA_S1 || b == QP_HMMA ||
                   b == QP_TF32
               ? 0
           : b == QP_DMMA    ? round_up(nkj, QP_MMA_M) * qp_lda(nrq)
                             : nrq * round_up(nkj, QP_TK);
}

// Dynamic shared memory of one block: `depth` slabs (nm0 nrq rows of
// qp_slab_ld), V for G planes (qp_v_size), C12T's buffer and B0 (nm0 x
// nq0 padded to G), each a whole number of 16-byte words; at depth 2, and
// for the DMMA stage 1's persistent blocks, the slots' tiles first.
template <typename T>
size_t qp_smem_bytes(int et, int g, int nm0, int nrq, int nq0, int nkj,
                     int depth, QPBody body) {
    return (depth > 1 || body == QP_DMMA_S1 ? QP_SLOT_TILES_BYTES : 0) +
           sizeof(T) *
               (static_cast<size_t>(depth) * nm0 * nrq *
                    qp_slab_ld(body, et) +
                qp_v_size(body, g, nrq, et) +
                static_cast<size_t>(qp_c_size(body, nrq, nkj)) +
                static_cast<size_t>(nm0) * round_up(nq0, g));
}

// Whether the held DMMA form serves a shape: at most one m tile of C12T a
// warp of the block's QP_THREADS, and nrq within the k steps a lane holds.
__host__ __device__ constexpr bool qp_dmma_takes(int nrq, int nkj) {
    return nrq <= QP_MMA_K * QP_MMA_STEPS &&
           round_up(nkj, QP_MMA_M) / QP_MMA_M <= QP_THREADS / 32;
}

// Whether the DMMA stage 1 serves a shape: the held DMMA form's, and nm0
// within its QP_S1_STEPS k steps.
__host__ __device__ constexpr bool qp_s1_dmma_takes(int nm0, int nrq,
                                                    int nkj) {
    return qp_dmma_takes(nrq, nkj) && nm0 <= QP_MMA_K * QP_S1_STEPS;
}

// Whether the HMMA body serves a shape: as qp_dmma_takes, with nrq within
// QP_HMMA_STEPS k steps of QP_HMMA_K.
__host__ __device__ constexpr bool qp_hmma_takes(int nrq, int nkj) {
    return nrq <= QP_HMMA_K * QP_HMMA_STEPS &&
           round_up(nkj, QP_MMA_M) / QP_MMA_M <= QP_THREADS / 32;
}

// Whether the TF32 body serves a shape: C12T within its one m tile and the
// k steps a lane holds.
__host__ __device__ constexpr bool qp_tf32_takes(int nrq, int nkj) {
    return nrq <= QP_TF32_K * QP_TF32_STEPS && nkj <= QP_TF32_M;
}

// Warp w's A fragments of m tile w mod the m tiles (where the warps
// outnumber the m tiles, some tiles have two or more warps, which deal
// that tile's units between them), read once from global memory: as in
// K2's f64 body (csrc/bwdtrans2d.cu), lane 4g + t's k slots t and t + 4
// take rq 2t and 2t + 1 of a step, so a[s] = {C12T[kj][rq], C12T[kj +
// 8][rq], C12T[kj][rq + 1], C12T[kj + 8][rq + 1]} at kj = 16 mt + g, rq
// = 8s + 2t; zero past nkj and nrq.
__device__ __forceinline__ void qp_hold_c12t(QPHeld<QP_DMMA_HELD>& held,
                                             const double* __restrict__ c12t,
                                             int nrq, int nkj) {
    const int mt = threadIdx.x / 32 % (round_up(nkj, QP_MMA_M) / QP_MMA_M);
    const int gq = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
#pragma unroll
    for (int s = 0; s < QP_MMA_STEPS; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kj = mt * QP_MMA_M + gq + 8 * (i % 2);
            const int rq = s * QP_MMA_K + 2 * tq + i / 2;
            held.a[s][i] = kj < nkj && rq < nrq ? c12t[kj * nrq + rq] : 0.0;
        }
}

// The same for HMMA's m16n8k16 A fragments (row-major, two bf16 a
// register, the lower k in the low half): a[s] = {C12T[kj][rq..rq+1],
// C12T[kj+8][rq..rq+1], C12T[kj][rq+8..rq+9], C12T[kj+8][rq+8..rq+9]} at
// kj = 16 mt + g, rq = 16s + 2t; zero past nkj and nrq.  The values are
// read as bits: a row of C12T starts on an odd value where nrq is odd.
__device__ __forceinline__ void qp_hold_c12t(QPHeld<QP_HMMA>& held,
                                             const tbt::bf16* __restrict__ c12t,
                                             int nrq, int nkj) {
    const int mt = threadIdx.x / 32 % (round_up(nkj, QP_MMA_M) / QP_MMA_M);
    const int gq = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
    const unsigned short* c = reinterpret_cast<const unsigned short*>(c12t);
#pragma unroll
    for (int s = 0; s < QP_HMMA_STEPS; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kj = mt * QP_MMA_M + gq + 8 * (i % 2);
            const int rq = s * QP_HMMA_K + 2 * tq + 8 * (i / 2);
            const unsigned lo =
                kj < nkj && rq < nrq ? c[kj * nrq + rq] : 0u;
            const unsigned hi =
                kj < nkj && rq + 1 < nrq ? c[kj * nrq + rq + 1] : 0u;
            held.a[s][i] = lo | hi << 16;
        }
}

// The TF32 body's A fragments of the m64n?k8 products, each value split
// once (tbt::split_tf32): warp w of a warp group holds kj rows 16w ..
// 16w + 15, lane 4g + t's a[s][i] at kj = 16w + g + 8 (i % 2), rq = 8s +
// t + 4 (i / 2); zero past nkj and nrq.  Both warp groups hold the same.
__device__ __forceinline__ void qp_hold_c12t(QPHeld<QP_TF32>& held,
                                             const float* __restrict__ c12t,
                                             int nrq, int nkj) {
    const int wq = threadIdx.x / 32 % 4;
    const int gq = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
#pragma unroll
    for (int s = 0; s < QP_TF32_STEPS; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kj = 16 * wq + gq + 8 * (i % 2);
            const int rq = s * QP_TF32_K + tq + 4 * (i / 2);
            tbt::split_tf32(kj < nkj && rq < nrq ? c12t[kj * nrq + rq] : 0.0f,
                            held.big[s][i], held.small[s][i]);
        }
}

// One k step (rq k .. k + 7) of a unit on DMMA: the lane's B values of
// pair np's two n tiles, rows k + 2t + r (r = 0, 1), one 16-byte load each
// from b[np][r] (n slot g takes elements 2g and 2g + 1); rows past nrq,
// in a last step that is partial, zero in registers.  Then the 2NP
// products with the step's A fragments af.
template <int ET, int NP>
__device__ __forceinline__ void qp_dmma_step(double (&acc)[2 * NP][4],
                                             const double (&af)[4],
                                             const double* (&b)[NP][2],
                                             int k, int nrq, bool whole) {
    const int tq = threadIdx.x % 4;
    double bf[2 * NP][2];
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            double2 v = make_double2(0.0, 0.0);
            if (whole || k + 2 * tq + r < nrq)
                v = *reinterpret_cast<const double2*>(b[np][r] + k * ET);
            bf[2 * np][r] = v.x;
            bf[2 * np + 1][r] = v.y;
        }
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt)
        tbt::mma_f64_16x8x8(acc[nt], af, bf[nt]);
}

// Stage 2 of the planes [i0, i0 + G) on DMMA: out[i0+g][kj][e] = sum_rq
// C12T[kj][rq] * V[g][rq][e], each plane's (nkj x nrq) @ (nrq x ET) as
// m16n8k8 f64 products, IEEE FP64 FMAs throughout, summed in the same k
// order by either form.  The group's G*ET columns are ET/16 pairs of n
// tiles a plane; a unit is one m tile by QP_MMA_PAIRS pairs, and a warp
// stops at its first unit whose planes lie past nq0.  Staged (QP_DMMA):
// the units are dealt to the warps in turn, and a lane loads its A
// values of a row from C12T's buffer s_c, one 16-byte load (lane 4g + t's
// k slots t and t + 4 take rq 2t and 2t + 1, as in K2's f64 body,
// csrc/bwdtrans2d.cu).  Held (QP_DMMA_HELD): a warp takes only units of
// the m tile it holds (qp_hold_c12t), dealt in turn among that tile's
// warps, and loads only V: at b05 10^3 (7 m tiles, 8 warps, 2 units a
// tile) warps 0 and 7 take one unit each of m tile 0 and warps 1-6 both
// units of theirs, so no warp takes more than the 2 of the staged deal.
// Each lane then holds four neighbouring elements of a row, stored as two
// 16-byte stores along e where aligned, with the streaming hint
// (st.global.cs, as K4's: 5% off the kernel at b05 10^3 against plain
// stores), masked past nkj and E.
template <int ET, int G, int NT, QPBody B>
__device__ __forceinline__ void qp_stage2_dmma(
    const double* s_v, const double* s_c, const QPHeld<B>& held,
    double* __restrict__ out, int nrq, int nq0, int nkj, long long n_elem,
    long long e0, int i0, bool vec_out) {
    constexpr int NP = QP_MMA_PAIRS, WARPS = NT / 32;
    constexpr int UNITS_MT = G * ET / 16 / NP;  // units of one m tile
    constexpr bool HELD = B == QP_DMMA_HELD || B == QP_DMMA_S1;
    static_assert(ET % 16 == 0 && (G * ET / 16) % NP == 0, "whole units");
    const int mts = round_up(nkj, QP_MMA_M) / QP_MMA_M;
    const int w = threadIdx.x / 32;
    const int gq = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
    // held: unit u is pair group u of m tile w % mts, the warps holding
    // that tile taking every (warps holding it)-th; staged: m tile u % mts,
    // pair group u / mts, every warp taking every WARPS-th
    const int u0 = HELD ? w / mts : w;
    const int du = HELD ? (WARPS - 1 - w % mts) / mts + 1 : WARPS;
    const int units = HELD ? UNITS_MT : mts * UNITS_MT;
    for (int u = u0; u < units; u += du) {
        const int mt = HELD ? w % mts : u % mts;
        const int p0 = (HELD ? u : u / mts) * NP;
        if (i0 + p0 * 16 / ET >= nq0) break;  // warp-uniform
        // rows 2t + r of each k step (r = 0, 1) of pair p0 + np's plane
        const double* b[NP][2];
#pragma unroll
        for (int np = 0; np < NP; ++np)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int p = p0 + np, rq = 2 * tq + r;
                const int e = p * 16 % ET + 2 * gq;
                b[np][r] = s_v + (p * 16 / ET * nrq + rq) * ET +
                           (B == QP_DMMA_S1 ? qp_v_col_s1(p * 16 / ET, rq, e)
                                            : qp_v_col(rq, e));
            }
        double acc[2 * NP][4] = {};
        if constexpr (HELD) {
            const int whole = nrq / QP_MMA_K;  // steps with no row past nrq
#pragma unroll
            for (int s = 0; s < QP_MMA_STEPS; ++s) {
                if (s * QP_MMA_K >= nrq) break;  // uniform
                qp_dmma_step<ET, NP>(acc, held.a[s], b, s * QP_MMA_K, nrq,
                                     s < whole);
            }
        } else {
            const int lda = qp_lda(nrq);
            const double* a = s_c + (mt * QP_MMA_M + gq) * lda + 2 * tq;
#pragma unroll 2
            for (int k = 0; k < nrq; k += QP_MMA_K) {
                const double2 lo = *reinterpret_cast<const double2*>(a + k);
                const double2 hi =
                    *reinterpret_cast<const double2*>(a + k + 8 * lda);
                const double af[4] = {lo.x, hi.x, lo.y, hi.y};
                qp_dmma_step<ET, NP>(acc, af, b, k, nrq,
                                     k + QP_MMA_K <= nrq);
            }
        }
        // tiles 2np + q hold elements 4tq + 2r + q of the pair, row gq + 8h,
        // in acc[2np + q][2h + r]
#pragma unroll
        for (int np = 0; np < NP; ++np) {
            const int p = p0 + np, i = i0 + p * 16 / ET;
            if (i >= nq0) break;
            const long long ee = e0 + p * 16 % ET + 4 * tq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int kj = mt * QP_MMA_M + gq + 8 * h;
                if (kj >= nkj) continue;
                double* y =
                    out + (static_cast<long long>(i) * nkj + kj) * n_elem + ee;
                const double lo[2] = {acc[2 * np][2 * h],
                                      acc[2 * np + 1][2 * h]};
                const double hi[2] = {acc[2 * np][2 * h + 1],
                                      acc[2 * np + 1][2 * h + 1]};
                if (vec_out && ee + 4 <= n_elem) {
                    tbt::store_cs(y, lo);
                    tbt::store_cs(y + 2, hi);
                } else {
                    const double v[4] = {lo[0], lo[1], hi[0], hi[1]};
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        if (ee + c < n_elem) y[c] = v[c];
                }
            }
        }
    }
}

// Stage 1 of the planes [i0, i0 + G) on DMMA (QP_DMMA_S1): each rq row's
// V^T (ET = 16 elements x G planes) = slab_rq^T (16 x nm0) @ B0[:, i0:i0+G]
// as m16n8k8 f64 products, one n tile of 8 planes each, k = p in
// QP_S1_STEPS steps of 8, IEEE FP64 FMAs as the SIMT form's; only the
// order of the p sums differs.  A unit is one rq row, dealt to the warps
// in turn; its G / 8 n tiles are a warp's chains of products in flight
// (b04 32^2, E = 524,288, flushed: at depth 1 with the slab copied at the
// tile's start, one unit at a time at G = 8 4.80 ms a call, two 4.55, four
// 4.47, two at G = 16 4.38; persistent at G = 16 (QPNext), one unit 3.28,
// two 3.31).  Lane 4g + t's k slots t and t + 4 take p = 2t and 2t + 1 of
// a step in A and B alike (as qp_hold_c12t's), and its m rows g and g + 8
// are elements 2g and 2g + 1, so a[0..1] and a[2..3] are one 16-byte load
// each, of the slab's p = 2t and 2t + 1 at elements 2g, 2g + 1; the slab's
// rows of qp_slab_ld values put a quarter warp's loads on distinct banks.
// B, B0[p][i0 + 8n + g], is loaded once a plane group, two values a k step
// and n tile.  p past nm0 reads zero in registers in A and in B: the slab
// has no row there, and a zero of one operand would not clear a NaN in the
// other.  The lane's sums d[i] of n tile n, at element 2g + i / 2 of plane
// 8n + 2t + i % 2, go to V as two 16-byte stores at qp_v_col_s1.
template <int ET, int G, int NT>
__device__ __forceinline__ void qp_stage1_dmma(const double* s_x,
                                               double* s_v,
                                               const double* s_b0, int nm0,
                                               int nrq, int nq0p, int i0) {
    static_assert(ET == 16 && G % 8 == 0, "one m16 tile a row, n8 tiles");
    constexpr int NTL = G / 8, LD = qp_slab_ld(QP_DMMA_S1, ET);
    const int gq = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
    double bf[NTL][QP_S1_STEPS][2];
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int s = 0; s < QP_S1_STEPS; ++s)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int p = s * QP_MMA_K + 2 * tq + r;
                bf[n][s][r] =
                    p < nm0 ? s_b0[p * nq0p + i0 + 8 * n + gq] : 0.0;
            }
    const int whole = nm0 / QP_MMA_K;  // steps with no p past nm0
    const int ps = nrq * LD;           // a p's rows
    for (int rq = threadIdx.x / 32; rq < nrq; rq += NT / 32) {
        double acc[NTL][4] = {};
#pragma unroll
        for (int s = 0; s < QP_S1_STEPS; ++s) {
            if (s * QP_MMA_K >= nm0) break;  // uniform
            const int p = s * QP_MMA_K + 2 * tq;
            const double* x = s_x + p * ps + rq * LD + 2 * gq;
            double2 lo = make_double2(0.0, 0.0), hi = lo;
            if (s < whole || p < nm0)
                lo = *reinterpret_cast<const double2*>(x);
            if (s < whole || p + 1 < nm0)
                hi = *reinterpret_cast<const double2*>(x + ps);
            const double af[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
            for (int n = 0; n < NTL; ++n)
                tbt::mma_f64_16x8x8(acc[n], af, bf[n][s]);
        }
        double* v = s_v + rq * ET;
#pragma unroll
        for (int n = 0; n < NTL; ++n) {
            const int g0 = 8 * n + 2 * tq;
            const double v0[2] = {acc[n][0], acc[n][2]};
            const double v1[2] = {acc[n][1], acc[n][3]};
            tbt::store16(v + g0 * nrq * ET + qp_v_col_s1(g0, rq, 2 * gq), v0);
            tbt::store16(
                v + (g0 + 1) * nrq * ET + qp_v_col_s1(g0 + 1, rq, 2 * gq),
                v1);
        }
    }
}

// Stage 1 into HMMA's V (qp_h_col) for the planes [i0, i0 + G): thread q
// owns pair row pr (rows 2pr and 2pr + 1, the second zero past nrq) by
// two elements, two 4-byte loads of the slab a p for 4G FMAs, summed in
// the SIMT form's order, and stores each plane's four sums rounded to
// bf16 as one 8-byte pair of words.
template <int ET, int G, int NT>
__device__ __forceinline__ void qp_stage1_pairs(const tbt::bf16* s_x,
                                                tbt::bf16* s_v,
                                                const tbt::bf16* s_b0,
                                                int nm0, int nrq, int nq0p,
                                                int i0) {
    constexpr int TX = ET / 2;  // element pairs of a pair row
    const int pairs = (nrq + 1) / 2, vplane = 2 * pairs * ET;
    for (int q = threadIdx.x; q < pairs * TX; q += NT) {
        const int pr = q / TX, e = (q % TX) * 2;
        const bool two = 2 * pr + 1 < nrq;
        float acc[G][4];  // [g][2 * row + element]
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[g][c] = 0.0f;
        for (int p = 0; p < nm0; ++p) {
            const tbt::bf16* x = s_x + (p * nrq + 2 * pr) * ET + e;
            const unsigned x0 = *reinterpret_cast<const unsigned*>(x);
            const unsigned x1 =
                two ? *reinterpret_cast<const unsigned*>(x + ET) : 0u;
            const float xv[4] = {tbt::bf16_lo(x0), tbt::bf16_hi(x0),
                                 tbt::bf16_lo(x1), tbt::bf16_hi(x1)};
            float w[G];
#pragma unroll
            for (int g = 0; g < G; g += 4)
                tbt::load4(s_b0 + p * nq0p + i0 + g, w + g);
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[g][c] = fma(w[g], xv[c], acc[g][c]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
            *reinterpret_cast<uint2*>(s_v + g * vplane + pr * 2 * ET +
                                      2 * qp_h_col<ET>(pr, e)) =
                make_uint2(tbt::pack_bf16(acc[g][0], acc[g][2]),
                           tbt::pack_bf16(acc[g][1], acc[g][3]));
    }
}

// Stage 2 of the planes [i0, i0 + G) on the bf16 tensor cores: out[i0+g]
// [kj][e] = sum_rq C12T[kj][rq] * V[g][rq][e], each plane's (nkj x nrq) @
// (nrq x ET) as m16n8k16 products of bf16 values, which are exact in f32,
// summed in f32.  The group's G*ET columns are quads of 32 (4 n tiles); a
// unit is one m tile by one quad, and warp w takes only units of the m
// tile it holds (qp_hold_c12t), dealt in turn among that tile's warps as
// in the held DMMA form; a warp stops at its first unit whose planes lie
// past nq0.  n slot n of the quad's tile q is its column 4n + q, so lane
// 4g + t loads the B values of a k step as two 16-byte words of V (pair
// rows t and t + 4, columns 4g .. 4g + 3: word q is tile q's register),
// and after the products holds columns 8t .. 8t + 7 of rows g and g + 8.
// Pair rows past nrq, in a last step that is partial, read zero in
// registers (a zero of A would not clear a NaN there).  Each output is
// rounded to bf16 once; a row's 8 go out as one 16-byte st.global.cs
// where aligned, masked past nkj, nq0 and E.
template <int ET, int G, int NT>
__device__ __forceinline__ void qp_stage2_hmma(
    const tbt::bf16* s_v, const QPHeld<QP_HMMA>& held,
    tbt::bf16* __restrict__ out, int nrq, int nq0, int nkj,
    long long n_elem, long long e0, int i0, bool vec_out) {
    constexpr int WARPS = NT / 32, QUADS = G * ET / 32;
    static_assert(ET % 16 == 0 && (G * ET) % 32 == 0, "whole quads");
    const int mts = round_up(nkj, QP_MMA_M) / QP_MMA_M;
    const int w = threadIdx.x / 32, mt = w % mts;
    const int gq = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
    const int pairs = (nrq + 1) / 2, vplane = 2 * pairs * ET;
    const int whole = pairs / 8;  // steps with no pair row past nrq
    for (int u = w / mts; u < QUADS; u += (WARPS - 1 - mt) / mts + 1) {
        if (i0 + u * 32 / ET >= nq0) break;  // warp-uniform
        // pair row 8s + t + 4h of the plane of columns jb .. jb + 3
        const int jb = u * 32 + 4 * gq;
        const tbt::bf16* b = s_v + jb / ET * vplane + tq * 2 * ET +
                             2 * qp_h_col<ET>(tq, jb % ET);
        float acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
#pragma unroll
        for (int s = 0; s < QP_HMMA_STEPS; ++s) {
            if (8 * s >= pairs) break;  // uniform
            uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
            if (s < whole || 8 * s + tq < pairs)
                lo = *reinterpret_cast<const uint4*>(b + s * 16 * ET);
            if (s < whole || 8 * s + tq + 4 < pairs)
                hi = *reinterpret_cast<const uint4*>(b + s * 16 * ET +
                                                     8 * ET);
            const unsigned bl[4] = {lo.x, lo.y, lo.z, lo.w};
            const unsigned bh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const unsigned bq[2] = {bl[q], bh[q]};
                tbt::mma_bf16(acc[q], held.a[s], bq);
            }
        }
        // tile q holds columns 8t + q and 8t + 4 + q of row g + 8h in
        // acc[q][2h] and acc[q][2h + 1]
        const int j = u * 32 + 8 * tq;
        const int i = i0 + j / ET;
        const long long ee = e0 + j % ET;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int kj = mt * QP_MMA_M + gq + 8 * h;
            if (i >= nq0 || kj >= nkj) continue;
            tbt::bf16* y =
                out + (static_cast<long long>(i) * nkj + kj) * n_elem + ee;
            float v[8];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                v[c] = acc[c][2 * h];
                v[c + 4] = acc[c][2 * h + 1];
            }
            if (vec_out && ee + 8 <= n_elem) {
                tbt::store_cs(y, v);
            } else {
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    if (ee + c < n_elem) y[c] = __float2bfloat16_rn(v[c]);
            }
        }
    }
}

// Stage 1 into the TF32 body's V for the planes [i0, i0 + G): thread q
// owns k group kg (rq 4kg .. 4kg + 3, zero past nrq) of four neighbouring
// elements in two planes, taken as two pairs of elements in turn: a pass
// loads four 8-byte words of the slab and one of B0 a p for 16 FMAs,
// summed in the SIMT form's order (at ET = 16 the lanes of two plane
// pairs read the same words), and each element's four sums of a plane,
// split (tbt::split_tf32), go out as one 16-byte word a half, at its
// column qp_tf32_col (two lanes of a quarter warp store to each bank
// group: two passes).  Two planes and two elements a pass, with their 16
// sums, not more: with 32 or more beside the 56 registers of held C12T,
// K1 spilled at 128 registers a thread.  The k groups past nrq, to the
// end of the QP_TF32_STEPS k steps, hold zeros from the block's start
// (qp_zero_tf32).
template <int ET, int G, int NT>
__device__ __forceinline__ void qp_stage1_tf32(const float* s_x, float* s_v,
                                               const float* s_b0, int nm0,
                                               int nrq, int nq0p, int i0) {
    constexpr int N = G * ET, EQ = ET / 4, PAIRS = G / 2;
    constexpr int HALF = QP_TF32_STEPS * QP_TF32_K * N;  // floats
    const int kgs = (nrq + 3) / 4;
    for (int q = threadIdx.x; q < kgs * PAIRS * EQ; q += NT) {
        const int eq = q % EQ, pr = q / EQ % PAIRS, kg = q / (EQ * PAIRS);
        bool in[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) in[r] = 4 * kg + r < nrq;
        const float* w0 = s_b0 + i0 + 2 * pr;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // elements 4eq + 2h, 4eq + 2h + 1
            const float* x = s_x + 4 * kg * ET + 4 * eq + 2 * h;
            float acc[2][4][2];  // [plane][rq][element]
#pragma unroll
            for (int g = 0; g < 2; ++g)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    acc[g][r][0] = acc[g][r][1] = 0.0f;
            for (int p = 0; p < nm0; ++p) {
                const float2 w =
                    *reinterpret_cast<const float2*>(w0 + p * nq0p);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    float2 xv = make_float2(0.0f, 0.0f);
                    if (in[r])
                        xv = *reinterpret_cast<const float2*>(
                            x + (p * nrq + r) * ET);
                    acc[0][r][0] = fma(w.x, xv.x, acc[0][r][0]);
                    acc[0][r][1] = fma(w.x, xv.y, acc[0][r][1]);
                    acc[1][r][0] = fma(w.y, xv.x, acc[1][r][0]);
                    acc[1][r][1] = fma(w.y, xv.y, acc[1][r][1]);
                }
            }
#pragma unroll
            for (int g = 0; g < 2; ++g)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    unsigned big[4], small[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        tbt::split_tf32(acc[g][r][c], big[r], small[r]);
                    float* v = s_v + 4 * (kg * N + (2 * pr + g) * ET +
                                          qp_tf32_col(4 * eq + 2 * h + c));
                    *reinterpret_cast<uint4*>(v) =
                        make_uint4(big[0], big[1], big[2], big[3]);
                    *reinterpret_cast<uint4*>(v + HALF) =
                        make_uint4(small[0], small[1], small[2], small[3]);
                }
        }
    }
}

// Once a block: the TF32 body's V from the k group of row nrq to the end,
// both halves, zero (stage 1 rewrites the rows below nrq).
template <int ET, int G, int NT>
__device__ __forceinline__ void qp_zero_tf32(float* s_v, int nrq) {
    constexpr int HALF = QP_TF32_STEPS * QP_TF32_K * G * ET;  // floats
    for (int t = nrq / 4 * 4 * G * ET + threadIdx.x; t < HALF; t += NT) {
        s_v[t] = 0.0f;
        s_v[HALF + t] = 0.0f;
    }
}

// Stage 2 of the planes [i0, i0 + G) as 3xTF32 on wgmma: out[i0+g][kj][e]
// = sum_rq C12T[kj][rq] * V[g][rq][e], warp group wg the plane group's
// columns wg QP_TF32_N .. (wg + 1) QP_TF32_N - 1 as m64n64k8 products of
// the held C12T (A) by V (B, by descriptor), f32 sums in the units, which
// truncate (tests/test_torch_tensorcore.py): the two small products of
// every k step first (small C12T by big V, big C12T by small V), then the
// big ones, so that the running sum stays small while the small terms
// are added and each of its k steps' big terms truncates once; its first
// product starts from zero.  Every warp group issues all QP_TF32_STEPS k
// steps (rows past nrq are zero), whether or not its columns lie past
// nq0: a wgmma on a path that branches is serialized (ptxas C7520).  Lane
// 4g + t then holds elements 4t .. 4t + 3 of each 16 columns
// (qp_tf32_col) of kj rows 16w + g and 16w + g + 8: one 16-byte
// st.global.cs each where aligned, masked past nkj, nq0 and E.
template <int ET, int G, int NT>
__device__ __forceinline__ void qp_stage2_tf32(
    const float* s_v, const QPHeld<QP_TF32>& held, float* __restrict__ out,
    int nq0, int nkj, long long n_elem, long long e0, int i0, bool vec_out) {
    constexpr int N = G * ET, WN = QP_TF32_N;
    static_assert(NT / 128 * WN == N, "a warp group's columns each");
    constexpr unsigned LBO = 16 * N, SBO = 128;
    const int wg = threadIdx.x / 128, wq = threadIdx.x / 32 % 4;
    const int gq = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
    const int c0 = wg * WN;
    const float* vb = s_v + 4 * c0;
    const unsigned long long big = tbt::wgmma_desc(vb, LBO, SBO);
    const unsigned long long small =
        tbt::wgmma_desc(vb + QP_TF32_STEPS * QP_TF32_K * N, LBO, SBO);
    float acc[WN / 2];
#pragma unroll
    for (int j = 0; j < WN / 2; ++j) tbt::reg_fence(acc[j]);
    tbt::wgmma_fence();
#pragma unroll
    for (int s = 0; s < QP_TF32_STEPS; ++s) {
        const unsigned long long off = (2 * s * LBO) >> 4;
        if (s == 0)
            tbt::wgmma_tf32_m64n64<0>(acc, held.small[s], big + off);
        else
            tbt::wgmma_tf32_m64n64<1>(acc, held.small[s], big + off);
        tbt::wgmma_tf32_m64n64<1>(acc, held.big[s], small + off);
    }
#pragma unroll
    for (int s = 0; s < QP_TF32_STEPS; ++s)
        tbt::wgmma_tf32_m64n64<1>(acc, held.big[s],
                                  big + ((2 * s * LBO) >> 4));
    tbt::wgmma_commit();
    tbt::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < WN / 2; ++j) tbt::reg_fence(acc[j]);
    // columns c0 + 16jj + 8jo + 2t + r (element 4t + 2jo + r of the 16) of
    // row 16w + g + 8h in acc[8jj + 4jo + 2h + r]
#pragma unroll
    for (int jj = 0; jj < WN / 16; ++jj) {
        const int c = c0 + 16 * jj, i = i0 + c / ET;
        if (i >= nq0) break;  // warp-uniform
        const long long ee = e0 + c % ET + 4 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int kj = 16 * wq + gq + 8 * h;
            if (kj >= nkj) continue;
            float* y =
                out + (static_cast<long long>(i) * nkj + kj) * n_elem + ee;
            const float v[4] = {acc[8 * jj + 2 * h], acc[8 * jj + 2 * h + 1],
                                acc[8 * jj + 4 + 2 * h],
                                acc[8 * jj + 4 + 2 * h + 1]};
            if (vec_out && ee + 4 <= n_elem) {
                tbt::store_cs(y, v);
            } else {
#pragma unroll
                for (int c4 = 0; c4 < 4; ++c4)
                    if (ee + c4 < n_elem) y[c4] = v[c4];
            }
        }
    }
}

// The probe form's phases (kernels/bwdtrans3d.QP_PHASES), and its buffer
// in device memory, of unsigned 64-bit words: a head (the newest launch's
// grid, resident block slots and number), QP_PROBE_ROWS rows of totals
// (the phases' cycles summed over the blocks of every probed launch, a row
// for the SMs of one residue), a ring of QP_PROBE_LAUNCHES launch spans
// (the complement of the first block's %globaltimer at start, so that a
// zeroed word is the identity of atomicMax, and the last block's at exit),
// then QP_PROBE_RECORD words a block of the newest launch (%globaltimer at
// start and exit, 0 for a block that is not timed; cycles; SM) for
// `capacity` blocks.
enum QPPhase : int { QP_BLOCK = 0, QP_WAIT = 1, QP_STAGE1 = 2, QP_STAGE2 = 3 };
constexpr int QP_PHASES = 4;
constexpr int QP_PROBE_HEAD = 4;
constexpr int QP_PROBE_ROWS = 32;
constexpr int QP_PROBE_LAUNCHES = 32768;
constexpr int QP_PROBE_RECORD = 4;
constexpr int QP_NO_PHASE = -1;

// The probe entry's argument: the buffer, the launch's number (from 0,
// counted by the caller), the block records it holds, and the resident
// block slots (the launcher's occupancy query).
struct QPProbe {
    unsigned long long* buf;
    long long launch;
    long long capacity;
    long long slots;
};

inline QPProbe qp_with_slots(QPProbe pr, long long slots) {
    pr.slots = slots;
    return pr;
}

// Each thread's sums of its block's phases in the probe form (mod 2^32),
// in registers: every thread of the block reads the clock at each stamp,
// so a stamp takes no branch and no memory access; thread 0's sums are
// the block's.  The probe keeps nothing in shared memory: a static shared
// variable moves the kernel's dynamic buffers, and with one the probe form
// ran 2-4% slower at depth 1.  An empty struct where P = false.
template <bool P>
struct QPSums {};

template <>
struct QPSums<true> {
    unsigned cycles[QP_PHASES];
};

__device__ __forceinline__ unsigned qp_clock() {
    return static_cast<unsigned>(clock64());
}

__device__ __forceinline__ unsigned long long qp_globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ unsigned qp_smid() {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    return id;
}

// A block of the launch's first or last wave of resident block slots (at
// depth 2, every block of its one wave), which reads %globaltimer at its
// start and exit: the launch's first start and last exit lie there.  A
// read of it takes about half a microsecond (PERF.md section 6), which
// every block of a depth-1 launch would otherwise wait out.
__device__ __forceinline__ bool qp_timed(const QPProbe& pr) {
    return blockIdx.x < pr.slots || blockIdx.x + pr.slots >= gridDim.x;
}

// The block's record of the newest launch (QP_PROBE_RECORD words).
__device__ __forceinline__ unsigned long long* qp_record(const QPProbe& pr) {
    return pr.buf + QP_PROBE_HEAD + QP_PROBE_ROWS * QP_PHASES +
           2 * QP_PROBE_LAUNCHES +
           static_cast<long long>(blockIdx.x) * QP_PROBE_RECORD;
}

// The launch's span in the ring (QP_PROBE_LAUNCHES), or launch + 1's.
__device__ __forceinline__ unsigned long long* qp_span(const QPProbe& pr,
                                                       long long launch) {
    return pr.buf + QP_PROBE_HEAD + QP_PROBE_ROWS * QP_PHASES +
           launch % QP_PROBE_LAUNCHES * 2;
}

// The clock closes phase `end` and opens phase `begin` (QP_NO_PHASE:
// none): the closing stamp adds to its phase's sum, the opening one
// takes away.
__device__ __forceinline__ void qp_stamp(QPSums<true>& sums, int end,
                                         int begin) {
    const unsigned t = qp_clock();
    if (end != QP_NO_PHASE) sums.cycles[end] += t;
    if (begin != QP_NO_PHASE) sums.cycles[begin] -= t;
}

// At the block's first instruction: the block opens, and at depth 1 the
// wait with it; thread 0 of a timed block writes its %globaltimer to its
// record and to the launch's span.
template <int D>
__device__ __forceinline__ void qp_probe_enter(QPSums<true>& sums,
                                               const QPProbe& pr) {
    const unsigned t = qp_clock();
    sums.cycles[QP_BLOCK] = 0u - t;
    sums.cycles[QP_WAIT] = D == 1 ? 0u - t : 0u;
    sums.cycles[QP_STAGE1] = 0u;
    sums.cycles[QP_STAGE2] = 0u;
    if (threadIdx.x == 0 && qp_timed(pr)) {
        const unsigned long long ns = qp_globaltimer();
        if (blockIdx.x < pr.capacity) qp_record(pr)[0] = ns;
        atomicMax(qp_span(pr, pr.launch), ~ns);
    }
}

// At the block's exit: thread 0 adds the block's sums to the totals and
// writes the rest of its record of the newest launch (%globaltimer at
// exit where timed, else 0; cycles; SM), a timed block its exit to the
// launch's span; block 0 writes the head and clears the next launch's
// span.
__device__ __forceinline__ void qp_probe_exit(QPSums<true>& sums,
                                              const QPProbe& pr) {
    sums.cycles[QP_BLOCK] += qp_clock();
    if (threadIdx.x != 0) return;
    const bool timed = qp_timed(pr);
    const unsigned long long end_ns = timed ? qp_globaltimer() : 0;
    const unsigned sm = qp_smid();
    unsigned long long* row =
        pr.buf + QP_PROBE_HEAD + sm % QP_PROBE_ROWS * QP_PHASES;
#pragma unroll
    for (int k = 0; k < QP_PHASES; ++k)
        atomicAdd(row + k, static_cast<unsigned long long>(sums.cycles[k]));
    if (timed) atomicMax(qp_span(pr, pr.launch) + 1, end_ns);
    if (blockIdx.x < pr.capacity) {
        unsigned long long* rec = qp_record(pr);
        if (!timed) rec[0] = 0;
        rec[1] = end_ns;
        rec[2] = sums.cycles[QP_BLOCK];
        rec[3] = sm;
    }
    if (blockIdx.x == 0) {
        pr.buf[0] = gridDim.x;
        pr.buf[1] = static_cast<unsigned long long>(pr.slots);
        pr.buf[2] = static_cast<unsigned long long>(pr.launch);
        unsigned long long* next = qp_span(pr, pr.launch + 1);
        next[0] = 0;
        next[1] = 0;
    }
}

// What a depth-2 block publishes during a tile: the slot's word and the
// tile after next, which thread 0 took from the counter at the loop's top
// and holds in a register (0 in the block's other threads).  An empty
// struct at depth 1.
template <int D>
struct QPAhead {};

template <>
struct QPAhead<2> {
    long long* slot;
    long long tile;
};

// Before the closing barrier of a tile's last plane group: thread 0 stores
// the tile after next into its slot.  Its atomicAdd has had the whole tile
// to return, and the word is first read after that barrier.
template <int D>
__device__ __forceinline__ void qp_publish(const QPAhead<D>& ahead,
                                           bool last) {
    if constexpr (D > 1)
        if (last && threadIdx.x == 0) *ahead.slot = ahead.tile;
}

// What a persistent block of the DMMA stage 1 (QP_DMMA_S1) hands qp_tile:
// the slot's word of the next tile, which thread 0 took from the counter
// at the tile's start (`tile`, 0 in the other threads) and stores before
// the barrier that ends the last plane group's stage 1, and what the copy
// of that tile's slab into the one slot needs.  Once that barrier is
// passed the slab is read no more (stage 2 reads V), so every thread
// issues its share of the next tile's copy there (prefetch), which runs
// under the last group's stage 2 and its stores.  Measured at b04 32^2, E
// = 524,288 (NVIDIA H100 80GB HBM3, 700 W, flushed, in one call): 3.31-
// 3.32 ms a call against 4.39-4.40 with the copy at the tile's start and
// 4.82-4.85 on the SIMT stage 1.
template <typename T, int ET, int NT>
struct QPNext {
    long long* slot;
    long long tile;
    T* s_x;
    const T* in;
    long long n_elem;
    int rows;
    bool vec;

    __device__ __forceinline__ void prefetch() const {
        const long long t = *slot;
        if (t * ET < n_elem)
            tbt::copy_tile_async<T, ET, NT>(
                s_x, qp_slab_ld(QP_DMMA_S1, ET), rows, in, n_elem, 0, t * ET,
                rows, n_elem, vec);
        tbt::cp_async_commit();
    }
};

// The DMMA stage 1 publishes the next tile in its own branch of qp_tile;
// the branches after it, dead for that body, publish nothing.
template <typename T, int ET, int NT>
__device__ __forceinline__ void qp_publish(const QPNext<T, ET, NT>&, bool) {}

// Output elements [e0, e0 + ET) from their slab s_x in shared memory, NT
// threads: for each group of G planes, stage 1 into s_v, a barrier,
// stage 2 on body B (C12T from s_ct, or the held fragments) and the
// stores, a barrier; at depth 2 the last group publishes `ahead` (a
// QPAhead<D>) before its barrier (qp_publish); the DMMA stage 1 (`ahead`
// a QPNext) publishes the next tile before the barrier after the last
// group's stage 1 and copies its slab after it.  P: the probe form, whose
// thread 0 stamps the stages' ends after those barriers.
template <typename T, int ET, int G, int D, int NT, QPBody B, bool P,
          typename Ahead>
__device__ __forceinline__ void qp_tile(const T* s_x, T* s_v, const T* s_ct,
                                        const QPHeld<B>& held, const T* s_b0,
                                        T* __restrict__ out, int nm0, int nrq,
                                        int nq0, int nkj, long long n_elem,
                                        long long e0, QPSums<P>& sums,
                                        const Ahead& ahead) {
    using A = tbt::Acc<T>;
    constexpr int TX = ET / QP_TE;  // micro-tile columns of the tile
    const int kjp = round_up(nkj, QP_TK), nq0p = round_up(nq0, G);
    const bool vec_out =
        (n_elem * sizeof(T)) % 16 == 0 && tbt::aligned16(out);
    const int kgs = kjp / QP_TK;
    for (int i0 = 0; i0 < nq0; i0 += G) {
        if constexpr (P) qp_stamp(sums, QP_NO_PHASE, QP_STAGE1);
        if constexpr (B == QP_TF32) {
            qp_stage1_tf32<ET, G, NT>(s_x, s_v, s_b0, nm0, nrq, nq0p, i0);
            tbt::fence_async_shared();  // V's stores before wgmma reads it
            __syncthreads();
            if constexpr (P) qp_stamp(sums, QP_STAGE1, QP_STAGE2);
            qp_stage2_tf32<ET, G, NT>(s_v, held, out, nq0, nkj, n_elem, e0,
                                      i0, vec_out);
            qp_publish(ahead, i0 + G >= nq0);
            __syncthreads();
            if constexpr (P) qp_stamp(sums, QP_STAGE2, QP_NO_PHASE);
            continue;
        }
        if constexpr (B == QP_HMMA) {
            qp_stage1_pairs<ET, G, NT>(s_x, s_v, s_b0, nm0, nrq, nq0p, i0);
            __syncthreads();
            if constexpr (P) qp_stamp(sums, QP_STAGE1, QP_STAGE2);
            qp_stage2_hmma<ET, G, NT>(s_v, held, out, nrq, nq0, nkj, n_elem,
                                      e0, i0, vec_out);
            qp_publish(ahead, i0 + G >= nq0);
            __syncthreads();
            if constexpr (P) qp_stamp(sums, QP_STAGE2, QP_NO_PHASE);
            continue;
        }
        if constexpr (B == QP_DMMA_S1) {
            qp_stage1_dmma<ET, G, NT>(s_x, s_v, s_b0, nm0, nrq, nq0p, i0);
            const bool last = i0 + G >= nq0;
            if (last && threadIdx.x == 0) *ahead.slot = ahead.tile;
            __syncthreads();
            // the next slab's copy is issued in the last group's stage-1
            // phase: a stamp after it, to count it to the wait, took the
            // probe form from +0.6% to +13% of the plain form's time
            if (last) ahead.prefetch();
            if constexpr (P) qp_stamp(sums, QP_STAGE1, QP_STAGE2);
            qp_stage2_dmma<ET, G, NT, B>(s_v, s_ct, held, out, nrq, nq0, nkj,
                                         n_elem, e0, i0, vec_out);
            __syncthreads();
            if constexpr (P) qp_stamp(sums, QP_STAGE2, QP_NO_PHASE);
            continue;
        }
        // stage 1: V[g][rq][e] = sum_p B0[p, i0+g] * slab[p*nrq + rq][e],
        // stored as T (the bf16 rounding of v)
        for (int q = threadIdx.x; q < nrq * TX; q += NT) {
            const int rq = q / TX, e = (q % TX) * QP_TE;
            A acc[G][QP_TE];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int c = 0; c < QP_TE; ++c) acc[g][c] = A(0);
            for (int p = 0; p < nm0; ++p) {
                A xv[QP_TE], w[G];
                tbt::load4(s_x + (p * nrq + rq) * ET + e, xv);
#pragma unroll
                for (int g = 0; g < G; g += 4)
                    tbt::load4(s_b0 + p * nq0p + i0 + g, w + g);
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int c = 0; c < QP_TE; ++c)
                        acc[g][c] = fma(w[g], xv[c], acc[g][c]);
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                T* v = s_v + (g * nrq + rq) * ET;
                if constexpr (B == QP_DMMA || B == QP_DMMA_HELD) {
                    // two words, swizzled
                    tbt::store16(v + qp_v_col(rq, e), acc[g]);
                    tbt::store16(v + qp_v_col(rq, e + 2), acc[g] + 2);
                } else {
                    tbt::store4(v + e, acc[g]);
                }
            }
        }
        __syncthreads();
        if constexpr (P) qp_stamp(sums, QP_STAGE1, QP_STAGE2);
        if constexpr (B == QP_DMMA || B == QP_DMMA_HELD) {
            qp_stage2_dmma<ET, G, NT, B>(s_v, s_ct, held, out, nrq, nq0, nkj,
                                         n_elem, e0, i0, vec_out);
            qp_publish(ahead, i0 + G >= nq0);
            __syncthreads();
            if constexpr (P) qp_stamp(sums, QP_STAGE2, QP_NO_PHASE);
            continue;
        }
        // stage 2: out[i0+g][kj][e] = sum_rq C12T[kj][rq] * V[g][rq][e]
        for (int q = threadIdx.x; q < G * kgs * TX; q += NT) {
            const int e = (q % TX) * QP_TE;
            const int kg = (q / TX) % kgs, g = q / (TX * kgs);
            if (i0 + g >= nq0) continue;
            const T* v = s_v + g * nrq * ET + e;
            const T* c = s_ct + kg * QP_TK;
            A acc[QP_TK][QP_TE];
#pragma unroll
            for (int r = 0; r < QP_TK; ++r)
#pragma unroll
                for (int cc = 0; cc < QP_TE; ++cc) acc[r][cc] = A(0);
#pragma unroll 2
            for (int rq = 0; rq < nrq; ++rq) {
                A cv[QP_TK], vv[QP_TE];
#pragma unroll
                for (int r = 0; r < QP_TK; r += 4)
                    tbt::load4(c + rq * kjp + r, cv + r);
                tbt::load4(v + rq * ET, vv);
#pragma unroll
                for (int r = 0; r < QP_TK; ++r)
#pragma unroll
                    for (int cc = 0; cc < QP_TE; ++cc)
                        acc[r][cc] = fma(cv[r], vv[cc], acc[r][cc]);
            }
            const long long ee = e0 + e;
#pragma unroll
            for (int r = 0; r < QP_TK; ++r) {
                const int kj = kg * QP_TK + r;
                if (kj >= nkj) break;
                T* y = out + (static_cast<long long>(i0 + g) * nkj + kj) *
                                 n_elem + ee;
                if (vec_out && ee + QP_TE <= n_elem) {
                    tbt::store4(y, acc[r]);
                } else {
#pragma unroll
                    for (int cc = 0; cc < QP_TE; ++cc)
                        if (ee + cc < n_elem)
                            y[cc] = tbt::narrow<T>(acc[r][cc]);
                }
            }
        }
        qp_publish(ahead, i0 + G >= nq0);
        __syncthreads();
        if constexpr (P) qp_stamp(sums, QP_STAGE2, QP_NO_PHASE);
    }
}

// The blocks an SM that K1's registers must leave room for: two of 256
// threads, one of 512; one in f64 at depth 2 (two f64 slabs fill an SM at
// b05 8^3), whose loop spilled at 128 registers a thread, and one with
// C12T held, whose lanes keep 88 registers of it.
template <typename T, int D, int NT, QPBody B>
constexpr int qp_min_blocks() {
    return B == QP_DMMA_HELD || B == QP_DMMA_S1 || (sizeof(T) == 8 && D > 1)
               ? 1
               : 2 * QP_THREADS / NT;
}

// The probe form's: as many as its plain form reaches, where its sums'
// registers would take a block off an SM.  The plain f32 and bf16 SIMT
// blocks at depth 1 take 72-80 registers, three an SM, and so do the bf16
// HMMA blocks of 4 planes at depth 1 (76-78); their probe form is held
// to that.
template <typename T, int G, int D, int NT, QPBody B, bool P>
constexpr int qp_probe_min_blocks() {
    return P && sizeof(T) < 8 && D == 1 && NT == QP_THREADS &&
                   (B == QP_SIMT || (B == QP_HMMA && G == 4))
               ? 3
               : qp_min_blocks<T, D, NT, B>();
}

// At a persistent block's exit: every block has taken its last tile once
// all are done, so the last one sets the counter back to zero for the next
// launch.
__device__ __forceinline__ void qp_ring_done(unsigned long long* counter) {
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(&counter[1], 1ULL) == gridDim.x - 1) {
            counter[0] = 0;
            counter[1] = 0;
        }
    }
}

// T is the storage type, tbt::Acc<T> the type of the sums.  D = 1: block
// b owns element tile b.  D = 2: a persistent block of a one-wave grid
// takes tiles from counter[0] (the stream's: {next tile, blocks done},
// zero between launches) and copies tile j+1's slab into the other slot
// while it computes tile j.  B: stage 2's body.  P: the probe form, whose
// one argument more (Probe, a QPProbe) the form with P = false lacks, so
// that form's parameters are the ones above.  B = QP_DMMA_S1 (D = 1): a
// persistent block of a one-wave grid takes tiles from counter[0] as at
// depth 2, into one slot, whose next slab qp_tile copies once the last
// plane group's stage 1 is done (QPNext).
template <typename T, int ET, int G, int D, int NT, QPBody B, bool P,
          typename... Probe>
__global__ void __launch_bounds__(NT,
                                  qp_probe_min_blocks<T, G, D, NT, B, P>())
    qp_fused3d_kernel(const T* __restrict__ in, const T* __restrict__ b0,
                      const T* __restrict__ c12t, T* __restrict__ out,
                      int nm0, int nrq, int nq0, int nkj, long long n_elem,
                      unsigned long long* __restrict__ counter,
                      Probe... probe) {
    static_assert(sizeof...(Probe) == (P ? 1 : 0), "a QPProbe where P");
    constexpr int V16 = 16 / sizeof(T);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int rows = nm0 * nrq;
    const int kjp = round_up(nkj, QP_TK), nq0p = round_up(nq0, G);
    constexpr bool RING = D > 1 || B == QP_DMMA_S1;  // persistent blocks
    long long* s_tile = reinterpret_cast<long long*>(smem_raw);  // RING
    T* s_x = reinterpret_cast<T*>(smem_raw + (RING ? QP_SLOT_TILES_BYTES : 0));
    const size_t slab = static_cast<size_t>(rows) * qp_slab_ld(B, ET);
    T* s_v = s_x + D * slab;  // qp_v_size(B, G, nrq, ET)
    T* s_ct = s_v + qp_v_size(B, G, nrq, ET);
    T* s_b0 = s_ct + qp_c_size(B, nrq, nkj);            // (nm0, nq0p)
    QPSums<P> sums;
    if constexpr (P) qp_probe_enter<RING ? 2 : 1>(sums, probe...);
    QPHeld<B> held;
    // tile t's slab (rows x ET from element t*ET, zero past E; rows of
    // qp_slab_ld) into slot s
    auto copy = [&](int s, long long t) {
        tbt::copy_tile_async<T, ET, NT>(
            s_x + s * slab, qp_slab_ld(B, ET), rows, in, n_elem, 0, t * ET,
            rows, n_elem, n_elem % V16 == 0 && tbt::aligned16(in));
    };
    auto stage_operators = [&] {
        if constexpr (B == QP_DMMA_HELD || B == QP_DMMA_S1 || B == QP_HMMA ||
                      B == QP_TF32) {
            // the warp's A fragments into registers, once a block; the
            // loads are in flight while the slab copy is
            qp_hold_c12t(held, c12t, nrq, nkj);
            if constexpr (B == QP_TF32) qp_zero_tf32<ET, G, NT>(s_v, nrq);
        } else if constexpr (B == QP_DMMA) {
            // C12T by cp.async, its own commit group (staged anew a tile at
            // depth 1: by plain loads it cost a fifth of the kernel at b05
            // 10^3), zero rows past nkj and zero columns past nrq
            const int lda = qp_lda(nrq);
            for (int t = threadIdx.x; t < qp_c_size(B, nrq, nkj); t += NT) {
                const int kj = t / lda, rq = t % lda;
                const bool ok = kj < nkj && rq < nrq;
                tbt::cp_async<sizeof(T)>(s_ct + t,
                                         ok ? c12t + kj * nrq + rq : c12t, ok);
            }
            tbt::cp_async_commit();
        } else {
            for (int t = threadIdx.x; t < nrq * kjp; t += NT) {
                const int rq = t / kjp, kj = t % kjp;
                s_ct[t] = kj < nkj ? c12t[kj * nrq + rq] : tbt::narrow<T>(0);
            }
        }
        for (int t = threadIdx.x; t < nm0 * nq0p; t += NT) {
            const int p = t / nq0p, i = t % nq0p;
            s_b0[t] = i < nq0 ? b0[p * nq0 + i] : tbt::narrow<T>(0);
        }
    };

    if constexpr (B == QP_DMMA_S1) {
        if (threadIdx.x == 0)
            s_tile[0] = static_cast<long long>(atomicAdd(&counter[0], 1ULL));
        stage_operators();
        __syncthreads();
        long long cur = s_tile[0];
        if (cur * ET < n_elem) copy(0, cur);
        tbt::cp_async_commit();
        const bool vec = n_elem % V16 == 0 && tbt::aligned16(in);
        while (cur * ET < n_elem) {
            if constexpr (P) qp_stamp(sums, QP_NO_PHASE, QP_WAIT);
            // the next tile, taken before the wait so that its round trip
            // is hidden, and published by qp_tile (the word s_tile[1] holds
            // cur until the wait's barrier)
            QPNext<T, ET, NT> next{s_tile + 1, 0, s_x, in, n_elem, rows,
                                   vec};
            if (threadIdx.x == 0)
                next.tile =
                    static_cast<long long>(atomicAdd(&counter[0], 1ULL));
            tbt::cp_async_wait<0>();
            __syncthreads();
            if constexpr (P) qp_stamp(sums, QP_WAIT, QP_NO_PHASE);
            qp_tile<T, ET, G, D, NT, B, P>(s_x, s_v, s_ct, held, s_b0, out,
                                           nm0, nrq, nq0, nkj, n_elem,
                                           cur * ET, sums, next);
            cur = s_tile[1];
        }
        qp_ring_done(counter);
    } else if constexpr (D == 1) {
        copy(0, blockIdx.x);
        tbt::cp_async_commit();
        stage_operators();
        tbt::cp_async_wait<0>();
        __syncthreads();
        if constexpr (P) qp_stamp(sums, QP_WAIT, QP_NO_PHASE);
        qp_tile<T, ET, G, D, NT, B, P>(
            s_x, s_v, s_ct, held, s_b0, out, nm0, nrq, nq0, nkj, n_elem,
            static_cast<long long>(blockIdx.x) * ET, sums, QPAhead<D>{});
    } else {
        if (threadIdx.x == 0) {
            s_tile[0] = static_cast<long long>(atomicAdd(&counter[0], 1ULL));
            s_tile[1] = static_cast<long long>(atomicAdd(&counter[0], 1ULL));
        }
        stage_operators();
        __syncthreads();
        long long cur = s_tile[0];
        if (cur * ET < n_elem) copy(0, cur);
        tbt::cp_async_commit();
        // s: the slot of cur, the tile in hand; s_tile[s ^ 1], the tile of
        // the other slot, is published during the tile before cur and read
        // at cur's start and end
        for (int s = 0; cur * ET < n_elem; s ^= 1) {
            if constexpr (P) qp_stamp(sums, QP_NO_PHASE, QP_WAIT);
            // the tile after next, for slot s: taken before thread 0's
            // share of next's copy, so that it does not queue behind the
            // slab, and published by qp_tile at this tile's end, where no
            // warp waits for it (the word holds cur until the wait's
            // barrier)
            QPAhead<D> ahead{s_tile + s, 0};
            if (threadIdx.x == 0)
                ahead.tile =
                    static_cast<long long>(atomicAdd(&counter[0], 1ULL));
            const long long next = s_tile[s ^ 1];
            if (next * ET < n_elem) copy(s ^ 1, next);  // every thread has
            tbt::cp_async_commit();                     // left that slot
            tbt::cp_async_wait<1>();  // this thread's copies of cur
            __syncthreads();          // everyone's
            if constexpr (P) qp_stamp(sums, QP_WAIT, QP_NO_PHASE);
            qp_tile<T, ET, G, D, NT, B, P>(s_x + s * slab, s_v, s_ct, held,
                                           s_b0, out, nm0, nrq, nq0, nkj,
                                           n_elem, cur * ET, sums, ahead);
            cur = s_tile[s ^ 1];  // next, read again, not held in a register
        }
        qp_ring_done(counter);
    }
    if constexpr (P) qp_probe_exit(sums, probe...);
}

// One launch of the instance (ET, G, D, NT, B, P): at depth 1 a block a
// tile; at depth 2, and for the DMMA stage 1, one wave (the occupancy
// API's blocks an SM times the SMs, once per device and size), no more
// than the tiles, on the stream's counter.  The probe form (P, with its
// QPProbe) also takes that wave at depth 1, as the launch's resident
// block slots.
template <typename T, int ET, int G, int D, int NT, QPBody B, bool P,
          typename... Probe>
int launch_tile(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                int nrq, int nq0, int nkj, long long n_elem,
                cudaStream_t stream, Probe... probe) {
    const size_t smem = qp_smem_bytes<T>(ET, G, nm0, nrq, nq0, nkj, D, B);
    static tbt::DeviceCache<> optin, waves;  // once per device (and size)
    auto kernel = qp_fused3d_kernel<T, ET, G, D, NT, B, P, Probe...>;
    cudaError_t err = tbt::optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    long long blocks = (n_elem + ET - 1) / ET;
    unsigned long long* counter = nullptr;
    if constexpr (D > 1 || B == QP_DMMA_S1) {
        err = tbt::ring::stream_counter(stream, &counter);
        if (err != cudaSuccess) return err;
        const long long wave = tbt::wave_blocks(waves, kernel, NT, smem);
        if (wave < 0) return static_cast<int>(-wave);
        if (wave == 0) return cudaErrorInvalidConfiguration;
        if (wave < blocks) blocks = wave;
    }
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    if constexpr (P) {
        const long long wave = tbt::wave_blocks(waves, kernel, NT, smem);
        if (wave < 0) return static_cast<int>(-wave);
        kernel<<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, counter,
            qp_with_slots(probe..., wave));
    } else {
        kernel<<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, counter);
    }
    return cudaGetLastError();
}

// The element tiles of T at depth 1 (kernels/bwdtrans3d.QP_TILES) and
// at depth 2 (QP_RING_TILES); DMMA's at either depth (QP_DMMA_TILES);
// HMMA's (QP_HMMA_TILES) at depth 1, and at depth 2 the ring's, in
// blocks of QP_THREADS; TF32's the ring's at either depth, each with the
// plane group that gives its two warp groups QP_TF32_N columns each.
template <typename T, int G, int D, int NT, QPBody B, bool P,
          typename... Probe>
int launch_form(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                int nrq, int nq0, int nkj, long long n_elem, int et,
                cudaStream_t stream, Probe... probe) {
    if constexpr (B == QP_TF32) {
        // a warp group's QP_TF32_N columns of the plane group each
        if constexpr (16 * G == 2 * QP_TF32_N)
            if (et == 16)
                return launch_tile<T, 16, G, D, NT, B, P>(
                    in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream,
                    probe...);
        if constexpr (32 * G == 2 * QP_TF32_N)
            if (et == 32)
                return launch_tile<T, 32, G, D, NT, B, P>(
                    in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream,
                    probe...);
        return cudaErrorInvalidValue;
    } else {
        constexpr bool f64 = sizeof(T) == 8;
        switch (et) {
            case 16:
                return launch_tile<T, 16, G, D, NT, B, P>(
                    in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream,
                    probe...);
            case 32:
                return launch_tile<T, 32, G, D, NT, B, P>(
                    in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream,
                    probe...);
        }
        if constexpr (D == 1 && B == QP_HMMA)
            if (et == 64)
                return launch_tile<T, 64, G, D, NT, B, P>(
                    in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream,
                    probe...);
        if constexpr (D == 1 && B == QP_SIMT) {
            switch (et) {
                case 64:
                    return launch_tile<T, 64, G, D, NT, B, P>(
                        in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream,
                        probe...);
                case 8:
                    if constexpr (f64)
                        return launch_tile<T, 8, G, D, NT, B, P>(
                            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem,
                            stream, probe...);
                    break;
                case 128:
                    if constexpr (!f64)
                        return launch_tile<T, 128, G, D, NT, B, P>(
                            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem,
                            stream, probe...);
                    break;
            }
        }
    }
    return cudaErrorInvalidValue;
}

// The (ring depth, threads) forms: kernels/bwdtrans3d.QP_FORMS (no f64
// block of 512 threads, nor HMMA's or TF32's).
template <typename T, int G, QPBody B, bool P, typename... Probe>
int launch_planes(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                  int nrq, int nq0, int nkj, long long n_elem, int et,
                  int depth, int threads, cudaStream_t stream,
                  Probe... probe) {
    if (depth == 1 && threads == QP_THREADS)
        return launch_form<T, G, 1, QP_THREADS, B, P>(
            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, stream,
            probe...);
    if (depth == 2 && threads == QP_THREADS)
        return launch_form<T, G, 2, QP_THREADS, B, P>(
            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, stream,
            probe...);
    if constexpr (sizeof(T) != 8 && B != QP_HMMA && B != QP_TF32)
        if (depth == 2 && threads == 2 * QP_THREADS)
            return launch_form<T, G, 2, 2 * QP_THREADS, B, P>(
                in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, stream,
                probe...);
    return cudaErrorInvalidValue;
}

template <typename T, QPBody B, bool P, typename... Probe>
int launch_body(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                int nrq, int nq0, int nkj, long long n_elem, int et, int g,
                int depth, int threads, cudaStream_t stream,
                Probe... probe) {
    if (g == 4)
        return launch_planes<T, 4, B, P>(in, b0, c12t, out, nm0, nrq, nq0,
                                         nkj, n_elem, et, depth, threads,
                                         stream, probe...);
    if (g == 8)
        return launch_planes<T, 8, B, P>(in, b0, c12t, out, nm0, nrq, nq0,
                                         nkj, n_elem, et, depth, threads,
                                         stream, probe...);
    return cudaErrorInvalidValue;
}

// The element tiles et, plane groups g, ring depths, block threads and
// stage-2 bodies (DMMA in f64 only; with C12T held, at the shapes
// qp_dmma_takes, and with stage 1 on DMMA too at (16, QP_S1_PLANES, 1,
// QP_THREADS) where qp_s1_dmma_takes; HMMA in bf16 only, at the shapes
// qp_hmma_takes; TF32 in f32 only, at the shapes qp_tf32_takes) it is
// built for (qp_config in kernels/bwdtrans3d.py picks them for each shape
// and dtype); P and its QPProbe: the probe form
// (csrc/qp_fused3d_probe.cu).
template <typename T, bool P, typename... Probe>
int launch(const T* in, const T* b0, const T* c12t, T* out, int nm0, int nrq,
           int nq0, int nkj, long long n_elem, int et, int g, int depth,
           int threads, int body, cudaStream_t stream, Probe... probe) {
    if (n_elem <= 0) return cudaSuccess;
    if (nm0 <= 0 || nrq <= 0 || nq0 <= 0 || nkj <= 0)
        return cudaErrorInvalidValue;
    if (body == QP_SIMT)
        return launch_body<T, QP_SIMT, P>(in, b0, c12t, out, nm0, nrq, nq0,
                                          nkj, n_elem, et, g, depth, threads,
                                          stream, probe...);
    if constexpr (sizeof(T) == 8) {
        if (body == QP_DMMA)
            return launch_body<T, QP_DMMA, P>(in, b0, c12t, out, nm0, nrq,
                                              nq0, nkj, n_elem, et, g, depth,
                                              threads, stream, probe...);
        if (body == QP_DMMA_HELD && qp_dmma_takes(nrq, nkj))
            return launch_body<T, QP_DMMA_HELD, P>(
                in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, g, depth,
                threads, stream, probe...);
        // the DMMA stage 1's one instance
        if (body == QP_DMMA_S1 && qp_s1_dmma_takes(nm0, nrq, nkj) &&
            et == 16 && g == QP_S1_PLANES && depth == 1 &&
            threads == QP_THREADS)
            return launch_tile<T, 16, QP_S1_PLANES, 1, QP_THREADS, QP_DMMA_S1,
                               P>(
                in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream,
                probe...);
    }
    if constexpr (sizeof(T) == 4) {
        if (body == QP_TF32 && qp_tf32_takes(nrq, nkj))
            return launch_body<T, QP_TF32, P>(in, b0, c12t, out, nm0, nrq,
                                              nq0, nkj, n_elem, et, g, depth,
                                              threads, stream, probe...);
    }
    if constexpr (sizeof(T) == 2) {
        if (body == QP_HMMA && qp_hmma_takes(nrq, nkj))
            return launch_body<T, QP_HMMA, P>(in, b0, c12t, out, nm0, nrq,
                                              nq0, nkj, n_elem, et, g, depth,
                                              threads, stream, probe...);
    }
    return cudaErrorInvalidValue;
}

}  // namespace
