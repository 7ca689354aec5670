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
//   - bf16 (benchmarks 04 and 05 with --dtype bf16): the slab, V, C12T^T
//     and B0 are stored in bf16 and widened to f32 on load, every sum is
//     f32, and V is rounded to bf16 when it is stored, before stage 2,
//     where the JAX kernel rounds its f32 v (bwdtrans3d.py:90); each
//     output is rounded once.  The bf16 bytes halve the bound (0.067 ms
//     at b05 8^3 against 0.134 in f32).
//   - f64 at b05 10^3: the operations, not the bytes, bound the SIMT form.
//     An element takes 2*nq0*nrq*(nm0 + nkj) = 176,580 FLOP, 162,000 of
//     them (92%) in stage 2, 92.6 GFLOP a call of 524,288 elements: 2.76
//     ms at FP64's 33.5 TFLOP/s on the CUDA cores, above its 2.165 ms of
//     bytes.  The SIMT micro-tile ran it at 8.0 TFLOP/s (11.5 ms a call;
//     a 16-element tile took an SM 46.4 us against 8.7 of bytes): its
//     shared-memory loads match its FMAs, and one block of 8 warps an SM
//     hides no latency.  So in f64 stage 2 runs on sm_90's DMMA
//     (mma.sync.m16n8k8 on f64, 66.7 TFLOP/s, IEEE FP64 FMAs as the SIMT
//     body's; qp_stage2_dmma).  Stage 1 stays SIMT (8% of the FLOP).  The
//     body is a template argument; kernels/bwdtrans3d.qp_config picks it
//     from the shape (QP_MEASURED, else DMMA in f64 where nkj >= 16, nrq
//     >= 8 and the body serves the shape); f32 and bf16 keep the SIMT
//     body.  Its first form staged C12T in shared memory (nkj padded to
//     112 rows of 88 values at 10^3) and padded V's rows to 8 and to ET +
//     2 values: 5.37 ms at b05 10^3, E = 524,288 (L2 flushed), a tile
//     21.6 us an SM, whose slab copy, products and stores took turns in
//     the one depth-1 block an SM, as no ring fitted beside those buffers
//     (317,040 B).
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
//   - The probe form (template argument P = true; kernels/bwdtrans3d.py
//     launches it only while a torch profiler records): the threads read
//     the SM's clock right after barriers the kernel already has, and sum
//     per block the cycles of its phases (QPPhase): the block, from its
//     first instruction to its exit; the wait, at depth 2 each tile from
//     the loop's top to the barrier after cp.async.wait_group 1 (the time
//     its slab had not arrived), at depth 1 from the block's start to the
//     barrier after its whole load (copy, operator staging and wait);
//     stage 1 of each plane group, to the barrier after it; and stage 2,
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
// (kernels/bwdtrans3d.qp_dmma_takes).
enum QPBody : int { QP_SIMT = 0, QP_DMMA = 1, QP_DMMA_HELD = 2 };
constexpr int QP_MMA_M = 16;
constexpr int QP_MMA_K = 8;
constexpr int QP_MMA_PAIRS = 2;
constexpr int QP_MMA_STEPS = 11;

// What a thread holds of C12T from tile to tile: the held form's A
// fragments; nothing where C12T is staged in shared memory.
template <QPBody B>
struct QPHeld {};

template <>
struct QPHeld<QP_DMMA_HELD> {
    double a[QP_MMA_STEPS][4];
};

// DMMA's V (either form), nrq x ET a plane with no padding: element e of row rq lies at
// column e ^ 2 (rq % 8), the row's 16-byte words XORed with rq % 8, so a
// quarter warp's 16-byte B loads (rows 2t + r of a k step, words g ^ (2t
// + r)) and stage 1's stores (two rows, every other word) hit distinct
// banks.
__host__ __device__ constexpr int qp_v_col(int rq, int e) {
    return e ^ ((rq & 7) << 1);
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
// and nrq) for the staged DMMA form, none for the held one.
__host__ __device__ constexpr int qp_c_size(QPBody b, int nrq, int nkj) {
    return b == QP_DMMA_HELD ? 0
           : b == QP_DMMA    ? round_up(nkj, QP_MMA_M) * qp_lda(nrq)
                             : nrq * round_up(nkj, QP_TK);
}

// Dynamic shared memory of one block: `depth` slabs, V for G planes
// (nrq x et each), C12T's buffer and B0 (nm0 x nq0 padded to G), each a
// whole number of 16-byte words; at depth 2 the slots' tiles first.
template <typename T>
size_t qp_smem_bytes(int et, int g, int nm0, int nrq, int nq0, int nkj,
                     int depth, QPBody body) {
    return (depth > 1 ? QP_SLOT_TILES_BYTES : 0) +
           sizeof(T) *
               (static_cast<size_t>(depth) * nm0 * nrq * et +
                static_cast<size_t>(g) * nrq * et +
                static_cast<size_t>(qp_c_size(body, nrq, nkj)) +
                static_cast<size_t>(nm0) * round_up(nq0, g));
}

// Whether the held DMMA form serves a shape: at most one m tile of C12T a
// warp of the block's QP_THREADS, and nrq within the k steps a lane holds.
__host__ __device__ constexpr bool qp_dmma_takes(int nrq, int nkj) {
    return nrq <= QP_MMA_K * QP_MMA_STEPS &&
           round_up(nkj, QP_MMA_M) / QP_MMA_M <= QP_THREADS / 32;
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
    constexpr bool HELD = B == QP_DMMA_HELD;
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
                b[np][r] = s_v + (p * 16 / ET * nrq + rq) * ET +
                           qp_v_col(rq, p * 16 % ET + 2 * gq);
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

// Output elements [e0, e0 + ET) from their slab s_x in shared memory, NT
// threads: for each group of G planes, stage 1 into s_v, a barrier,
// stage 2 on body B (C12T from s_ct, or the held fragments) and the
// stores, a barrier; at depth 2 the last group publishes `ahead` before
// its barrier (qp_publish).  P: the probe form, whose thread 0 stamps the
// stages' ends after those barriers.
template <typename T, int ET, int G, int D, int NT, QPBody B, bool P>
__device__ __forceinline__ void qp_tile(const T* s_x, T* s_v, const T* s_ct,
                                        const QPHeld<B>& held, const T* s_b0,
                                        T* __restrict__ out, int nm0, int nrq,
                                        int nq0, int nkj, long long n_elem,
                                        long long e0, QPSums<P>& sums,
                                        const QPAhead<D>& ahead) {
    using A = tbt::Acc<T>;
    constexpr int TX = ET / QP_TE;  // micro-tile columns of the tile
    const int kjp = round_up(nkj, QP_TK), nq0p = round_up(nq0, G);
    const bool vec_out =
        (n_elem * sizeof(T)) % 16 == 0 && tbt::aligned16(out);
    const int kgs = kjp / QP_TK;
    for (int i0 = 0; i0 < nq0; i0 += G) {
        if constexpr (P) qp_stamp(sums, QP_NO_PHASE, QP_STAGE1);
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
                if constexpr (B != QP_SIMT) {  // two words, swizzled
                    tbt::store16(v + qp_v_col(rq, e), acc[g]);
                    tbt::store16(v + qp_v_col(rq, e + 2), acc[g] + 2);
                } else {
                    tbt::store4(v + e, acc[g]);
                }
            }
        }
        __syncthreads();
        if constexpr (P) qp_stamp(sums, QP_STAGE1, QP_STAGE2);
        if constexpr (B != QP_SIMT) {
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
    return B == QP_DMMA_HELD || (sizeof(T) == 8 && D > 1)
               ? 1
               : 2 * QP_THREADS / NT;
}

// The probe form's: as many as its plain form reaches, where its sums'
// registers would take a block off an SM.  The plain f32 and bf16 SIMT
// blocks at depth 1 take 72-80 registers, three an SM; their probe form
// is held to that.
template <typename T, int D, int NT, QPBody B, bool P>
constexpr int qp_probe_min_blocks() {
    return P && sizeof(T) < 8 && D == 1 && NT == QP_THREADS && B == QP_SIMT
               ? 3
               : qp_min_blocks<T, D, NT, B>();
}

// T is the storage type, tbt::Acc<T> the type of the sums.  D = 1: block
// b owns element tile b.  D = 2: a persistent block of a one-wave grid
// takes tiles from counter[0] (the stream's: {next tile, blocks done},
// zero between launches) and copies tile j+1's slab into the other slot
// while it computes tile j.  B: stage 2's body.  P: the probe form, whose
// one argument more (Probe, a QPProbe) the form with P = false lacks, so
// that form's parameters are the ones above.
template <typename T, int ET, int G, int D, int NT, QPBody B, bool P,
          typename... Probe>
__global__ void __launch_bounds__(NT, qp_probe_min_blocks<T, D, NT, B, P>())
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
    long long* s_tile = reinterpret_cast<long long*>(smem_raw);  // D = 2
    T* s_x = reinterpret_cast<T*>(smem_raw +
                                  (D > 1 ? QP_SLOT_TILES_BYTES : 0));
    const size_t slab = static_cast<size_t>(rows) * ET;
    T* s_v = s_x + D * slab;                            // (G, nrq, ET)
    T* s_ct = s_v + static_cast<size_t>(G) * nrq * ET;  // qp_c_size
    T* s_b0 = s_ct + qp_c_size(B, nrq, nkj);            // (nm0, nq0p)
    QPSums<P> sums;
    if constexpr (P) qp_probe_enter<D>(sums, probe...);
    QPHeld<B> held;
    // tile t's slab (rows x ET from element t*ET, zero past E) into slot s
    auto copy = [&](int s, long long t) {
        tbt::copy_tile_async<T, ET, NT>(
            s_x + s * slab, ET, rows, in, n_elem, 0, t * ET, rows, n_elem,
            n_elem % V16 == 0 && tbt::aligned16(in));
    };
    auto stage_operators = [&] {
        if constexpr (B == QP_DMMA_HELD) {
            // the warp's A fragments into registers, once a block; the
            // loads are in flight while the slab copy is
            qp_hold_c12t(held, c12t, nrq, nkj);
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

    if constexpr (D == 1) {
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
        if (threadIdx.x == 0) {
            // every block has taken its last tile once all are done: the
            // last one sets the counter back to zero for the next launch
            __threadfence();
            if (atomicAdd(&counter[1], 1ULL) == gridDim.x - 1) {
                counter[0] = 0;
                counter[1] = 0;
            }
        }
    }
    if constexpr (P) qp_probe_exit(sums, probe...);
}

// One launch of the instance (ET, G, D, NT, B, P): at depth 1 a block a
// tile; at depth 2 one wave (the occupancy API's blocks an SM times the
// SMs, once per device and size), no more than the tiles, on the stream's
// counter.  The probe form (P, with its QPProbe) also takes that wave at
// depth 1, as the launch's resident block slots.
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
    if constexpr (D > 1) {
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
// at depth 2 (QP_RING_TILES); DMMA's at either depth (QP_DMMA_TILES).
template <typename T, int G, int D, int NT, QPBody B, bool P,
          typename... Probe>
int launch_form(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                int nrq, int nq0, int nkj, long long n_elem, int et,
                cudaStream_t stream, Probe... probe) {
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
    return cudaErrorInvalidValue;
}

// The (ring depth, threads) forms: kernels/bwdtrans3d.QP_FORMS (no f64
// block of 512 threads).
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
    if constexpr (sizeof(T) != 8)
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
// qp_dmma_takes) it is built for (qp_config in
// kernels/bwdtrans3d.py picks them for each shape and dtype); P and its
// QPProbe: the probe form (csrc/qp_fused3d_probe.cu).
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
    }
    return cudaErrorInvalidValue;
}

}  // namespace
