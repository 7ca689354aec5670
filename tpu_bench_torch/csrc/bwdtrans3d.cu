// K1 qp_fused3d: the fused 3D sum-factorization of benchmark05's BwdTrans,
// and K4 qp_stage2_3d (below): stage 2 of its two-kernel form.
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
//     in device memory (one atomicAdd a tile; the stream's counter of
//     csrc/ring.cuh, which the last block to finish sets back to zero),
//     and copies tile j+1's slab into the other slot (cp.async, a commit
//     group a tile, wait_group 1) while it computes tile j and stores its
//     outputs.  A slot is refilled only after the barrier that ends its
//     tile; B0 and C12T^T are staged once a block.  Blocks of 256 or 512
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
// Later work: TMA for the slab.

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

// Output elements [e0, e0 + ET) from their slab s_x in shared memory, NT
// threads: for each group of G planes, stage 1 into s_v, a barrier,
// stage 2 on body B (C12T from s_ct, or the held fragments) and the
// stores, a barrier.
template <typename T, int ET, int G, int NT, QPBody B>
__device__ __forceinline__ void qp_tile(const T* s_x, T* s_v, const T* s_ct,
                                        const QPHeld<B>& held, const T* s_b0,
                                        T* __restrict__ out, int nm0, int nrq,
                                        int nq0, int nkj, long long n_elem,
                                        long long e0) {
    using A = tbt::Acc<T>;
    constexpr int TX = ET / QP_TE;  // micro-tile columns of the tile
    const int kjp = round_up(nkj, QP_TK), nq0p = round_up(nq0, G);
    const bool vec_out =
        (n_elem * sizeof(T)) % 16 == 0 && tbt::aligned16(out);
    const int kgs = kjp / QP_TK;
    for (int i0 = 0; i0 < nq0; i0 += G) {
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
        if constexpr (B != QP_SIMT) {
            qp_stage2_dmma<ET, G, NT, B>(s_v, s_ct, held, out, nrq, nq0, nkj,
                                         n_elem, e0, i0, vec_out);
            __syncthreads();
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
        __syncthreads();
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

// T is the storage type, tbt::Acc<T> the type of the sums.  D = 1: block
// b owns element tile b.  D = 2: a persistent block of a one-wave grid
// takes tiles from counter[0] (the stream's: {next tile, blocks done},
// zero between launches) and copies tile j+1's slab into the other slot
// while it computes tile j.  B: stage 2's body.
template <typename T, int ET, int G, int D, int NT, QPBody B>
__global__ void __launch_bounds__(NT, qp_min_blocks<T, D, NT, B>())
    qp_fused3d_kernel(const T* __restrict__ in, const T* __restrict__ b0,
                      const T* __restrict__ c12t, T* __restrict__ out,
                      int nm0, int nrq, int nq0, int nkj, long long n_elem,
                      unsigned long long* __restrict__ counter) {
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
        qp_tile<T, ET, G, NT, B>(s_x, s_v, s_ct, held, s_b0, out, nm0, nrq,
                                 nq0, nkj, n_elem,
                                 static_cast<long long>(blockIdx.x) * ET);
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
        // the other slot, is written during the tile before cur and read
        // at cur's start and end
        for (int s = 0; cur * ET < n_elem; s ^= 1) {
            const long long next = s_tile[s ^ 1];
            if (next * ET < n_elem) copy(s ^ 1, next);  // every thread has
            tbt::cp_async_commit();                     // left that slot
            tbt::cp_async_wait<1>();  // this thread's copies of cur
            __syncthreads();          // everyone's
            // the tile after next, for slot s, read after cur's barriers
            if (threadIdx.x == 0)
                s_tile[s] =
                    static_cast<long long>(atomicAdd(&counter[0], 1ULL));
            qp_tile<T, ET, G, NT, B>(s_x + s * slab, s_v, s_ct, held, s_b0,
                                     out, nm0, nrq, nq0, nkj, n_elem,
                                     cur * ET);
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
}

// One launch of the instance (ET, G, D, NT, B): at depth 1 a block a
// tile; at depth 2 one wave (the occupancy API's blocks an SM times the
// SMs, once per device and size), no more than the tiles, on the stream's
// counter.
template <typename T, int ET, int G, int D, int NT, QPBody B>
int launch_tile(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                int nrq, int nq0, int nkj, long long n_elem,
                cudaStream_t stream) {
    const size_t smem = qp_smem_bytes<T>(ET, G, nm0, nrq, nq0, nkj, D, B);
    static tbt::DeviceCache<> optin, waves;  // once per device (and size)
    auto kernel = qp_fused3d_kernel<T, ET, G, D, NT, B>;
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
    kernel<<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
        in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, counter);
    return cudaGetLastError();
}

// The element tiles of T at depth 1 (kernels/bwdtrans3d.QP_TILES) and
// at depth 2 (QP_RING_TILES); DMMA's at either depth (QP_DMMA_TILES).
template <typename T, int G, int D, int NT, QPBody B>
int launch_form(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                int nrq, int nq0, int nkj, long long n_elem, int et,
                cudaStream_t stream) {
    constexpr bool f64 = sizeof(T) == 8;
    switch (et) {
        case 16:
            return launch_tile<T, 16, G, D, NT, B>(
                in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream);
        case 32:
            return launch_tile<T, 32, G, D, NT, B>(
                in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, stream);
    }
    if constexpr (D == 1 && B == QP_SIMT) {
        switch (et) {
            case 64:
                return launch_tile<T, 64, G, D, NT, B>(in, b0, c12t, out, nm0,
                                                       nrq, nq0, nkj, n_elem,
                                                       stream);
            case 8:
                if constexpr (f64)
                    return launch_tile<T, 8, G, D, NT, B>(
                        in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem,
                        stream);
                break;
            case 128:
                if constexpr (!f64)
                    return launch_tile<T, 128, G, D, NT, B>(
                        in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem,
                        stream);
                break;
        }
    }
    return cudaErrorInvalidValue;
}

// The (ring depth, threads) forms: kernels/bwdtrans3d.QP_FORMS (no f64
// block of 512 threads).
template <typename T, int G, QPBody B>
int launch_planes(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                  int nrq, int nq0, int nkj, long long n_elem, int et,
                  int depth, int threads, cudaStream_t stream) {
    if (depth == 1 && threads == QP_THREADS)
        return launch_form<T, G, 1, QP_THREADS, B>(
            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, stream);
    if (depth == 2 && threads == QP_THREADS)
        return launch_form<T, G, 2, QP_THREADS, B>(
            in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, stream);
    if constexpr (sizeof(T) != 8)
        if (depth == 2 && threads == 2 * QP_THREADS)
            return launch_form<T, G, 2, 2 * QP_THREADS, B>(
                in, b0, c12t, out, nm0, nrq, nq0, nkj, n_elem, et, stream);
    return cudaErrorInvalidValue;
}

template <typename T, QPBody B>
int launch_body(const T* in, const T* b0, const T* c12t, T* out, int nm0,
                int nrq, int nq0, int nkj, long long n_elem, int et, int g,
                int depth, int threads, cudaStream_t stream) {
    if (g == 4)
        return launch_planes<T, 4, B>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                      n_elem, et, depth, threads, stream);
    if (g == 8)
        return launch_planes<T, 8, B>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                      n_elem, et, depth, threads, stream);
    return cudaErrorInvalidValue;
}

// The element tiles et, plane groups g, ring depths, block threads and
// stage-2 bodies (DMMA in f64 only; with C12T held, at the shapes
// qp_dmma_takes) it is built for (qp_config in
// kernels/bwdtrans3d.py picks them for each shape and dtype).
template <typename T>
int launch(const T* in, const T* b0, const T* c12t, T* out, int nm0, int nrq,
           int nq0, int nkj, long long n_elem, int et, int g, int depth,
           int threads, int body, cudaStream_t stream) {
    if (n_elem <= 0) return cudaSuccess;
    if (nm0 <= 0 || nrq <= 0 || nq0 <= 0 || nkj <= 0)
        return cudaErrorInvalidValue;
    if (body == QP_SIMT)
        return launch_body<T, QP_SIMT>(in, b0, c12t, out, nm0, nrq, nq0, nkj,
                                       n_elem, et, g, depth, threads, stream);
    if constexpr (sizeof(T) == 8) {
        if (body == QP_DMMA)
            return launch_body<T, QP_DMMA>(in, b0, c12t, out, nm0, nrq, nq0,
                                           nkj, n_elem, et, g, depth, threads,
                                           stream);
        if (body == QP_DMMA_HELD && qp_dmma_takes(nrq, nkj))
            return launch_body<T, QP_DMMA_HELD>(in, b0, c12t, out, nm0, nrq,
                                                nq0, nkj, n_elem, et, g, depth,
                                                threads, stream);
    }
    return cudaErrorInvalidValue;
}

// K4 qp_stage2_3d: stage 2 of benchmark05's and benchmark04's Pallas(QP).
//
// Replaces tpu_bench/kernels/bwdtrans3d.py:qp_global3d's second
// pallas_call (_stage2_kernel3d) and tpu_bench/kernels/bwdtrans2d.py:
// qp_global's (_stage2_kernel), the p contraction of the workspace that
// stage 1 (K2, w[p] = C12T @ in[p], or B1^T @ in[p] in 2D) left in device
// memory:
//
//   out[i*nkj + kj, e] = sum_p B0[p, i] * w[p*nkj + kj, e]
//
// with w (nm0, nkj, E) and out (nq0, nkj, E), element index fastest;
// nkj = nq2*nq1 in 3D and nq1 in 2D.  The contraction ignores kj, so the
// kernel reads w as (nm0, F) and out as (nq0, F), F = nkj*E.
//
// What bounds it on an H100: memory.  Each column of F reads nm0 values and
// writes nq0 (7 and 8 at nq=8^3) for 2*nm0*nq0 FLOP, under 2 FLOP per byte.
// The first design gave each thread one column and scalar accesses: 0.41
// ms at b05 nq=8^3 and b04 nq=8^2 in f32, 1.24 TB/s, while in f64 the same
// design moved twice the bytes in 0.44 ms (benchmarks/kernel_blocks.py
// --only k4diag), and neither padding the rows apart nor a pure read or
// write pass was the limit: it was the count of 4-byte accesses.  So:
//   - A thread owns U 16-byte vectors of F (U = 1, 2 or 4; 4 floats or 2
//     doubles each), 32 vectors apart so each load instruction of a warp
//     covers 512 contiguous bytes.  It issues all nm0*U loads before its
//     first FMA, then writes nq0*U vectors by 16-byte stores with the
//     streaming hint (st.global.cs), which keeps out of L2's way the lines
//     nothing reads again (plain stores, or the hint on the loads as well,
//     ran slower).  Where F*itemsize is not a multiple of 16 or w or out
//     is off a 16-byte boundary, it takes one value a step (W = 1, U = 1)
//     instead.
//   - The grid is one wave (the occupancy API's blocks an SM times the
//     SMs, kernels/bwdtrans3d.qp2_wave), capped at one tile of
//     QP2_THREADS*U vectors a block.  Block b owns vectors [b*nv/blocks,
//     (b+1)*nv/blocks) of the nv = F/W and walks them a tile a step, so
//     B0 (nm0 x nq0) is copied into shared memory once a block; every
//     thread of a warp reads the same B0 value (a broadcast).
//     kernels/bwdtrans3d.qp2_shares mirrors the rule.
//   - nm0 <= QP2_EXACT (every 3D order to 10^3) is a template argument, so
//     the nm0*U vectors stay in registers with no run-time guard; a larger
//     nm0 (2D orders to 32) takes p and i in chunks of QP2_CHUNK from
//     zero-padded B0, U = 1 or 2, w read once a chunk of 8 outputs (the
//     later chunks from L2).  No instance spills.
//   - bf16: w's values are widened to f32 as they are loaded (8 a 16-byte
//     vector), summed in f32 and each output rounded to bf16 once, where
//     the JAX kernel rounds its f32 sum (bwdtrans3d.py:195).  A vector of
//     8 values takes 8 registers, so U is 1 or 2 (1 chunked): a thread
//     holds as many registers of w as in f32 (kernels/bwdtrans3d.
//     qp2_unrolls).
constexpr int QP2_THREADS = 256;
constexpr int QP2_EXACT = 9;
constexpr int QP2_CHUNK = 8;

// B0's shared-memory layout: (nm0, nq0) for an exact nm0, else padded with
// zeros to whole chunks.
__host__ __device__ constexpr int qp2_rows(int p, int nm0) {
    return p ? nm0 : round_up(nm0, QP2_CHUNK);
}

__host__ __device__ constexpr int qp2_cols(int p, int nq0) {
    return p ? nq0 : round_up(nq0, QP2_CHUNK);
}

// One step of a thread: vectors t + 32u (u < U) of F, those below v1
// unless FULL.  P = nm0 (exact), all of w's values in registers, in the
// sum type A.
template <typename T, int W, int P, int U, bool FULL>
__device__ __forceinline__ void qp2_exact(const T* __restrict__ w,
                                          const T* s_b0, T* __restrict__ out,
                                          int nq0, long long f, long long t,
                                          long long v1) {
    using A = tbt::Acc<T>;
    A x[P][U][W];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long v = t + 32 * u;
            if (FULL || v < v1) {
                tbt::load_w(w + p * f + v * W, x[p][u]);
            } else {
#pragma unroll
                for (int c = 0; c < W; ++c) x[p][u][c] = A(0);
            }
        }
    for (int i = 0; i < nq0; ++i) {
        A acc[U][W];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int c = 0; c < W; ++c) acc[u][c] = A(0);
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const A b = tbt::widen(s_b0[p * nq0 + i]);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int c = 0; c < W; ++c)
                    acc[u][c] = fma(b, x[p][u][c], acc[u][c]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long v = t + 32 * u;
            if (FULL || v < v1) tbt::store_cs(out + i * f + v * W, acc[u]);
        }
    }
}

// The same step for a larger nm0: outputs in chunks of QP2_CHUNK, each
// summing p in chunks of QP2_CHUNK (B0 zero-padded, so only the loads of
// w past nm0 need a guard).  A later output chunk reads w again, from L2.
template <typename T, int W, int U, bool FULL>
__device__ __forceinline__ void qp2_chunked(const T* __restrict__ w,
                                            const T* s_b0,
                                            T* __restrict__ out, int nm0,
                                            int nq0, long long f, long long t,
                                            long long v1) {
    using A = tbt::Acc<T>;
    constexpr int C = QP2_CHUNK;
    const int nq0p = round_up(nq0, C);
    for (int i0 = 0; i0 < nq0; i0 += C) {
        A acc[C][U][W];
#pragma unroll
        for (int ii = 0; ii < C; ++ii)
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int c = 0; c < W; ++c) acc[ii][u][c] = A(0);
        for (int p0 = 0; p0 < nm0; p0 += C) {
            A x[C][U][W];
#pragma unroll
            for (int pp = 0; pp < C; ++pp)
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const long long v = t + 32 * u;
                    if (p0 + pp < nm0 && (FULL || v < v1)) {
                        tbt::load_w(w + (p0 + pp) * f + v * W, x[pp][u]);
                    } else {
#pragma unroll
                        for (int c = 0; c < W; ++c) x[pp][u][c] = A(0);
                    }
                }
#pragma unroll
            for (int pp = 0; pp < C; ++pp)
#pragma unroll
                for (int ii = 0; ii < C; ++ii) {
                    const A b = tbt::widen(s_b0[(p0 + pp) * nq0p + i0 + ii]);
#pragma unroll
                    for (int u = 0; u < U; ++u)
#pragma unroll
                        for (int c = 0; c < W; ++c)
                            acc[ii][u][c] = fma(b, x[pp][u][c], acc[ii][u][c]);
                }
        }
#pragma unroll
        for (int ii = 0; ii < C; ++ii) {
            if (i0 + ii >= nq0) break;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const long long v = t + 32 * u;
                if (FULL || v < v1)
                    tbt::store_cs(out + (i0 + ii) * f + v * W, acc[ii][u]);
            }
        }
    }
}

// Block b: vectors [b*nv/gridDim.x, (b+1)*nv/gridDim.x) of F in W-value
// units, a tile of QP2_THREADS*U vectors a step, warp k taking the tile's
// k-th run of 32*U vectors and lane l its vectors l + 32u.  P: nm0, or 0
// for the chunked form.
template <typename T, int W, int P, int U>
__global__ void __launch_bounds__(QP2_THREADS)
    qp_stage2_3d_kernel(const T* __restrict__ w, const T* __restrict__ b0,
                        T* __restrict__ out, int nm0, int nq0, long long f,
                        long long nv) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_b0 = reinterpret_cast<T*>(smem_raw);
    const int rows = qp2_rows(P, nm0), cols = qp2_cols(P, nq0);
    for (int q = threadIdx.x; q < rows * cols; q += QP2_THREADS) {
        const int p = q / cols, i = q % cols;
        s_b0[q] = p < nm0 && i < nq0 ? b0[p * nq0 + i] : tbt::narrow<T>(0);
    }
    __syncthreads();
    const long long v0 = blockIdx.x * nv / gridDim.x;
    const long long v1 = (blockIdx.x + 1LL) * nv / gridDim.x;
    for (long long t = v0 + threadIdx.x / 32 * (32 * U) + threadIdx.x % 32;
         t < v1; t += QP2_THREADS * U) {
        const bool full = t + 32 * (U - 1) < v1;
        if constexpr (P > 0) {
            if (full)
                qp2_exact<T, W, P, U, true>(w, s_b0, out, nq0, f, t, v1);
            else
                qp2_exact<T, W, P, U, false>(w, s_b0, out, nq0, f, t, v1);
        } else {
            if (full)
                qp2_chunked<T, W, U, true>(w, s_b0, out, nm0, nq0, f, t, v1);
            else
                qp2_chunked<T, W, U, false>(w, s_b0, out, nm0, nq0, f, t, v1);
        }
    }
}

// f(kernel, smem bytes) for the instance that serves (vector form, nm0,
// unroll); cudaErrorInvalidValue where none does.  The scalar form takes
// U = 1 whatever `unroll` says; the chunked form (nm0 > QP2_EXACT) has U =
// 1 or 2, and bf16's vector form (8 values) half of each
// (kernels/bwdtrans3d.qp2_unrolls).
template <typename T, int W, int P, typename F>
int qp2_with_unroll(int nm0, int nq0, int unroll, F&& f) {
    const size_t smem = sizeof(T) * static_cast<size_t>(qp2_rows(P, nm0)) *
                        qp2_cols(P, nq0);
    constexpr int TOP = (P > 0 ? 4 : 2) / (W == 8 ? 2 : 1);
    if constexpr (W == 1) {
        return f(qp_stage2_3d_kernel<T, W, P, 1>, smem);
    } else {
        switch (unroll) {
            case 1:
                return f(qp_stage2_3d_kernel<T, W, P, 1>, smem);
            case 2:
                if constexpr (TOP >= 2)
                    return f(qp_stage2_3d_kernel<T, W, P, 2>, smem);
                return cudaErrorInvalidValue;
            case 4:
                if constexpr (TOP >= 4)
                    return f(qp_stage2_3d_kernel<T, W, P, 4>, smem);
                return cudaErrorInvalidValue;
            default:
                return cudaErrorInvalidValue;
        }
    }
}

template <typename T, int W, typename F>
int qp2_with_order(int nm0, int nq0, int unroll, F&& f) {
    switch (nm0) {
        case 1: return qp2_with_unroll<T, W, 1>(nm0, nq0, unroll, f);
        case 2: return qp2_with_unroll<T, W, 2>(nm0, nq0, unroll, f);
        case 3: return qp2_with_unroll<T, W, 3>(nm0, nq0, unroll, f);
        case 4: return qp2_with_unroll<T, W, 4>(nm0, nq0, unroll, f);
        case 5: return qp2_with_unroll<T, W, 5>(nm0, nq0, unroll, f);
        case 6: return qp2_with_unroll<T, W, 6>(nm0, nq0, unroll, f);
        case 7: return qp2_with_unroll<T, W, 7>(nm0, nq0, unroll, f);
        case 8: return qp2_with_unroll<T, W, 8>(nm0, nq0, unroll, f);
        case 9: return qp2_with_unroll<T, W, 9>(nm0, nq0, unroll, f);
        default: return qp2_with_unroll<T, W, 0>(nm0, nq0, unroll, f);
    }
}

template <typename T, typename F>
int qp2_with_kernel(int vector, int nm0, int nq0, int unroll, F&& f) {
    if (nm0 < 1 || nq0 < 1) return cudaErrorInvalidValue;
    if (vector)
        return qp2_with_order<T, tbt::Vec16<T>::width>(nm0, nq0, unroll, f);
    return qp2_with_order<T, 1>(nm0, nq0, unroll, f);
}

// vector: F*itemsize a multiple of 16 and w and out on 16-byte boundaries
// (refused otherwise); blocks: the grid (kernels/bwdtrans3d.qp2_grid).
template <typename T>
int launch_qp_stage2(const T* w, const T* b0, T* out, int nm0, int nq0,
                     long long f, int unroll, int vector, int blocks,
                     cudaStream_t stream) {
    if (f <= 0) return cudaSuccess;
    constexpr int W = tbt::Vec16<T>::width;
    if (blocks < 1 || (vector && (f % W != 0 || !tbt::aligned16(w) ||
                                  !tbt::aligned16(out))))
        return cudaErrorInvalidValue;
    const long long nv = vector ? f / W : f;
    return qp2_with_kernel<T>(
        vector, nm0, nq0, unroll, [&](auto kernel, size_t smem) {
            kernel<<<blocks, QP2_THREADS, smem, stream>>>(w, b0, out, nm0,
                                                         nq0, f, nv);
            return static_cast<int>(cudaGetLastError());
        });
}

// Blocks of the instance for (vector, nm0, nq0, unroll) the card holds at
// once: the occupancy API's blocks an SM times the SMs; -1 on an error.
template <typename T>
int qp2_wave(int vector, int nm0, int nq0, int unroll) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        return -1;
    int per_sm = -1;
    const int err = qp2_with_kernel<T>(
        vector, nm0, nq0, unroll, [&](auto kernel, size_t smem) {
            return static_cast<int>(
                cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kernel, QP2_THREADS, smem));
        });
    return err == cudaSuccess ? per_sm * sms : -1;
}

}  // namespace

extern "C" int tbt_qp_stage2_3d_f32(const void* w, const void* b0, void* out,
                                    int nm0, int nq0, long long f, int unroll,
                                    int vector, int blocks, void* stream) {
    return launch_qp_stage2(static_cast<const float*>(w),
                            static_cast<const float*>(b0),
                            static_cast<float*>(out), nm0, nq0, f, unroll,
                            vector, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_stage2_3d_f64(const void* w, const void* b0, void* out,
                                    int nm0, int nq0, long long f, int unroll,
                                    int vector, int blocks, void* stream) {
    return launch_qp_stage2(static_cast<const double*>(w),
                            static_cast<const double*>(b0),
                            static_cast<double*>(out), nm0, nq0, f, unroll,
                            vector, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_stage2_3d_bf16(const void* w, const void* b0,
                                     void* out, int nm0, int nq0, long long f,
                                     int unroll, int vector, int blocks,
                                     void* stream) {
    return launch_qp_stage2(static_cast<const tbt::bf16*>(w),
                            static_cast<const tbt::bf16*>(b0),
                            static_cast<tbt::bf16*>(out), nm0, nq0, f, unroll,
                            vector, blocks, static_cast<cudaStream_t>(stream));
}

// K4's blocks in one wave for (itemsize, vector form, nm0, nq0, unroll).
extern "C" int tbt_qp_stage2_wave(int itemsize, int vector, int nm0, int nq0,
                                  int unroll) {
    switch (itemsize) {
        case 2: return qp2_wave<tbt::bf16>(vector, nm0, nq0, unroll);
        case 4: return qp2_wave<float>(vector, nm0, nq0, unroll);
        default: return qp2_wave<double>(vector, nm0, nq0, unroll);
    }
}

extern "C" int tbt_qp_fused3d_f32(const void* in, const void* b0,
                                  const void* c12t, void* out, int nm0,
                                  int nrq, int nq0, int nkj, long long n_elem,
                                  int et, int g, int depth, int threads,
                                  int body, void* stream) {
    return launch(static_cast<const float*>(in), static_cast<const float*>(b0),
                  static_cast<const float*>(c12t), static_cast<float*>(out),
                  nm0, nrq, nq0, nkj, n_elem, et, g, depth, threads, body,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_fused3d_f64(const void* in, const void* b0,
                                  const void* c12t, void* out, int nm0,
                                  int nrq, int nq0, int nkj, long long n_elem,
                                  int et, int g, int depth, int threads,
                                  int body, void* stream) {
    return launch(static_cast<const double*>(in),
                  static_cast<const double*>(b0),
                  static_cast<const double*>(c12t), static_cast<double*>(out),
                  nm0, nrq, nq0, nkj, n_elem, et, g, depth, threads, body,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_fused3d_bf16(const void* in, const void* b0,
                                   const void* c12t, void* out, int nm0,
                                   int nrq, int nq0, int nkj, long long n_elem,
                                   int et, int g, int depth, int threads,
                                   int body, void* stream) {
    return launch(static_cast<const tbt::bf16*>(in),
                  static_cast<const tbt::bf16*>(b0),
                  static_cast<const tbt::bf16*>(c12t),
                  static_cast<tbt::bf16*>(out), nm0, nrq, nq0, nkj, n_elem,
                  et, g, depth, threads, body,
                  static_cast<cudaStream_t>(stream));
}

// Shared memory of one K1 block of element tile et, g planes a pass,
// `depth` slab slots and stage-2 body `body` (QP_SIMT, QP_DMMA or
// QP_DMMA_HELD).
extern "C" long long tbt_qp_fused3d_smem(int itemsize, int et, int g,
                                         int nm0, int nrq, int nq0, int nkj,
                                         int depth, int body) {
    const QPBody b = body == QP_DMMA        ? QP_DMMA
                     : body == QP_DMMA_HELD ? QP_DMMA_HELD
                                            : QP_SIMT;
    switch (itemsize) {
        case 2:
            return static_cast<long long>(qp_smem_bytes<tbt::bf16>(
                et, g, nm0, nrq, nq0, nkj, depth, b));
        case 4:
            return static_cast<long long>(
                qp_smem_bytes<float>(et, g, nm0, nrq, nq0, nkj, depth, b));
        default:
            return static_cast<long long>(
                qp_smem_bytes<double>(et, g, nm0, nrq, nq0, nkj, depth, b));
    }
}

extern "C" const char* tbt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
