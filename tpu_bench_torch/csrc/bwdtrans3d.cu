// K1 qp_fused3d's entries (tbt_qp_fused3d_<dtype>; the kernel and its
// launchers are csrc/qp_fused3d.cuh, its probe form's entries
// csrc/qp_fused3d_probe.cu), and K4 qp_stage2_3d, stage 2 of its
// two-kernel form.
//
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
#include <cuda_runtime.h>

#include "common.cuh"
#include "qp_fused3d.cuh"

namespace {

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
    return launch<float, false>(
        static_cast<const float*>(in), static_cast<const float*>(b0),
        static_cast<const float*>(c12t), static_cast<float*>(out), nm0, nrq,
        nq0, nkj, n_elem, et, g, depth, threads, body,
        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_fused3d_f64(const void* in, const void* b0,
                                  const void* c12t, void* out, int nm0,
                                  int nrq, int nq0, int nkj, long long n_elem,
                                  int et, int g, int depth, int threads,
                                  int body, void* stream) {
    return launch<double, false>(
        static_cast<const double*>(in), static_cast<const double*>(b0),
        static_cast<const double*>(c12t), static_cast<double*>(out), nm0, nrq,
        nq0, nkj, n_elem, et, g, depth, threads, body,
        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp_fused3d_bf16(const void* in, const void* b0,
                                   const void* c12t, void* out, int nm0,
                                   int nrq, int nq0, int nkj, long long n_elem,
                                   int et, int g, int depth, int threads,
                                   int body, void* stream) {
    return launch<tbt::bf16, false>(
        static_cast<const tbt::bf16*>(in), static_cast<const tbt::bf16*>(b0),
        static_cast<const tbt::bf16*>(c12t), static_cast<tbt::bf16*>(out),
        nm0, nrq, nq0, nkj, n_elem, et, g, depth, threads, body,
        static_cast<cudaStream_t>(stream));
}

// Shared memory of one K1 block of element tile et, g planes a pass,
// `depth` slab slots and stage-2 body `body` (QP_SIMT, QP_DMMA,
// QP_DMMA_HELD, QP_DMMA_S1, QP_HMMA or QP_TF32).
extern "C" long long tbt_qp_fused3d_smem(int itemsize, int et, int g,
                                         int nm0, int nrq, int nq0, int nkj,
                                         int depth, int body) {
    const QPBody b = body == QP_DMMA        ? QP_DMMA
                     : body == QP_DMMA_HELD ? QP_DMMA_HELD
                     : body == QP_DMMA_S1   ? QP_DMMA_S1
                     : body == QP_HMMA      ? QP_HMMA
                     : body == QP_TF32      ? QP_TF32
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
