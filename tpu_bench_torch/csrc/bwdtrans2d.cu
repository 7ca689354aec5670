// K2 kron_blocked: the dense kron-operator GEMM over element chunks.
//
// Replaces the Pallas kernel tpu_bench/kernels/bwdtrans2d.py:kron_blocked
// (_kron_blk_kernel), benchmark05's Pallas(Coales) column from nq=8^3 up:
//
//   out[b] (nqTot x ce) = C (nqTot x nmTot) @ in[b] (nmTot x ce)
//
// for every contiguous element chunk b, one chunk per blockIdx.z.
//
// What bounds it on an H100: FMA issue.  The kron form does 2*nqTot*nmTot
// FLOP per element (351,232 at nq=8^3) for the same 4*(343 + 512) bytes
// the fused form moves, about 100 FLOP per byte in f32, far above the
// card's FP32 FMA-to-bandwidth ratio.  The design is a plain tiled GEMM on
// the CUDA cores in full FP32/FP64 FMA (never TF32: the f32 columns are
// held to 5e-4 of each other):
//   - 128 x 128 output tiles, K in steps of 8, both operand tiles staged
//     in shared memory, an 8 x 8 register micro-tile per thread (256
//     threads) fed by 16-byte shared loads: 64 FMAs per 4 loads (f32);
//   - M tiles on blockIdx.x, so the blocks that share one input strip run
//     together and find it in L2; C (0.7 MB at nq=8^3 f32) stays in L2;
//   - M, N and K edges masked: nqTot=512 and nmTot=343 at nq=8^3 are not
//     tile multiples.
// Tensor cores (wgmma on TF32 splits or DMMA for f64), TMA and deeper
// pipelining are later work.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps rows 16-byte aligned and spreads the stores

template <typename T>
__global__ void __launch_bounds__(THREADS)
    kron_blocked_kernel(const T* __restrict__ c, const T* __restrict__ in,
                        T* __restrict__ out, int m_rows, int k_depth,
                        int n_cols) {
    __shared__ __align__(16) T a_tile[BK][BM + PAD];  // C tile as [k][m]
    __shared__ __align__(16) T b_tile[BK][BN + PAD];
    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const size_t chunk = blockIdx.z;
    const T* in_b = in + chunk * k_depth * n_cols;
    T* out_b = out + chunk * m_rows * n_cols;

    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

    for (int k0 = 0; k0 < k_depth; k0 += BK) {
#pragma unroll
        for (int r = 0; r < BM * BK / THREADS; ++r) {
            const int t = threadIdx.x + r * THREADS;
            const int m = t / BK, k = t % BK;
            a_tile[k][m] = (m0 + m < m_rows && k0 + k < k_depth)
                               ? c[static_cast<size_t>(m0 + m) * k_depth +
                                   k0 + k]
                               : T(0);
        }
#pragma unroll
        for (int r = 0; r < BK * BN / THREADS; ++r) {
            const int t = threadIdx.x + r * THREADS;
            const int k = t / BN, n = t % BN;
            b_tile[k][n] = (k0 + k < k_depth && n0 + n < n_cols)
                               ? in_b[static_cast<size_t>(k0 + k) * n_cols +
                                      n0 + n]
                               : T(0);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            T a[TM], b[TN];
#pragma unroll
            for (int q = 0; q < TM; q += 4)
                tbt::load4(&a_tile[k][ty * TM + q], a + q);
#pragma unroll
            for (int q = 0; q < TN; q += 4)
                tbt::load4(&b_tile[k][tx * TN + q], b + q);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty * TM + i;
        if (m >= m_rows) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx * TN + j;
            if (n < n_cols)
                out_b[static_cast<size_t>(m) * n_cols + n] = acc[i][j];
        }
    }
}

template <typename T>
int launch(const T* c, const T* in, T* out, int m_rows, int k_depth,
           int n_cols, int n_chunks, cudaStream_t stream) {
    if (m_rows <= 0 || n_cols <= 0 || n_chunks <= 0) return cudaSuccess;
    const dim3 grid((m_rows + BM - 1) / BM, (n_cols + BN - 1) / BN, n_chunks);
    kron_blocked_kernel<T><<<grid, THREADS, 0, stream>>>(c, in, out, m_rows,
                                                          k_depth, n_cols);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_kron_blocked_f32(const void* c, const void* in, void* out,
                                    int m_rows, int k_depth, int n_cols,
                                    int n_chunks, void* stream) {
    return launch(static_cast<const float*>(c), static_cast<const float*>(in),
                  static_cast<float*>(out), m_rows, k_depth, n_cols, n_chunks,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_kron_blocked_f64(const void* c, const void* in, void* out,
                                    int m_rows, int k_depth, int n_cols,
                                    int n_chunks, void* stream) {
    return launch(static_cast<const double*>(c),
                  static_cast<const double*>(in), static_cast<double*>(out),
                  m_rows, k_depth, n_cols, n_chunks,
                  static_cast<cudaStream_t>(stream));
}
