// K2 kron_blocked and K3 em_gemm: tiled FMA GEMMs over the element stream.
//
// K2 replaces the Pallas kernel tpu_bench/kernels/bwdtrans2d.py:kron_blocked
// (_kron_blk_kernel), benchmark05's Pallas(Coales) column from nq=8^3 up,
// and stage 1 of Pallas(QP) (tpu_bench/kernels/bwdtrans3d.py:qp_global3d,
// _stage1_kernel3d: w[p] = C12T @ in[p]):
//
//   out[b] (nqTot x ce) = C (nqTot x nmTot) @ in[b] (nmTot x ce)
//
// for every contiguous element chunk b, one chunk per blockIdx.z.
//
// K3 replaces tpu_bench/kernels/bwdtrans2d.py:kron_elem_major
// (_kron_em_kernel, Pallas(Uncoales)) and _one_stage_em (_stage_em_kernel,
// the three stages of Pallas(QP-1D)): the element-major product
//
//   out (E x N) = X (E x K) @ S (K x N),  elements on rows.
//
// What bounds them on an H100: FMA issue.  The kron form does 2*nqTot*nmTot
// FLOP per element (351,232 at nq=8^3) for the same 4*(343 + 512) bytes
// the fused form moves, about 100 FLOP per byte in f32, far above the
// card's FP32 FMA-to-bandwidth ratio; each QP-1D stage is as dense.  The
// design is one plain tiled GEMM on the CUDA cores in full FP32/FP64 FMA
// (never TF32: the f32 columns are held to 5e-4 of each other):
//   - 128 x 128 output tiles, K in steps of 8, both operand tiles staged
//     in shared memory, the A tile transposed to [k][m], an 8 x 8 register
//     micro-tile per thread (256 threads) fed by 16-byte shared loads:
//     64 FMAs per 4 loads (f32);
//   - tile order: the blocks that share the large operand run together and
//     find it in L2.  K2's large operand is the element chunk (B), so M
//     tiles go on blockIdx.x and C (0.7 MB at nq=8^3 f32) stays in L2.
//     K3's is the element strip of X (A), so the N tiles of one strip are
//     neighbours in a 1D grid and S stays in L2;
//   - M, N and K edges masked: nqTot=512, nmTot=343 and the QP-1D widths
//     392 and 448 are not tile multiples, and E need not be one (the
//     Pallas kernels needed E % epb == 0).
// The element-major read of X runs along K: eight threads read the eight
// consecutive k of one row (one 32-byte sector), four rows per warp.
// Tensor cores (wgmma on TF32 splits or DMMA for f64), TMA, deeper
// pipelining and the kron structure of the QP-1D operators are later work.

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

// c[m0:m0+BM, n0:n0+BN] = a (m_rows x k_depth) @ b (k_depth x n_cols), all
// row-major, by one block of THREADS threads.
template <typename T>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          T* __restrict__ c, int m_rows,
                                          int k_depth, int n_cols, int m0,
                                          int n0) {
    __shared__ __align__(16) T a_tile[BK][BM + PAD];  // A tile as [k][m]
    __shared__ __align__(16) T b_tile[BK][BN + PAD];
    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);

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
                               ? a[static_cast<size_t>(m0 + m) * k_depth +
                                   k0 + k]
                               : T(0);
        }
#pragma unroll
        for (int r = 0; r < BK * BN / THREADS; ++r) {
            const int t = threadIdx.x + r * THREADS;
            const int k = t / BN, n = t % BN;
            b_tile[k][n] = (k0 + k < k_depth && n0 + n < n_cols)
                               ? b[static_cast<size_t>(k0 + k) * n_cols +
                                   n0 + n]
                               : T(0);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            T av[TM], bv[TN];
#pragma unroll
            for (int q = 0; q < TM; q += 4)
                tbt::load4(&a_tile[k][ty * TM + q], av + q);
#pragma unroll
            for (int q = 0; q < TN; q += 4)
                tbt::load4(&b_tile[k][tx * TN + q], bv + q);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fma(av[i], bv[j], acc[i][j]);
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
            if (n < n_cols) c[static_cast<size_t>(m) * n_cols + n] = acc[i][j];
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    kron_blocked_kernel(const T* __restrict__ c, const T* __restrict__ in,
                        T* __restrict__ out, int m_rows, int k_depth,
                        int n_cols) {
    const size_t chunk = blockIdx.z;
    gemm_tile(c, in + chunk * k_depth * n_cols, out + chunk * m_rows * n_cols,
              m_rows, k_depth, n_cols, blockIdx.x * BM, blockIdx.y * BN);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    em_gemm_kernel(const T* __restrict__ x, const T* __restrict__ s,
                   T* __restrict__ out, int e_rows, int k_depth, int n_cols) {
    const int n_tiles = (n_cols + BN - 1) / BN;
    const int m0 = static_cast<int>(blockIdx.x / n_tiles) * BM;
    const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;
    gemm_tile(x, s, out, e_rows, k_depth, n_cols, m0, n0);
}

template <typename T>
int launch_kron_blocked(const T* c, const T* in, T* out, int m_rows,
                        int k_depth, int n_cols, int n_chunks,
                        cudaStream_t stream) {
    if (m_rows <= 0 || n_cols <= 0 || n_chunks <= 0) return cudaSuccess;
    const dim3 grid((m_rows + BM - 1) / BM, (n_cols + BN - 1) / BN, n_chunks);
    kron_blocked_kernel<T><<<grid, THREADS, 0, stream>>>(c, in, out, m_rows,
                                                          k_depth, n_cols);
    return cudaGetLastError();
}

template <typename T>
int launch_em_gemm(const T* x, const T* s, T* out, int e_rows, int k_depth,
                   int n_cols, cudaStream_t stream) {
    if (e_rows <= 0 || n_cols <= 0) return cudaSuccess;
    const long long tiles = static_cast<long long>((e_rows + BM - 1) / BM) *
                            ((n_cols + BN - 1) / BN);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    em_gemm_kernel<T><<<static_cast<unsigned>(tiles), THREADS, 0, stream>>>(
        x, s, out, e_rows, k_depth, n_cols);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_kron_blocked_f32(const void* c, const void* in, void* out,
                                    int m_rows, int k_depth, int n_cols,
                                    int n_chunks, void* stream) {
    return launch_kron_blocked(
        static_cast<const float*>(c), static_cast<const float*>(in),
        static_cast<float*>(out), m_rows, k_depth, n_cols, n_chunks,
        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_kron_blocked_f64(const void* c, const void* in, void* out,
                                    int m_rows, int k_depth, int n_cols,
                                    int n_chunks, void* stream) {
    return launch_kron_blocked(
        static_cast<const double*>(c), static_cast<const double*>(in),
        static_cast<double*>(out), m_rows, k_depth, n_cols, n_chunks,
        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_em_gemm_f32(const void* x, const void* s, void* out,
                               int e_rows, int k_depth, int n_cols,
                               void* stream) {
    return launch_em_gemm(static_cast<const float*>(x),
                          static_cast<const float*>(s),
                          static_cast<float*>(out), e_rows, k_depth, n_cols,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_em_gemm_f64(const void* x, const void* s, void* out,
                               int e_rows, int k_depth, int n_cols,
                               void* stream) {
    return launch_em_gemm(static_cast<const double*>(x),
                          static_cast<const double*>(s),
                          static_cast<double*>(out), e_rows, k_depth, n_cols,
                          static_cast<cudaStream_t>(stream));
}
