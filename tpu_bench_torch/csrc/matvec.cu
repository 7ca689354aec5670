// K8 matvec_rm and K9 matvec_cm: y = A x for a dense matrix streamed once.
//
// K8 replaces tpu_bench/kernels/matvec.py:matvec_vpu (_vpu_kernel, b03
// Pallas(vpu): (BM, BN) tiles of row-major A times the matching slice of
// x, row sums accumulated over the column blocks) and, built in double,
// tpu_bench/kernels/df2stream.py:matvec_pair_rm:
//
//   y[i] = sum_j A[i, j] x[j],   A (M, N) row-major.
//
// K9 replaces tpu_bench/kernels/matvec.py:matvec_mxu (_mxu_kernel, b03
// Pallas(mxu): y^T = x^T A_cm accumulated over K blocks) and
// df2stream.py:matvec_pair_cm:
//
//   y[i] = sum_j A_cm[j, i] x[j],   A_cm (N, M) = A^T.
//
// What bounds them on an H100: bytes.  Two FLOP per element of A against 4
// (f32) or 8 (f64) bytes; reading A once at 3.35 TB/s is the least time
// (x and y are 1/N and 1/M of it).  The designs:
//   - K8: one warp per row, eight rows per block.  The lanes walk the row
//     in 16-byte vectors (float4 / double2) of A and of x, UNROLL vectors
//     in flight, and a shuffle tree sums the lanes.  x is read by every
//     warp and stays in L1/L2.  When a row is not a whole number of
//     16-byte vectors (N * itemsize % 16 != 0) or A or x is not 16-byte
//     aligned, the kernel takes scalar loads;
//   - K9: threads run along i, so a warp reads 32 consecutive elements of
//     a row of A_cm: coalesced.  One thread per output column gives only
//     M / 256 blocks (64 at M = 16384, for 132 SMs), so the rows j are
//     split into chunks across blockIdx.y, enough for about eight blocks
//     per SM, and each block atomicAdds its partial sums into y, which the
//     wrapper zeroed.  The atomics land in another order on every run, so
//     an f32 y varies in its last bits.
// The TPU kernels needed the MXU / VPU tile geometry; here neither uses the
// tensor cores, which a bandwidth-bound matvec does not need.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;  // K8: one warp per row
constexpr int UNROLL = 4;
constexpr int CM_TARGET_BLOCKS = 8 * 132;  // K9: about eight per SM

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    matvec_rm_kernel(const T* __restrict__ a, const T* __restrict__ x,
                     T* __restrict__ y, int m, int n) {
    const int lane = threadIdx.x % 32;
    const long long row =
        static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / 32;
    if (row >= m) return;  // whole warps leave together
    const T* __restrict__ ar = a + row * n;
    T acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = T(0);
    if constexpr (VECTOR) {
        using V = typename tbt::Vec16<T>::type;
        const V* __restrict__ av = reinterpret_cast<const V*>(ar);
        const V* __restrict__ xv = reinterpret_cast<const V*>(x);
        const int nv = n / tbt::Vec16<T>::width;
        int j = lane;
        for (; j + (UNROLL - 1) * 32 < nv; j += UNROLL * 32) {
            V va[UNROLL], vx[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                va[u] = av[j + u * 32];
                vx[u] = xv[j + u * 32];
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                acc[u] = tbt::dot_lanes(va[u], vx[u], acc[u]);
        }
        for (; j < nv; j += 32) acc[0] = tbt::dot_lanes(av[j], xv[j], acc[0]);
    } else {
        int j = lane;
        for (; j + (UNROLL - 1) * 32 < n; j += UNROLL * 32) {
            T va[UNROLL], vx[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                va[u] = ar[j + u * 32];
                vx[u] = x[j + u * 32];
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) acc[u] = fma(va[u], vx[u], acc[u]);
        }
        for (; j < n; j += 32) acc[0] = fma(ar[j], x[j], acc[0]);
    }
    const T s = tbt::warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if (lane == 0) y[row] = s;
}

// Rows [blockIdx.y * rows_per_split, + rows_per_split) of A_cm, column i =
// this thread's; the partial sum is added into y[i].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    matvec_cm_kernel(const T* __restrict__ a_cm, const T* __restrict__ x,
                     T* __restrict__ y, int n_rows, int m_cols,
                     int rows_per_split) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m_cols) return;
    const int j0 = blockIdx.y * rows_per_split;
    const int j1 = min(j0 + rows_per_split, n_rows);
    const T* __restrict__ col = a_cm + i;
    T acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = T(0);
    int j = j0;
    for (; j + UNROLL <= j1; j += UNROLL) {
        T va[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            va[u] = col[static_cast<long long>(j + u) * m_cols];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[u] = fma(va[u], x[j + u], acc[u]);
    }
    for (; j < j1; ++j)
        acc[0] = fma(col[static_cast<long long>(j) * m_cols], x[j], acc[0]);
    atomicAdd(y + i, (acc[0] + acc[1]) + (acc[2] + acc[3]));
}

template <typename T>
int launch_matvec_rm(const T* a, const T* x, T* y, int m, int n,
                     cudaStream_t stream) {
    if (m < 0 || n < 0) return cudaErrorInvalidValue;
    if (m == 0) return cudaSuccess;
    const unsigned blocks = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    const bool vector = n % tbt::Vec16<T>::width == 0 && tbt::aligned16(a) &&
                        tbt::aligned16(x);
    if (vector)
        matvec_rm_kernel<T, true><<<blocks, THREADS, 0, stream>>>(a, x, y, m,
                                                                  n);
    else
        matvec_rm_kernel<T, false><<<blocks, THREADS, 0, stream>>>(a, x, y, m,
                                                                   n);
    return cudaGetLastError();
}

// y must hold zeros: every block adds into it.
template <typename T>
int launch_matvec_cm(const T* a_cm, const T* x, T* y, int n_rows, int m_cols,
                     cudaStream_t stream) {
    if (n_rows < 0 || m_cols < 0) return cudaErrorInvalidValue;
    if (n_rows == 0 || m_cols == 0) return cudaSuccess;
    const int blocks_x = (m_cols + THREADS - 1) / THREADS;
    int splits = (CM_TARGET_BLOCKS + blocks_x - 1) / blocks_x;
    // at least 8 * UNROLL rows per split
    const int max_splits = (n_rows + 8 * UNROLL - 1) / (8 * UNROLL);
    if (splits > max_splits) splits = max_splits;
    const int rows_per_split = (n_rows + splits - 1) / splits;
    splits = (n_rows + rows_per_split - 1) / rows_per_split;
    const dim3 grid(blocks_x, splits);
    matvec_cm_kernel<T><<<grid, THREADS, 0, stream>>>(a_cm, x, y, n_rows,
                                                      m_cols, rows_per_split);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tbt_matvec_rm_f32(const void* a, const void* x, void* y, int m,
                                 int n, void* stream) {
    return launch_matvec_rm(static_cast<const float*>(a),
                            static_cast<const float*>(x),
                            static_cast<float*>(y), m, n,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_matvec_rm_f64(const void* a, const void* x, void* y, int m,
                                 int n, void* stream) {
    return launch_matvec_rm(static_cast<const double*>(a),
                            static_cast<const double*>(x),
                            static_cast<double*>(y), m, n,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_matvec_cm_f32(const void* a_cm, const void* x, void* y,
                                 int n_rows, int m_cols, void* stream) {
    return launch_matvec_cm(static_cast<const float*>(a_cm),
                            static_cast<const float*>(x),
                            static_cast<float*>(y), n_rows, m_cols,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_matvec_cm_f64(const void* a_cm, const void* x, void* y,
                                 int n_rows, int m_cols, void* stream) {
    return launch_matvec_cm(static_cast<const double*>(a_cm),
                            static_cast<const double*>(x),
                            static_cast<double*>(y), n_rows, m_cols,
                            static_cast<cudaStream_t>(stream));
}
