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
//   - K9: a block owns 32 * V consecutive output columns (V = 4 floats or
//     2 doubles: 512 bytes of each row of A_cm) and a share of the rows;
//     each lane takes one 16-byte vector of columns, and the block's eight
//     warps take every eighth row of the share, UNROLL rows in flight (8
//     by default: 128 bytes a thread; kernels/matvec.py CM_UNROLL).  Where
//     M * itemsize is not a multiple of 16 or A_cm is not 16-byte aligned,
//     each lane takes V columns 32 apart in scalar loads.  The grid is one
//     wave: the column blocks times `splits` row shares, as many shares as
//     fit the blocks the card holds at once (the occupancy API times the
//     SMs, tbt_matvec_cm_blocks; kernels/matvec.cm_splits), share s being
//     rows [s * N / splits, (s + 1) * N / splits), so every block reads the
//     same bytes to within one row.  The warps' sums are added in shared
//     memory; with one share they are y, else each share's go into a
//     workspace row and a second pass adds the shares in order.  No
//     atomics, so y is the same bits on every run.
// The TPU kernels needed the MXU / VPU tile geometry; here neither uses the
// tensor cores, which a bandwidth-bound matvec does not need.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;  // K8: one warp per row
constexpr int UNROLL = 4;
constexpr int CM_WARPS = THREADS / 32;  // K9: warps sharing a column block

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

// Block b: column block b % col_blocks (32 * V columns from c0), rows of
// share s = b / col_blocks; the warps' sums go to part[s * m_cols + i].
template <typename T, bool VECTOR, int ROWS>
__global__ void __launch_bounds__(THREADS)
    matvec_cm_kernel(const T* __restrict__ a_cm, const T* __restrict__ x,
                     T* __restrict__ part, int n_rows, int m_cols,
                     int col_blocks, int splits) {
    constexpr int V = tbt::Vec16<T>::width, CB = 32 * V;
    __shared__ T red[CM_WARPS][CB];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int s = blockIdx.x / col_blocks;
    const int c0 = (blockIdx.x % col_blocks) * CB;
    const int j0 =
        static_cast<int>(static_cast<long long>(s) * n_rows / splits);
    const int j1 =
        static_cast<int>(static_cast<long long>(s + 1) * n_rows / splits);
    // this lane's V columns: c0 + lane * V + v (VECTOR), else c0 + lane + 32v
    T acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = T(0);
    int j = j0 + warp;
    if constexpr (VECTOR) {
        using VT = typename tbt::Vec16<T>::type;
        const int col = c0 + lane * V;
        if (col < m_cols) {  // m_cols % V == 0: a vector is wholly in or out
            const T* __restrict__ base = a_cm + col;
            for (; j + (ROWS - 1) * CM_WARPS < j1; j += ROWS * CM_WARPS) {
                VT va[ROWS];
                T xv[ROWS];
#pragma unroll
                for (int u = 0; u < ROWS; ++u) {
                    va[u] = *reinterpret_cast<const VT*>(
                        base + static_cast<long long>(j + u * CM_WARPS) *
                                   m_cols);
                    xv[u] = x[j + u * CM_WARPS];
                }
#pragma unroll
                for (int u = 0; u < ROWS; ++u)
                    tbt::fma_lanes(va[u], xv[u], acc);
            }
            for (; j < j1; j += CM_WARPS)
                tbt::fma_lanes(*reinterpret_cast<const VT*>(
                                   base + static_cast<long long>(j) * m_cols),
                               x[j], acc);
        }
    } else {
        bool live[V];
#pragma unroll
        for (int v = 0; v < V; ++v) live[v] = c0 + lane + 32 * v < m_cols;
        const T* __restrict__ base = a_cm + c0 + lane;
        for (; j + (ROWS - 1) * CM_WARPS < j1; j += ROWS * CM_WARPS) {
            T va[ROWS][V], xv[ROWS];
#pragma unroll
            for (int u = 0; u < ROWS; ++u) {
                const T* row =
                    base + static_cast<long long>(j + u * CM_WARPS) * m_cols;
#pragma unroll
                for (int v = 0; v < V; ++v)
                    va[u][v] = live[v] ? row[32 * v] : T(0);
                xv[u] = x[j + u * CM_WARPS];
            }
#pragma unroll
            for (int u = 0; u < ROWS; ++u)
#pragma unroll
                for (int v = 0; v < V; ++v)
                    acc[v] = fma(va[u][v], xv[u], acc[v]);
        }
        for (; j < j1; j += CM_WARPS) {
            const T* row = base + static_cast<long long>(j) * m_cols;
#pragma unroll
            for (int v = 0; v < V; ++v)
                if (live[v]) acc[v] = fma(row[32 * v], x[j], acc[v]);
        }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
        red[warp][VECTOR ? lane * V + v : lane + 32 * v] = acc[v];
    __syncthreads();
    for (int c = threadIdx.x; c < CB; c += THREADS) {
        T sum = red[0][c];
#pragma unroll
        for (int w = 1; w < CM_WARPS; ++w) sum += red[w][c];
        if (c0 + c < m_cols)
            part[static_cast<long long>(s) * m_cols + c0 + c] = sum;
    }
}

// y[i] = the shares' sums of column i, added in share order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    matvec_cm_sum_kernel(const T* __restrict__ part, T* __restrict__ y,
                         int m_cols, int splits) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m_cols) return;
    T sum = part[i];
    for (int s = 1; s < splits; ++s)
        sum += part[static_cast<long long>(s) * m_cols + i];
    y[i] = sum;
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

template <typename T, bool VECTOR, int ROWS>
int launch_cm(const T* a_cm, const T* x, T* y, T* ws, int n_rows,
              int m_cols, int splits, cudaStream_t stream) {
    constexpr int CB = 32 * tbt::Vec16<T>::width;
    const int col_blocks = (m_cols + CB - 1) / CB;
    const long long blocks = static_cast<long long>(col_blocks) * splits;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    T* part = splits > 1 ? ws : y;
    matvec_cm_kernel<T, VECTOR, ROWS>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
            a_cm, x, part, n_rows, m_cols, col_blocks, splits);
    if (splits > 1)
        matvec_cm_sum_kernel<T><<<(m_cols + THREADS - 1) / THREADS, THREADS,
                                  0, stream>>>(ws, y, m_cols, splits);
    return cudaGetLastError();
}

// rows: the rows in flight (4, 8 or 16); splits >= 1 row shares, ws their
// workspace (splits x m_cols; unused for one share).
template <typename T>
int launch_matvec_cm(const T* a_cm, const T* x, T* y, T* ws, int n_rows,
                     int m_cols, int splits, int rows, cudaStream_t stream) {
    if (n_rows < 0 || m_cols < 0 || splits < 1) return cudaErrorInvalidValue;
    if (m_cols == 0) return cudaSuccess;
    const bool vector =
        m_cols % tbt::Vec16<T>::width == 0 && tbt::aligned16(a_cm);
    switch (rows * 2 + vector) {
        case 8:
            return launch_cm<T, false, 4>(
                a_cm, x, y, ws, n_rows, m_cols, splits, stream);
        case 9:
            return launch_cm<T, true, 4>(
                a_cm, x, y, ws, n_rows, m_cols, splits, stream);
        case 16:
            return launch_cm<T, false, 8>(
                a_cm, x, y, ws, n_rows, m_cols, splits, stream);
        case 17:
            return launch_cm<T, true, 8>(
                a_cm, x, y, ws, n_rows, m_cols, splits, stream);
        case 32:
            return launch_cm<T, false, 16>(
                a_cm, x, y, ws, n_rows, m_cols, splits, stream);
        case 33:
            return launch_cm<T, true, 16>(
                a_cm, x, y, ws, n_rows, m_cols, splits, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// Blocks of the vector form at `rows` rows in flight that the card holds
// at once: the occupancy API's blocks an SM times the SMs.
template <typename T, int ROWS>
int cm_blocks() {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, matvec_cm_kernel<T, true, ROWS>, THREADS, 0) !=
            cudaSuccess)
        return -1;
    return per_sm * sms;
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

extern "C" int tbt_matvec_cm_blocks(int itemsize, int rows) {
    switch (rows * 16 + itemsize) {
        case 4 * 16 + 4:
            return cm_blocks<float, 4>();
        case 8 * 16 + 4:
            return cm_blocks<float, 8>();
        case 16 * 16 + 4:
            return cm_blocks<float, 16>();
        case 4 * 16 + 8:
            return cm_blocks<double, 4>();
        case 8 * 16 + 8:
            return cm_blocks<double, 8>();
        case 16 * 16 + 8:
            return cm_blocks<double, 16>();
        default:
            return -1;
    }
}

extern "C" int tbt_matvec_cm_f32(const void* a_cm, const void* x, void* y,
                                 void* ws, int n_rows, int m_cols, int splits,
                                 int rows, void* stream) {
    return launch_matvec_cm(static_cast<const float*>(a_cm),
                            static_cast<const float*>(x),
                            static_cast<float*>(y), static_cast<float*>(ws),
                            n_rows, m_cols, splits, rows,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_matvec_cm_f64(const void* a_cm, const void* x, void* y,
                                 void* ws, int n_rows, int m_cols, int splits,
                                 int rows, void* stream) {
    return launch_matvec_cm(static_cast<const double*>(a_cm),
                            static_cast<const double*>(x),
                            static_cast<double*>(y), static_cast<double*>(ws),
                            n_rows, m_cols, splits, rows,
                            static_cast<cudaStream_t>(stream));
}
