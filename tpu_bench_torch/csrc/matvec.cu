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
//   - K8: a team of lanes owns R = 2 or 4 rows at a time and walks them
//     in 16-byte vectors (float4 / double2), U a lane a step.  The first
//     design gave each warp one row, so every warp read all of x and half
//     of its loads were x's (0.3720 ms at 16384^2 f32 against a bound of
//     0.3206): here each vector of x is loaded once for the R rows, R*U
//     vectors of A in flight a lane.  A team has as many lanes as give
//     each at least U vectors of a row, from 8 up to the block's 256: 256
//     at benchmark03's large shapes, so the row groups are many small
//     jobs on a one-wave grid (the occupancy API, tbt_matvec_rm_wave) and
//     every block takes the same number of them to within one
//     (kernels/matvec.rm_grid, rm_groups); 8 or 16 lanes, several teams a
//     warp, where a row is short.  A fixed shuffle tree and a fixed order
//     over the team's warps sum the lanes.  When a row is not a whole number of
//     16-byte vectors (N * itemsize % 16 != 0) or A or x is not 16-byte
//     aligned, the kernel takes one value a lane a step;
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
constexpr int CM_WARPS = THREADS / 32;  // K9: warps sharing a column block

// K8: a team of `lanes` lanes (8 .. 256, a power of two; kernels/matvec.
// rm_lanes) owns R consecutive rows at a time.  Each lane loads each
// 16-byte vector of x it takes once and uses it for all R rows: R*U
// vectors of A in flight.  A is read by plain loads, as K9 reads A_cm: with
// the streaming hint (ld.global.cs) or L1::no_allocate the kernel ran
// slower on the H100.  Team slot s of the grid (block b, team t: s = b *
// THREADS / lanes + t) takes row groups s, s + slots, ...; the loop
// runs by block, so teams past the last row group compute on the last row
// and store nothing, and every lane reaches the shuffles and barriers.
// Rows past m in the last group read row m - 1 and store nothing.  A lane
// sums its U partial sums in order, a fixed shuffle tree sums a warp's
// lanes (or a sub-warp team's), and a team of several warps adds its warps'
// sums in order through shared memory, so y is the same bits on every run.
//
// ptxas, given only the block size, held some instances to 80 registers
// and spilled; with one block an SM as the floor the vector form takes the
// registers it needs (up to about 150, no spill) and ran faster at
// benchmark03's large shapes, while the scalar form, which serves small
// shapes where the latency of a few loads is the time, keeps four blocks
// an SM (at most 64 registers) so one wave holds their row groups.
template <typename T, int W, int R, int U>
__global__ void __launch_bounds__(THREADS, W == 1 ? 4 : 1)
    matvec_rm_kernel(const T* __restrict__ a, const T* __restrict__ x,
                     T* __restrict__ y, int m, int n, int lanes) {
    __shared__ T red[THREADS / 32][R];
    const int nv = n / W;  // W-value units of a row
    const int per_block = THREADS / lanes, width = lanes < 32 ? lanes : 32;
    const int lane = threadIdx.x % lanes, team = threadIdx.x / lanes;
    const long long groups = (m + R - 1) / R;
    const long long slots = static_cast<long long>(gridDim.x) * per_block;
    for (long long base = static_cast<long long>(blockIdx.x) * per_block;
         base < groups; base += slots) {
        const long long rg = base + team;
        const T* __restrict__ rows[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const long long row = rg * R + r;
            rows[r] = a + (row < m ? row : m - 1) * static_cast<long long>(n);
        }
        T acc[R][U];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < U; ++u) acc[r][u] = T(0);
        // Full steps of U * lanes units, then the ragged tail.
        const int step = U * lanes, full = nv / step * step;
        for (int j = lane; j < full; j += step) {
            T xv[U][W], av[R][U][W];
#pragma unroll
            for (int u = 0; u < U; ++u)
                tbt::load_w(x + static_cast<long long>(j + u * lanes) * W,
                            xv[u]);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int u = 0; u < U; ++u)
                    tbt::load_w(
                        rows[r] + static_cast<long long>(j + u * lanes) * W,
                        av[r][u]);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int c = 0; c < W; ++c)
                        acc[r][u] = fma(av[r][u][c], xv[u][c], acc[r][u]);
        }
        for (int j = full + lane; j < nv; j += lanes) {
            T xv[W];
            tbt::load_w(x + static_cast<long long>(j) * W, xv);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                T av[W];
                tbt::load_w(rows[r] + static_cast<long long>(j) * W, av);
#pragma unroll
                for (int c = 0; c < W; ++c)
                    acc[r][0] = fma(av[c], xv[c], acc[r][0]);
            }
        }
        T sum[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            sum[r] = acc[r][0];
#pragma unroll
            for (int u = 1; u < U; ++u) sum[r] += acc[r][u];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                if (off < width)
                    sum[r] += __shfl_down_sync(0xffffffffu, sum[r], off, width);
        }
        if (lanes <= 32) {
            if (lane == 0 && rg < groups)
#pragma unroll
                for (int r = 0; r < R; ++r)
                    if (rg * R + r < m) y[rg * R + r] = sum[r];
        } else {
            const int warp = threadIdx.x / 32, team_warps = lanes / 32;
            if (threadIdx.x % 32 == 0)
#pragma unroll
                for (int r = 0; r < R; ++r) red[warp][r] = sum[r];
            __syncthreads();
            if (lane < R && rg < groups && rg * R + lane < m) {
                const int w0 = team * team_warps;
                T total = red[w0][lane];
                for (int k = 1; k < team_warps; ++k) total += red[w0 + k][lane];
                y[rg * R + lane] = total;
            }
            __syncthreads();
        }
    }
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

// f(kernel) for K8's instance of (vector form, rows, unroll);
// cudaErrorInvalidValue where none serves.
template <typename T, int W, int R, typename F>
int rm_with_unroll(int unroll, F&& f) {
    switch (unroll) {
        case 1: return f(matvec_rm_kernel<T, W, R, 1>);
        case 2: return f(matvec_rm_kernel<T, W, R, 2>);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T, int W, typename F>
int rm_with_rows(int rows, int unroll, F&& f) {
    switch (rows) {
        case 2: return rm_with_unroll<T, W, 2>(unroll, f);
        case 4: return rm_with_unroll<T, W, 4>(unroll, f);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T, typename F>
int rm_with_kernel(int vector, int rows, int unroll, F&& f) {
    if (vector) return rm_with_rows<T, tbt::Vec16<T>::width>(rows, unroll, f);
    return rm_with_rows<T, 1>(rows, unroll, f);
}

// vector: n a whole number of 16-byte vectors and A and x on 16-byte
// boundaries (refused otherwise); lanes a power of two from 8 to THREADS;
// blocks: the grid (kernels/matvec.rm_grid).
template <typename T>
int launch_matvec_rm(const T* a, const T* x, T* y, int m, int n, int rows,
                     int unroll, int lanes, int vector, int blocks,
                     cudaStream_t stream) {
    if (m < 0 || n < 0) return cudaErrorInvalidValue;
    if (m == 0) return cudaSuccess;
    if (blocks < 1 || lanes < 8 || lanes > THREADS || (lanes & (lanes - 1)) ||
        (vector && (n % tbt::Vec16<T>::width != 0 || !tbt::aligned16(a) ||
                    !tbt::aligned16(x))))
        return cudaErrorInvalidValue;
    return rm_with_kernel<T>(vector, rows, unroll, [&](auto kernel) {
        kernel<<<blocks, THREADS, 0, stream>>>(a, x, y, m, n, lanes);
        return static_cast<int>(cudaGetLastError());
    });
}

// Blocks of K8's instance the card holds at once; -1 on an error.
template <typename T>
int rm_wave(int vector, int rows, int unroll) {
    int dev = 0, sms = 0, per_sm = -1;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        return -1;
    const int err = rm_with_kernel<T>(vector, rows, unroll, [&](auto kernel) {
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, THREADS, 0));
    });
    return err == cudaSuccess ? per_sm * sms : -1;
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
                                 int n, int rows, int unroll, int lanes,
                                 int vector, int blocks, void* stream) {
    return launch_matvec_rm(static_cast<const float*>(a),
                            static_cast<const float*>(x),
                            static_cast<float*>(y), m, n, rows, unroll, lanes,
                            vector, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_matvec_rm_f64(const void* a, const void* x, void* y, int m,
                                 int n, int rows, int unroll, int lanes,
                                 int vector, int blocks, void* stream) {
    return launch_matvec_rm(static_cast<const double*>(a),
                            static_cast<const double*>(x),
                            static_cast<double*>(y), m, n, rows, unroll, lanes,
                            vector, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_matvec_rm_wave(int itemsize, int vector, int rows,
                                  int unroll) {
    return itemsize == 4 ? rm_wave<float>(vector, rows, unroll)
                         : rm_wave<double>(vector, rows, unroll);
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
