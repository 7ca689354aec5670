// K5 qp1d_fused3d: benchmark05's and benchmark04's Pallas(QP-1D/Shared).
//
// Replaces the Pallas kernels tpu_bench/kernels/bwdtrans3d.py:qp1d_shared3d
// (_stages3_em_kernel), the element-major three-stage product
//
//   out (E x N3) = ((X (E x K0) @ S1 (K0 x N1)) @ S2 (N1 x N2)) @ S3 (N2 x N3)
//
// and tpu_bench/kernels/bwdtrans2d.py:qp1d_shared (_stages_em_kernel), its
// two-stage form out (E x N2) = (X @ S1) @ S2, with the workspaces of an
// element tile kept on chip.  One template, on the stage count, serves both
// (entry points tbt_qp1d_fused3d_* and tbt_qp1d_fused2d_*).  The S are dense
// (the benchmarks' are kron-structured and mostly zero, but the kernel
// computes the same function for any S).
//
// What bounds it on an H100: FMA issue.  The dense stages do
// 2*(K0*N1 + N1*N2 + N2*N3) FLOP per element (1.08 M at nq=8^3) for
// 4*(K0 + N3) bytes of the element stream.  The operators (539,448 values at
// nq=8^3, 1.6 M at nq=10^3) do not fit in shared memory, so the design is:
//   - one block per tile of ET elements; the tile's input and its
//     workspaces live in shared memory, transposed to [column][element]
//     so a thread's ET-direction fragment is one 16-byte load;
//     buffer A holds w1, buffer B first X and then (three stages) w2;
//   - each stage is a GEMM of that tile against S streamed from L2 in
//     8 x 128 tiles through shared memory, the next tile read into
//     registers while the current one is used; 256 threads, each a
//     4 x (ET/8) register micro-tile, full FP32/FP64 FMA (never TF32);
//   - ET is 32, or 16 or 8 where the larger tile's buffers do not fit the
//     card's opt-in shared memory (16: b05 nq=10^3 f64 and b04 nq=32 f32;
//     8: b04 nq=32 f64, whose workspace widths are 961 and 992); the
//     wrapper chooses it and refuses a shape that fits none.  On the H100,
//     32 timed fastest of 64/32/16 at nq 4^3-10^3 in f32 and f64: two
//     blocks share an SM up to nq=8^3 f32 and 6^3 f64, and the registers
//     are capped at 128 a thread so that they can;
//   - K, N and E edges masked; workspace rows past a stage's width up to
//     the next multiple of 8 are written as zeros, so the next stage's K
//     loop runs over whole 8-row steps.
// The tile's loads and its stage boundaries are not overlapped with its
// FMAs except by the other block of the SM; the kron structure of S and
// tensor cores are later work.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 4;     // elements per thread
constexpr int BN = 128;   // S tile width
constexpr int BK = 8;     // S tile depth
constexpr int SPAD = 4;   // keeps S tile rows 16-byte aligned

__host__ __device__ constexpr int pad_k(int n) { return (n + BK - 1) / BK * BK; }

// Rows of buffer B, which holds first X (k0 columns) and then, in the
// three-stage chain, w2 (n2); n2 = 0 in the two-stage chain.
__host__ __device__ constexpr int rows_b(int k0, int n2) {
    return pad_k(k0) > pad_k(n2) ? pad_k(k0) : pad_k(n2);
}

constexpr int S_LOADS = BK * BN / THREADS;  // S tile values per thread

// This thread's share of the S tile s[k0:k0+BK, n0:n0+BN], zero past the
// edges; consecutive threads read consecutive columns.
template <typename T>
__device__ __forceinline__ void fetch_s(const T* __restrict__ s, int k_depth,
                                        int n_cols, int k0, int n0,
                                        T (&pre)[S_LOADS]) {
#pragma unroll
    for (int r = 0; r < S_LOADS; ++r) {
        const int t = threadIdx.x + r * THREADS;
        const int k = t / BN, n = t % BN;
        pre[r] = (k0 + k < k_depth && n0 + n < n_cols)
                     ? s[static_cast<size_t>(k0 + k) * n_cols + n0 + n]
                     : T(0);
    }
}

// dst = src (k_depth x ET, shared, [k][e]) @ s (k_depth x n_cols, global),
// in BN-wide column chunks.  TO_GLOBAL: dst is out (E x n_cols, row-major)
// for elements e0..e0+ET-1 below n_elem; else dst is shared [n][e] with
// rows n_cols..pad_k(n_cols)-1 zero.
template <typename T, int ET, bool TO_GLOBAL>
__device__ __forceinline__ void stage(const T* src, int k_depth,
                                      const T* __restrict__ s, int n_cols,
                                      T* s_tile, T* dst, long long e0,
                                      long long n_elem) {
    constexpr int GE = ET / TM;       // element groups
    constexpr int GN = THREADS / GE;  // column groups
    constexpr int TN = BN / GN;       // columns per thread: ET / 8
    static_assert(GE * GN == THREADS && GN * TN == BN, "tile shape");
    const int gn = threadIdx.x % GN;
    const int ge = threadIdx.x / GN;
    const int kp = pad_k(k_depth);
    const int n_rows = pad_k(n_cols);

    for (int n0 = 0; n0 < n_cols; n0 += BN) {
        T acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

        // The next S tile is read into registers while this one is used,
        // so its L2 latency hides behind the FMAs.
        T pre[S_LOADS];
        fetch_s(s, k_depth, n_cols, 0, n0, pre);
        for (int k0 = 0; k0 < kp; k0 += BK) {
#pragma unroll
            for (int r = 0; r < S_LOADS; ++r) {
                const int t = threadIdx.x + r * THREADS;
                s_tile[(t / BN) * (BN + SPAD) + t % BN] = pre[r];
            }
            __syncthreads();
            if (k0 + BK < kp) fetch_s(s, k_depth, n_cols, k0 + BK, n0, pre);
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                T av[TM], bv[TN];
                tbt::load4(src + (k0 + k) * ET + ge * TM, av);
                const T* brow = s_tile + k * (BN + SPAD) + gn * TN;
                if constexpr (TN % 4 == 0) {
#pragma unroll
                    for (int q = 0; q < TN; q += 4) tbt::load4(brow + q, bv + q);
                } else {
#pragma unroll
                    for (int q = 0; q < TN; ++q) bv[q] = brow[q];
                }
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fma(av[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }

#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + gn * TN + j;
            if constexpr (TO_GLOBAL) {
                if (n >= n_cols) continue;
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const long long e = e0 + ge * TM + i;
                    if (e < n_elem) dst[e * n_cols + n] = acc[i][j];
                }
            } else {
                if (n >= n_rows) continue;
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    dst[n * ET + ge * TM + i] = n < n_cols ? acc[i][j] : T(0);
            }
        }
    }
}

// STAGES == 3: out (E x n3) = ((X @ S1) @ S2) @ S3, workspaces n1 and n2
// wide.  STAGES == 2: out (E x n2) = (X @ S1) @ S2; s3 and n3 are unused.
template <typename T, int ET, int STAGES>
__global__ void __launch_bounds__(THREADS, 2)
    qp1d_fused_kernel(const T* __restrict__ x, const T* __restrict__ s1,
                      const T* __restrict__ s2, const T* __restrict__ s3,
                      T* __restrict__ out, long long n_elem, int k0, int n1,
                      int n2, int n3) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* buf_a = reinterpret_cast<T*>(smem_raw);           // w1: pad_k(n1) rows
    T* buf_b = buf_a + static_cast<size_t>(pad_k(n1)) * ET;  // X, then w2
    T* s_tile =
        buf_b + static_cast<size_t>(rows_b(k0, STAGES == 3 ? n2 : 0)) * ET;
    const long long e0 = static_cast<long long>(blockIdx.x) * ET;

    // X tile, transposed into buf_b; rows k0..pad_k(k0)-1 and elements past
    // n_elem are zero.  Consecutive threads read consecutive k of one row.
    const int kp = pad_k(k0);
    for (int t = threadIdx.x; t < ET * kp; t += THREADS) {
        const int m = t / kp, k = t % kp;
        const long long e = e0 + m;
        buf_b[k * ET + m] =
            (e < n_elem && k < k0) ? x[e * k0 + k] : T(0);
    }
    __syncthreads();
    stage<T, ET, false>(buf_b, k0, s1, n1, s_tile, buf_a, e0, n_elem);
    __syncthreads();
    if constexpr (STAGES == 2) {
        stage<T, ET, true>(buf_a, n1, s2, n2, s_tile, out, e0, n_elem);
    } else {
        stage<T, ET, false>(buf_a, n1, s2, n2, s_tile, buf_b, e0, n_elem);
        __syncthreads();
        stage<T, ET, true>(buf_b, n2, s3, n3, s_tile, out, e0, n_elem);
    }
}

// Dynamic shared memory of one block: w1, buffer B and the S tile.  n2 is
// the second workspace's width, 0 for the two-stage chain.
template <typename T>
size_t smem_bytes(int et, int k0, int n1, int n2) {
    const int rows = pad_k(n1) + rows_b(k0, n2);
    return sizeof(T) * (static_cast<size_t>(rows) * et + BK * (BN + SPAD));
}

template <typename T, int ET, int STAGES>
int launch_tile(const T* x, const T* s1, const T* s2, const T* s3, T* out,
                long long n_elem, int k0, int n1, int n2, int n3,
                cudaStream_t stream) {
    const size_t smem = smem_bytes<T>(ET, k0, n1, STAGES == 3 ? n2 : 0);
    auto kernel = qp1d_fused_kernel<T, ET, STAGES>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const long long blocks = (n_elem + ET - 1) / ET;
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
        x, s1, s2, s3, out, n_elem, k0, n1, n2, n3);
    return cudaGetLastError();
}

template <typename T, int STAGES>
int launch(const T* x, const T* s1, const T* s2, const T* s3, T* out,
           long long n_elem, int k0, int n1, int n2, int n3, int et,
           cudaStream_t stream) {
    if (n_elem <= 0 || (STAGES == 3 ? n3 : n2) <= 0) return cudaSuccess;
    switch (et) {
        case 32:
            return launch_tile<T, 32, STAGES>(x, s1, s2, s3, out, n_elem, k0,
                                              n1, n2, n3, stream);
        case 16:
            return launch_tile<T, 16, STAGES>(x, s1, s2, s3, out, n_elem, k0,
                                              n1, n2, n3, stream);
        case 8:
            return launch_tile<T, 8, STAGES>(x, s1, s2, s3, out, n_elem, k0,
                                             n1, n2, n3, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// Shared memory a block of element tile et needs; n2 is the second
// workspace's width, 0 for the two-stage chain.
extern "C" long long tbt_qp1d_smem(int itemsize, int et, int k0, int n1,
                                   int n2) {
    return itemsize == 4
               ? static_cast<long long>(smem_bytes<float>(et, k0, n1, n2))
               : static_cast<long long>(smem_bytes<double>(et, k0, n1, n2));
}

extern "C" int tbt_qp1d_fused3d_f32(const void* x, const void* s1,
                                    const void* s2, const void* s3, void* out,
                                    long long n_elem, int k0, int n1, int n2,
                                    int n3, int et, void* stream) {
    return launch<float, 3>(
        static_cast<const float*>(x), static_cast<const float*>(s1),
        static_cast<const float*>(s2), static_cast<const float*>(s3),
        static_cast<float*>(out), n_elem, k0, n1, n2, n3, et,
        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp1d_fused3d_f64(const void* x, const void* s1,
                                    const void* s2, const void* s3, void* out,
                                    long long n_elem, int k0, int n1, int n2,
                                    int n3, int et, void* stream) {
    return launch<double, 3>(
        static_cast<const double*>(x), static_cast<const double*>(s1),
        static_cast<const double*>(s2), static_cast<const double*>(s3),
        static_cast<double*>(out), n_elem, k0, n1, n2, n3, et,
        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp1d_fused2d_f32(const void* x, const void* s1,
                                    const void* s2, void* out,
                                    long long n_elem, int k0, int n1, int n2,
                                    int et, void* stream) {
    return launch<float, 2>(
        static_cast<const float*>(x), static_cast<const float*>(s1),
        static_cast<const float*>(s2), nullptr, static_cast<float*>(out),
        n_elem, k0, n1, n2, 0, et, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp1d_fused2d_f64(const void* x, const void* s1,
                                    const void* s2, void* out,
                                    long long n_elem, int k0, int n1, int n2,
                                    int et, void* stream) {
    return launch<double, 2>(
        static_cast<const double*>(x), static_cast<const double*>(s1),
        static_cast<const double*>(s2), nullptr, static_cast<double*>(out),
        n_elem, k0, n1, n2, 0, et, static_cast<cudaStream_t>(stream));
}
