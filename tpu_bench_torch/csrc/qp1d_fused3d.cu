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
// computes the same function for any S), and the chain runs in stage order,
// as the JAX kernel's does.
//
// What bounds it on an H100: operations.  The dense stages do
// 2*(K0*N1 + N1*N2 + N2*N3) FLOP per element (1.08 M at nq=8^3, 1.41e11 at
// E=131072) for 4*(K0 + N3) bytes of the element stream.  The design puts
// them on the tensor cores:
//   - f32: 3xTF32.  Each operand a is split into big (a rounded to TF32)
//     and small = a - big (tbt::split_tf32), and mma.sync.m16n8k8 (tf32, f32
//     accumulators) adds small*big + big*small + big*big into a partial
//     sum a BK-deep step long, which is added to the chunk's sum in f32
//     round-to-nearest (mma_step); the JAX kernel's precision=HIGHEST is a
//     multi-pass bf16 split on the MXU, the same scheme, and TF32 keeps 11
//     bits where bf16 keeps 8.  The dense TF32 rate, 495 TFLOP/s, puts
//     three passes of the chain at 0.86 ms at b05 nq=8^3;
//   - f64: mma.sync.m8n8k4 on f64 (DMMA), IEEE FP64 FMA at 67 TFLOP/s
//     against 34 outside the tensor cores;
//   - one block of 8 warps per tile of ET elements (the M side; 64, 32 or
//     16 in f32, 32, 16 or 8 in f64, the wrapper takes the first whose
//     buffers fit the card's opt-in shared memory); the tile's input and its
//     workspaces live in shared memory element-major ([e][k]) with rows
//     ROW_PAD past a multiple of BK, so fragment loads hit distinct banks
//     and the next stage's k loop runs over whole steps of zeros; buffer A
//     holds w1, buffer B first X and then (three stages) w2;
//   - each stage is a GEMM of that tile against S streamed from L2 in
//     BK x BN tiles through a ring of RING shared-memory stages filled by
//     cp.async (16-byte copies where S's rows are whole 16-byte chunks,
//     else one element a copy), across the stage's column chunks without
//     draining; the X tile comes in by cp.async too;
//   - K, N and E edges masked: zero-filled copies, masked stores;
//   - bf16: the X tile, the workspaces and the S tiles are bf16, and one
//     mma.sync.m16n8k16 pass (bf16 in, f32 sums) a 16-deep step, on
//     fragments loaded by ldmatrix, takes each product exactly: no split.
//     w1 and w2 are rounded to bf16 as they are written to shared memory,
//     and the output as it is stored, where the JAX kernel's bf16 scratch
//     rounds them (bwdtrans3d.py:245-247, bwdtrans2d.py:577).  Rows are
//     padded by 8 values (16 bytes), so ldmatrix rows are 16-byte aligned
//     and the 8 rows of a fragment hit distinct bank groups.
// The kron zeros of S, and wgmma with TMA, are later work.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int RING = 3;       // S tiles in shared memory
constexpr int SPAD = 8;       // S tile row padding (elements)

// The mma tile's M side, the S tiles (BK x BN) and the workspace rows'
// padding past a multiple of BK (ROW_PAD) of each type
// (kernels/bwdtrans3d.QP1D_STEP).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
    static constexpr int MMA_M = 16, BK = 32, BN = 128, ROW_PAD = 4;
};
template <>
struct Tile<double> {
    static constexpr int MMA_M = 8, BK = 8, BN = 64, ROW_PAD = 4;
};
template <>
struct Tile<tbt::bf16> {
    static constexpr int MMA_M = 16, BK = 32, BN = 128, ROW_PAD = 8;
};

template <typename T>
__host__ __device__ constexpr int pad_k(int n) {
    return (n + Tile<T>::BK - 1) / Tile<T>::BK * Tile<T>::BK;
}

// Row stride of a workspace n wide: a multiple of BK plus ROW_PAD, which is
// 4 modulo 8 (f32, f64), so the 8 rows of an A fragment start in distinct
// banks; 8 in bf16, so they start in distinct 16-byte bank groups.
template <typename T>
__host__ __device__ constexpr int ld_of(int n) {
    return pad_k<T>(n) + Tile<T>::ROW_PAD;
}

// Dynamic shared memory of one block: w1, buffer B and the S ring.  n2 is
// the second workspace's width, 0 for the two-stage chain.
template <typename T>
size_t smem_bytes(int et, int k0, int n1, int n2) {
    const int ld_b = n2 > 0 && ld_of<T>(n2) > ld_of<T>(k0) ? ld_of<T>(n2)
                                                           : ld_of<T>(k0);
    return sizeof(T) *
           (static_cast<size_t>(et) * (ld_of<T>(n1) + ld_b) +
            static_cast<size_t>(RING) * Tile<T>::BK * (Tile<T>::BN + SPAD));
}

// rows x cols of a row-major global matrix (row stride ld_g), from
// (r0, c0), into shared memory of row stride ld_s, by cp.async; zero past
// n_rows, n_cols.  vec: 16-byte copies, for rows of whole 16-byte chunks
// (cols a multiple of them).
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld_s, int rows,
                                          int cols, const T* __restrict__ src,
                                          long long ld_g, long long r0,
                                          int c0, long long n_rows,
                                          int n_cols, bool vec) {
    constexpr int V = 16 / sizeof(T);
    if (vec) {
        for (int q = threadIdx.x; q < rows * cols / V; q += THREADS) {
            const int r = q / (cols / V), c = (q % (cols / V)) * V;
            const bool ok = r0 + r < n_rows && c0 + c < n_cols;
            tbt::cp_async<16>(dst + r * ld_s + c,
                              ok ? src + (r0 + r) * ld_g + c0 + c : src, ok);
        }
    } else {
        for (int q = threadIdx.x; q < rows * cols; q += THREADS) {
            const int r = q / cols, c = q % cols;
            const bool ok = r0 + r < n_rows && c0 + c < n_cols;
            tbt::cp_async<sizeof(T)>(
                dst + r * ld_s + c, ok ? src + (r0 + r) * ld_g + c0 + c : src,
                ok);
        }
    }
}

// The fragments of one warp: NT mma tiles of MMA_M x 8.
template <typename T, int NT>
struct Acc;
template <int NT>
struct Acc<float, NT> {
    float v[NT][4];
};
template <int NT>
struct Acc<double, NT> {
    double v[NT][2];
};
template <int NT>
struct Acc<tbt::bf16, NT> {
    float v[NT][4];
};

// acc += src[rows of this warp][kb : kb+BK] @ s_tile (BK x BN, shared).
// The tensor cores' f32 sums truncate: over the whole depth in one
// accumulator that bias put the chain past 1e-5 of its largest output at
// nq=10^3 on random operators (tests/test_torch_tensorcore.py emulates
// both).  So each BK-deep product is summed alone and added to acc in f32
// round-to-nearest.
template <int NT>
__device__ __forceinline__ void mma_step(Acc<float, NT>& acc, const float* src,
                                         int ld_src, int kb,
                                         const float* s_tile, int row0,
                                         int col0, int lane) {
    constexpr int LDS = Tile<float>::BN + SPAD;
    const int g = lane / 4, t = lane % 4;
    Acc<float, NT> part;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part.v[nt][q] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < Tile<float>::BK; kk += 8) {
        const float* a = src + (row0 + g) * ld_src + kb + kk + t;
        unsigned ab[4], as[4];
        tbt::split_tf32(a[0], ab[0], as[0]);
        tbt::split_tf32(a[8 * ld_src], ab[1], as[1]);
        tbt::split_tf32(a[4], ab[2], as[2]);
        tbt::split_tf32(a[8 * ld_src + 4], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const float* b = s_tile + (kk + t) * LDS + col0 + nt * 8 + g;
            unsigned bb[2], bs[2];
            tbt::split_tf32(b[0], bb[0], bs[0]);
            tbt::split_tf32(b[4 * LDS], bb[1], bs[1]);
            tbt::mma_tf32(part.v[nt], as, bb);
            tbt::mma_tf32(part.v[nt], ab, bs);
            tbt::mma_tf32(part.v[nt], ab, bb);
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc.v[nt][q] += part.v[nt][q];
}

template <int NT>
__device__ __forceinline__ void mma_step(Acc<double, NT>& acc,
                                         const double* src, int ld_src,
                                         int kb, const double* s_tile,
                                         int row0, int col0, int lane) {
    constexpr int LDS = Tile<double>::BN + SPAD;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < Tile<double>::BK; kk += 4) {
        const double a = src[(row0 + g) * ld_src + kb + kk + t];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
            tbt::mma_f64(acc.v[nt], a,
                         s_tile[(kk + t) * LDS + col0 + nt * 8 + g]);
    }
}

// bf16: acc += src[rows of this warp][kb : kb+BK] @ s_tile, one
// m16n8k16 pass a 16-deep step on ldmatrix fragments (as K14's, csrc/
// ozaki.cu); the products are exact and the sums f32.
template <int NT>
__device__ __forceinline__ void mma_step(Acc<tbt::bf16, NT>& acc,
                                         const tbt::bf16* src, int ld_src,
                                         int kb, const tbt::bf16* s_tile,
                                         int row0, int col0, int lane) {
    constexpr int LDS = Tile<tbt::bf16>::BN + SPAD;
    static_assert(NT % 2 == 0, "B fragments come in pairs of mma tiles");
#pragma unroll
    for (int kk = 0; kk < Tile<tbt::bf16>::BK; kk += 16) {
        unsigned a[4];
        tbt::ldmatrix_x4(a, src + (row0 + lane % 16) * ld_src + kb + kk +
                                (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
            unsigned r[4];
            tbt::ldmatrix_x4_trans(
                r, s_tile + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDS +
                       col0 + np * 16 + (lane / 16) * 8);
            const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            tbt::mma_bf16(acc.v[2 * np], a, b0);
            tbt::mma_bf16(acc.v[2 * np + 1], a, b1);
        }
    }
}

// dst = src (ET x k_depth, shared, row stride ld_src) @ s (k_depth x
// n_cols, global), in BN-wide column chunks.  TO_GLOBAL: dst is out (E x
// n_cols, row-major) for elements e0..e0+ET-1 below n_elem; else dst is
// shared, row stride ld_dst, with columns n_cols..pad_k(n_cols)-1 zero.
// Each value is rounded to T as it is written (tbt::narrow).
template <typename T, int ET, bool TO_GLOBAL>
__device__ __forceinline__ void stage(const T* src, int ld_src, int k_depth,
                                      const T* __restrict__ s, int n_cols,
                                      T* ring, T* dst, int ld_dst,
                                      long long e0, long long n_elem) {
    using C = Tile<T>;
    constexpr int WARPS_M = ET / C::MMA_M, WARPS_N = 8 / WARPS_M;
    constexpr int NT = C::BN / WARPS_N / 8;
    constexpr int LDS = C::BN + SPAD, SLOT = C::BK * LDS;
    static_assert(WARPS_M * WARPS_N == 8 && NT >= 1, "tile shape");
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int row0 = (warp / WARPS_N) * C::MMA_M;
    const int col0 = (warp % WARPS_N) * NT * 8;
    const int ksteps = pad_k<T>(k_depth) / C::BK;
    const int total = ksteps * ((n_cols + C::BN - 1) / C::BN);
    const bool vec = n_cols % (16 / sizeof(T)) == 0 && tbt::aligned16(s);

    auto load = [&](int i) {
        copy_tile(ring + (i % RING) * SLOT, LDS, C::BK, C::BN, s, n_cols,
                  static_cast<long long>(i % ksteps) * C::BK,
                  (i / ksteps) * C::BN, k_depth, n_cols, vec);
    };
    __syncthreads();  // the ring's last readers of the previous stage
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) {
        if (i < total) load(i);
        tbt::cp_async_commit();
    }
    Acc<T, NT> acc;
    for (int i = 0; i < total; ++i) {
        const int kstep = i % ksteps;
        if (kstep == 0) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int q = 0; q < C::MMA_M * 8 / 32; ++q) acc.v[nt][q] = 0;
        }
        tbt::cp_async_wait<RING - 2>();
        __syncthreads();
        if (i + RING - 1 < total) load(i + RING - 1);
        tbt::cp_async_commit();
        mma_step(acc, src, ld_src, kstep * C::BK, ring + (i % RING) * SLOT,
                 row0, col0, lane);
        if (kstep != ksteps - 1) continue;

        // the chunk's columns are complete: C fragment value q sits at row
        // lane/4 + 8*(q/2), column 2*(lane%4) + q%2 of its mma tile
        const int n_base = (i / ksteps) * C::BN + col0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < C::MMA_M * 8 / 32; ++q) {
                const int r = row0 + lane / 4 + 8 * (q / 2);
                const int n = n_base + nt * 8 + 2 * (lane % 4) + q % 2;
                if constexpr (TO_GLOBAL) {
                    if (n < n_cols && e0 + r < n_elem)
                        dst[(e0 + r) * n_cols + n] =
                            tbt::narrow<T>(acc.v[nt][q]);
                } else {
                    if (n < pad_k<T>(n_cols))
                        dst[r * ld_dst + n] = tbt::narrow<T>(
                            n < n_cols ? acc.v[nt][q] : 0);
                }
            }
    }
}

// STAGES == 3: out (E x n3) = ((X @ S1) @ S2) @ S3, workspaces n1 and n2
// wide.  STAGES == 2: out (E x n2) = (X @ S1) @ S2; s3 and n3 are unused.
// Two blocks an SM where the shared memory allows, so at most 128
// registers a thread; the f32 tile of 64 elements (8 mma tiles a warp)
// needs more, and spilled under that cap.
template <typename T, int ET, int STAGES>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(T) == 4 && ET == 64 ? 1 : 2)
    qp1d_tc_kernel(const T* __restrict__ x, const T* __restrict__ s1,
                   const T* __restrict__ s2, const T* __restrict__ s3,
                   T* __restrict__ out, long long n_elem, int k0, int n1,
                   int n2, int n3) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld1 = ld_of<T>(n1), ldx = ld_of<T>(k0);
    const int ld2 = STAGES == 3 ? ld_of<T>(n2) : 0;
    T* buf_a = reinterpret_cast<T*>(smem_raw);  // w1
    T* buf_b = buf_a + static_cast<size_t>(ET) * ld1;  // X, then w2
    T* ring = buf_b + static_cast<size_t>(ET) * (ldx > ld2 ? ldx : ld2);
    const long long e0 = static_cast<long long>(blockIdx.x) * ET;

    // the X tile, columns k0..pad_k(k0)-1 and elements past n_elem zero
    copy_tile(buf_b, ldx, ET, pad_k<T>(k0), x, k0, e0, 0, n_elem, k0,
              k0 % (16 / sizeof(T)) == 0 && tbt::aligned16(x));
    tbt::cp_async_commit();
    stage<T, ET, false>(buf_b, ldx, k0, s1, n1, ring, buf_a, ld1, e0, n_elem);
    if constexpr (STAGES == 2) {
        stage<T, ET, true>(buf_a, ld1, n1, s2, n2, ring, out, 0, e0, n_elem);
    } else {
        stage<T, ET, false>(buf_a, ld1, n1, s2, n2, ring, buf_b, ld2, e0,
                            n_elem);
        stage<T, ET, true>(buf_b, ld2, n2, s3, n3, ring, out, 0, e0, n_elem);
    }
}

template <typename T, int ET, int STAGES>
int launch_tile(const T* x, const T* s1, const T* s2, const T* s3, T* out,
                long long n_elem, int k0, int n1, int n2, int n3,
                cudaStream_t stream) {
    const size_t smem = smem_bytes<T>(ET, k0, n1, STAGES == 3 ? n2 : 0);
    static tbt::DeviceCache<> optin;  // the opt-in, once per device
    auto kernel = qp1d_tc_kernel<T, ET, STAGES>;
    const cudaError_t err = tbt::optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    const long long blocks = (n_elem + ET - 1) / ET;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
        x, s1, s2, s3, out, n_elem, k0, n1, n2, n3);
    return cudaGetLastError();
}

// The element tiles of each type (QP1D_TILES in kernels/bwdtrans3d.py).
template <typename T, int STAGES>
int launch(const T* x, const T* s1, const T* s2, const T* s3, T* out,
           long long n_elem, int k0, int n1, int n2, int n3, int et,
           cudaStream_t stream) {
    if (n_elem <= 0 || (STAGES == 3 ? n3 : n2) <= 0) return cudaSuccess;
    if (k0 <= 0 || n1 <= 0 || n2 <= 0) return cudaErrorInvalidValue;
    constexpr int M = Tile<T>::MMA_M;
    if (et % M != 0) return cudaErrorInvalidValue;
    switch (et / M) {
        case 1:
            return launch_tile<T, M, STAGES>(x, s1, s2, s3, out, n_elem, k0,
                                             n1, n2, n3, stream);
        case 2:
            return launch_tile<T, 2 * M, STAGES>(x, s1, s2, s3, out, n_elem,
                                                 k0, n1, n2, n3, stream);
        case 4:
            return launch_tile<T, 4 * M, STAGES>(x, s1, s2, s3, out, n_elem,
                                                 k0, n1, n2, n3, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// Shared memory a block of element tile et needs; n2 is the second
// workspace's width, 0 for the two-stage chain.
extern "C" long long tbt_qp1d_smem(int itemsize, int et, int k0, int n1,
                                   int n2) {
    switch (itemsize) {
        case 2:
            return static_cast<long long>(
                smem_bytes<tbt::bf16>(et, k0, n1, n2));
        case 4:
            return static_cast<long long>(smem_bytes<float>(et, k0, n1, n2));
        default:
            return static_cast<long long>(smem_bytes<double>(et, k0, n1, n2));
    }
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

extern "C" int tbt_qp1d_fused3d_bf16(const void* x, const void* s1,
                                     const void* s2, const void* s3,
                                     void* out, long long n_elem, int k0,
                                     int n1, int n2, int n3, int et,
                                     void* stream) {
    using tbt::bf16;
    return launch<bf16, 3>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(s1),
        static_cast<const bf16*>(s2), static_cast<const bf16*>(s3),
        static_cast<bf16*>(out), n_elem, k0, n1, n2, n3, et,
        static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_qp1d_fused2d_bf16(const void* x, const void* s1,
                                     const void* s2, void* out,
                                     long long n_elem, int k0, int n1, int n2,
                                     int et, void* stream) {
    using tbt::bf16;
    return launch<bf16, 2>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(s1),
        static_cast<const bf16*>(s2), nullptr, static_cast<bf16*>(out),
        n_elem, k0, n1, n2, 0, et, static_cast<cudaStream_t>(stream));
}
