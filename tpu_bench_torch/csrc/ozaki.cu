// K14 ozaki_slices: the split-mantissa ("Ozaki scheme") f64 GEMM from bf16
// integer slices, with the bands folded into an f32 (hi, lo) pair.
//
// It replaces the Pallas kernels tpu_bench/kernels/ozaki.py:kron_ozaki_pair
// (_ozaki_kernel, every band in one program) and kron_ozaki_band
// (_ozaki_band_kernel, one band per sequential grid step), the f64
// Pallas(Coales) column of benchmarks 04 and 05 under --f64-coales ozaki:
//
//   band u   = sum_{s+t=u} C_s (m_rows x k) @ X_t (k x n_cols)
//   (hi, lo) = two-sum fold, band 0 first, of band_u * 2^-w(u+2)
//
// for u < max(T_c, T_x) and s in [max(0, u-T_x+1), min(u, T_c-1)], so T_c
// and T_x may differ in both forms.  The f64 product is
// scale_c * scale_x * (hi + lo).
//
// Exactness: every slice is a bf16 integer with |v| <= 2^w, and
// slice_params picks (w, T) with T * k * 2^(2w) < 2^24, so every partial sum
// of a band is an integer that f32 holds exactly, in any order; scaling by
// 2^-w(u+2) is exact.  The fold is written with __fadd_rn/__fsub_rn/__fmul_rn,
// which the compiler neither contracts nor reassociates, so hi and lo equal
// the plain PyTorch version and the JAX kernel bit for bit.
//
// What bounds it on an H100: operations.  At b05 nq=8^3 (k=343, T=9, 512
// rows) each element takes 45 slice products of 2*512*343 FLOP for 18 bytes
// of slices and 8 of (hi, lo).  The design is K2's (csrc/bwdtrans2d.cu)
// plain tiled GEMM on the CUDA cores in FP32 FMA, with the slices widened
// to f32 as the tiles are staged in shared memory:
//   - output tiles of BM x 128, K in steps of 8, an 8 x 8 (BM = 128, two
//     blocks an SM) or 4 x 8 (BM = 64, three blocks an SM, for at most 64
//     rows: b04 nq=8^2) register micro-tile per thread (256 threads);
//   - one accumulator per band, for the (s, t) pairs of the band in turn;
//     after each band the block folds it into the (hi, lo) tile in device
//     memory, which it alone owns: the fused form walks every band in one
//     launch, the band form one band a launch (read-modify-write);
//   - a 1D grid with the row tiles of one element tile adjacent, so the
//     element slices they share are read from L2;
//   - rows, k and elements masked: any n_cols >= 1.
// The bf16 tensor cores (mma.sync or wgmma with f32 accumulation; 989
// TFLOP/s dense against 67 for FP32 FMA) are the redesign's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TN = 8;
constexpr int THREADS = 256;
constexpr int ROW_THREADS = THREADS / (BN / TN);  // 16
constexpr int PAD = 4;

// Blocks an SM: TM = 8 is held to two (128 registers, a 200-byte stack);
// left free, ptxas gives it 201 and one block an SM, 1.4x slower at b05
// nq=8^3.  TM = 4 is held to three (80 registers, a 32-byte stack).
template <int TM>
__global__ void __launch_bounds__(THREADS, TM == 8 ? 2 : 3)
    ozaki_slices_kernel(const __nv_bfloat16* __restrict__ c,
                        const __nv_bfloat16* __restrict__ x,
                        float* __restrict__ hi, float* __restrict__ lo,
                        int t_c, int t_x, int m_rows, int k_depth,
                        long long n_cols, int w, int u_begin, int u_end) {
    constexpr int BM = TM * ROW_THREADS;
    __shared__ __align__(16) float a_tile[BK][BM + PAD];  // C tile as [k][m]
    __shared__ __align__(16) float b_tile[BK][BN + PAD];
    const int m_tiles = (m_rows + BM - 1) / BM;
    const int m0 = static_cast<int>(blockIdx.x % m_tiles) * BM;
    const long long n0 = static_cast<long long>(blockIdx.x / m_tiles) * BN;
    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);

    for (int u = u_begin; u < u_end; ++u) {
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

        const int s_lo = max(0, u - t_x + 1);
        const int s_hi = min(u, t_c - 1);
        for (int s = s_lo; s <= s_hi; ++s) {
            const __nv_bfloat16* a =
                c + static_cast<size_t>(s) * m_rows * k_depth;
            const __nv_bfloat16* b =
                x + static_cast<size_t>(u - s) * k_depth * n_cols;
            for (int k0 = 0; k0 < k_depth; k0 += BK) {
#pragma unroll
                for (int r = 0; r < BM * BK / THREADS; ++r) {
                    const int q = threadIdx.x + r * THREADS;
                    const int m = q / BK, k = q % BK;
                    a_tile[k][m] =
                        (m0 + m < m_rows && k0 + k < k_depth)
                            ? __bfloat162float(
                                  a[static_cast<size_t>(m0 + m) * k_depth +
                                    k0 + k])
                            : 0.0f;
                }
#pragma unroll
                for (int r = 0; r < BK * BN / THREADS; ++r) {
                    const int q = threadIdx.x + r * THREADS;
                    const int k = q / BN, n = q % BN;
                    b_tile[k][n] =
                        (k0 + k < k_depth && n0 + n < n_cols)
                            ? __bfloat162float(
                                  b[static_cast<size_t>(k0 + k) * n_cols +
                                    n0 + n])
                            : 0.0f;
                }
                __syncthreads();
#pragma unroll
                for (int k = 0; k < BK; ++k) {
                    float av[TM], bv[TN];
#pragma unroll
                    for (int i = 0; i < TM; i += 4)
                        tbt::load4(&a_tile[k][ty * TM + i], av + i);
#pragma unroll
                    for (int j = 0; j < TN; j += 4)
                        tbt::load4(&b_tile[k][tx * TN + j], bv + j);
#pragma unroll
                    for (int i = 0; i < TM; ++i)
#pragma unroll
                        for (int j = 0; j < TN; ++j)
                            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
                }
                __syncthreads();
            }
        }

        // fold band u into (hi, lo): band 0 starts the pair, every later
        // band goes in by an error-free two-sum, its error into lo
        const float scale = ldexpf(1.0f, -w * (u + 2));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int m = m0 + ty * TM + i;
            if (m >= m_rows) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const long long n = n0 + tx * TN + j;
                if (n >= n_cols) continue;
                const size_t at = static_cast<size_t>(m) * n_cols + n;
                const float v = __fmul_rn(acc[i][j], scale);
                if (u == 0) {
                    hi[at] = v;
                    lo[at] = 0.0f;
                } else {
                    const float h = hi[at];
                    const float sum = __fadd_rn(h, v);
                    const float bb = __fsub_rn(sum, h);
                    const float err = __fadd_rn(__fsub_rn(h, __fsub_rn(sum, bb)),
                                                __fsub_rn(v, bb));
                    hi[at] = sum;
                    lo[at] = __fadd_rn(lo[at], err);
                }
            }
        }
    }
}

int launch(const void* c, const void* x, void* hi, void* lo, int t_c,
           int t_x, int m_rows, int k_depth, long long n_cols, int w,
           int u_begin, int u_end, cudaStream_t stream) {
    if (m_rows <= 0 || n_cols <= 0) return cudaSuccess;
    const int n_bands = t_c > t_x ? t_c : t_x;
    if (t_c <= 0 || t_x <= 0 || k_depth <= 0 || w <= 0 || u_begin < 0 ||
        u_begin >= u_end || u_end > n_bands)
        return cudaErrorInvalidValue;
    const auto* cb = static_cast<const __nv_bfloat16*>(c);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* h = static_cast<float*>(hi);
    auto* l = static_cast<float*>(lo);
    const long long n_tiles = (n_cols + BN - 1) / BN;
    if (m_rows <= 4 * ROW_THREADS) {
        const long long blocks = n_tiles;
        if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
        ozaki_slices_kernel<4><<<static_cast<unsigned>(blocks), THREADS, 0,
                                 stream>>>(cb, xb, h, l, t_c, t_x, m_rows,
                                           k_depth, n_cols, w, u_begin,
                                           u_end);
    } else {
        const long long blocks =
            n_tiles * ((m_rows + 8 * ROW_THREADS - 1) / (8 * ROW_THREADS));
        if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
        ozaki_slices_kernel<8><<<static_cast<unsigned>(blocks), THREADS, 0,
                                 stream>>>(cb, xb, h, l, t_c, t_x, m_rows,
                                           k_depth, n_cols, w, u_begin,
                                           u_end);
    }
    return cudaGetLastError();
}

}  // namespace

// Every band in one launch: (hi, lo) written whole.
extern "C" int tbt_ozaki_pair(const void* c, const void* x, void* hi,
                              void* lo, int t_c, int t_x, int m_rows,
                              int k_depth, long long n_cols, int w,
                              void* stream) {
    const int n_bands = t_c > t_x ? t_c : t_x;
    return launch(c, x, hi, lo, t_c, t_x, m_rows, k_depth, n_cols, w, 0,
                  n_bands, static_cast<cudaStream_t>(stream));
}

// Band u alone: band 0 writes (hi, lo), a later band folds itself into the
// pair the earlier bands left.
extern "C" int tbt_ozaki_band(const void* c, const void* x, void* hi,
                              void* lo, int t_c, int t_x, int m_rows,
                              int k_depth, long long n_cols, int w, int u,
                              void* stream) {
    return launch(c, x, hi, lo, t_c, t_x, m_rows, k_depth, n_cols, w, u,
                  u + 1, static_cast<cudaStream_t>(stream));
}
