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
// slice_params picks (w, T) with T * k * 2^(2w) < 2^24, so every product and
// every partial sum of a band is an integer below 2^24 in magnitude, which
// f32 holds exactly in any order and under any alignment of the tensor
// cores' f32 accumulator that keeps 24 bits; zero padding adds exact zeros;
// scaling by 2^-w(u+2) is exact.  The fold is written with
// __fadd_rn/__fsub_rn/__fmul_rn, which the compiler neither contracts nor
// reassociates, so hi and lo equal the plain PyTorch version and the JAX
// kernel bit for bit.
//
// What bounds it on an H100: operations.  At b05 nq=8^3 (k=343, T=9, 512
// rows) each element takes 45 slice products of 2*512*343 FLOP for 18 bytes
// of slices and 8 of (hi, lo): 2.07e12 FLOP at E=131072, 2.09 ms at the
// dense bf16 tensor-core rate.  The design:
//   - the slices go to the bf16 tensor cores as they are:
//     mma.sync.m16n8k16 with f32 accumulators, A (C, [m][k]) read with
//     ldmatrix and B (X, [k][n]) with ldmatrix.trans; 8 warps, each a 32 x
//     32 output tile (2 x 4 mma tiles);
//   - a ring of STAGES shared-memory stages filled by 16-byte cp.async, the
//     copies of tile i+STAGES-1 in flight while tile i is multiplied; the
//     ring runs across the pairs and bands of a launch without draining;
//     rows are padded by 8 bf16 so the ldmatrix rows fall in distinct banks;
//   - the wrapper pads C's rows to K_PAD (zero past k), so every A copy is
//     16 bytes and aligned; X rows k >= k and columns >= n_cols are
//     zero-filled by the copy (an X whose rows are not whole 16-byte
//     chunks, n_cols % 8 != 0, is staged with plain loads instead);
//   - block tiles of 128 x 64, or 64 x 128 for at most 64 rows (b04
//     nq=8^2), the row tiles of one column tile adjacent in the grid so the
//     X slices they share are read from L2;
//   - one accumulator tile per band; the fused form keeps the (hi, lo)
//     tile in registers across all bands, folds each band there and writes
//     the pair once; the band form (one band a launch) reads the pair the
//     earlier bands left and writes it back.
// wgmma with TMA, the way to the full 989 TFLOP/s, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BK = 32;        // k per ring stage: two m16n8k16 steps
constexpr int K_PAD = BK;     // C's rows are padded to a multiple of this
constexpr int STAGES = 4;
constexpr int SKEW = 8;       // bf16 of row padding in shared memory
constexpr int WARP_M = 32, WARP_N = 32;            // a warp's output tile
constexpr int MT = WARP_M / 16, NT = WARP_N / 8;  // its mma tiles

template <int BM, int BN>
constexpr size_t smem_bytes() {
    return sizeof(bf16) * STAGES * (BM * (BK + SKEW) + BK * (BN + SKEW));
}

// C slice s and X slice t, k step kk, into ring stage (sa, sb).
template <int BM, int BN>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ c,
                                          const bf16* __restrict__ x,
                                          bf16* sa, bf16* sb, int s, int t,
                                          int kk, int m0, long long n0,
                                          int m_rows, int k_depth, int k_pad,
                                          long long n_cols, bool vec_x) {
    constexpr int LDA = BK + SKEW, LDB = BN + SKEW;
    const bf16* cs = c + static_cast<size_t>(s) * m_rows * k_pad;
#pragma unroll
    for (int r = 0; r < BM * BK / 8 / THREADS; ++r) {
        const int q = threadIdx.x + r * THREADS;
        const int row = q / (BK / 8), col = (q % (BK / 8)) * 8;
        const bool ok = m0 + row < m_rows;
        tbt::cp_async<16>(
            sa + row * LDA + col,
            ok ? cs + static_cast<size_t>(m0 + row) * k_pad + kk + col : c,
            ok);
    }
    const bf16* xt = x + static_cast<size_t>(t) * k_depth * n_cols;
#pragma unroll
    for (int r = 0; r < BK * BN / 8 / THREADS; ++r) {
        const int q = threadIdx.x + r * THREADS;
        const int row = q / (BN / 8), col = (q % (BN / 8)) * 8;
        const int k = kk + row;
        const long long n = n0 + col;
        bf16* dst = sb + row * LDB + col;
        const bf16* src = xt + static_cast<size_t>(k) * n_cols + n;
        if (vec_x) {
            const bool ok = k < k_depth && n < n_cols;
            tbt::cp_async<16>(dst, ok ? src : x, ok);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                dst[j] = (k < k_depth && n + j < n_cols)
                             ? src[j]
                             : __float2bfloat16(0.0f);
        }
    }
}

// band += the ring stage's C tile @ X tile.
template <int BM, int BN>
__device__ __forceinline__ void mma_tile(const bf16* sa, const bf16* sb,
                                         int wm, int wn, int lane,
                                         float (&acc)[MT][NT][4]) {
    constexpr int LDA = BK + SKEW, LDB = BN + SKEW;
#pragma unroll
    for (int k16 = 0; k16 < BK; k16 += 16) {
        unsigned a[MT][4], b[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            tbt::ldmatrix_x4(a[mt], sa + (wm * WARP_M + mt * 16 + lane % 16) *
                                             LDA + k16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
            unsigned r[4];
            tbt::ldmatrix_x4_trans(
                r, sb + (k16 + lane % 8 + ((lane / 8) % 2) * 8) * LDB +
                       wn * WARP_N + np * 16 + (lane / 16) * 8);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
                tbt::mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
}

// (hi, lo) with v folded in: band 0 starts the pair, every later band goes
// in by an error-free two-sum, its error into lo.
__device__ __forceinline__ void fold(float& hi, float& lo, float v,
                                     bool first) {
    if (first) {
        hi = v;
        lo = 0.0f;
        return;
    }
    const float sum = __fadd_rn(hi, v);
    const float bb = __fsub_rn(sum, hi);
    const float err =
        __fadd_rn(__fsub_rn(hi, __fsub_rn(sum, bb)), __fsub_rn(v, bb));
    hi = sum;
    lo = __fadd_rn(lo, err);
}

// Bands u_begin..u_end-1 of the output tile of this block.  FUSED: every
// band (u_begin = 0), (hi, lo) kept in registers and written once; else
// each band is folded into the pair in device memory.
template <int BM, int BN, bool FUSED>
__global__ void __launch_bounds__(THREADS, FUSED ? 1 : 2)
    ozaki_mma_kernel(const bf16* __restrict__ c, const bf16* __restrict__ x,
                     float* __restrict__ hi, float* __restrict__ lo, int t_c,
                     int t_x, int m_rows, int k_depth, long long n_cols,
                     int w, int u_begin, int u_end, bool vec_x) {
    static_assert((BM / WARP_M) * (BN / WARP_N) * 32 == THREADS, "warps");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sa = reinterpret_cast<bf16*>(smem_raw);
    bf16* sb = sa + STAGES * BM * (BK + SKEW);
    constexpr int A_STAGE = BM * (BK + SKEW), B_STAGE = BK * (BN + SKEW);

    const int k_pad = (k_depth + K_PAD - 1) / K_PAD * K_PAD;
    const int ksteps = k_pad / BK;
    const int m_tiles = (m_rows + BM - 1) / BM;
    const int m0 = static_cast<int>(blockIdx.x % m_tiles) * BM;
    const long long n0 = static_cast<long long>(blockIdx.x / m_tiles) * BN;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / (BN / WARP_N), wn = warp % (BN / WARP_N);

    // The tiles in order: band u, its slice pairs (s, u-s), k steps.
    auto s_lo = [&](int u) { return max(0, u - t_x + 1); };
    auto s_hi = [&](int u) { return min(u, t_c - 1); };
    int total = 0;
    for (int u = u_begin; u < u_end; ++u) total += s_hi(u) - s_lo(u) + 1;
    total *= ksteps;

    int lu = u_begin, ls = s_lo(u_begin), lk = 0;  // next tile to load
    auto load_next = [&](int stage) {
        load_tile<BM, BN>(c, x, sa + stage * A_STAGE, sb + stage * B_STAGE,
                          ls, lu - ls, lk * BK, m0, n0, m_rows, k_depth, k_pad,
                          n_cols, vec_x);
        if (++lk == ksteps) {
            lk = 0;
            if (++ls > s_hi(lu)) {
                ++lu;
                ls = s_lo(lu);
            }
        }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < total) load_next(i);
        tbt::cp_async_commit();
    }

    float acc[MT][NT][4];
    float h[FUSED ? MT : 1][FUSED ? NT : 1][4];
    float l[FUSED ? MT : 1][FUSED ? NT : 1][4];
    int u = u_begin, s = s_lo(u_begin), kk = 0;  // the tile being multiplied
    for (int i = 0; i < total; ++i) {
        if (kk == 0 && s == s_lo(u)) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
        }
        tbt::cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (i + STAGES - 1 < total) load_next((i + STAGES - 1) % STAGES);
        tbt::cp_async_commit();
        const int stage = i % STAGES;
        mma_tile<BM, BN>(sa + stage * A_STAGE, sb + stage * B_STAGE, wm, wn,
                         lane, acc);
        if (++kk < ksteps) continue;
        kk = 0;
        if (++s <= s_hi(u)) continue;

        // band u is complete: fold it in
        const float scale = ldexpf(1.0f, -w * (u + 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float v = __fmul_rn(acc[mt][nt][q], scale);
                    if constexpr (FUSED) {
                        fold(h[mt][nt][q], l[mt][nt][q], v, u == 0);
                    } else {
                        const int m = m0 + wm * WARP_M + mt * 16 + lane / 4 +
                                      8 * (q / 2);
                        const long long n = n0 + wn * WARP_N + nt * 8 +
                                            2 * (lane % 4) + q % 2;
                        if (m >= m_rows || n >= n_cols) continue;
                        const size_t at = static_cast<size_t>(m) * n_cols + n;
                        float hv = u == 0 ? 0.0f : hi[at];
                        float lv = u == 0 ? 0.0f : lo[at];
                        fold(hv, lv, v, u == 0);
                        hi[at] = hv;
                        lo[at] = lv;
                    }
                }
        ++u;
        s = s_lo(u);
    }

    if constexpr (FUSED) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int m =
                        m0 + wm * WARP_M + mt * 16 + lane / 4 + 8 * (q / 2);
                    const long long n =
                        n0 + wn * WARP_N + nt * 8 + 2 * (lane % 4) + q % 2;
                    if (m >= m_rows || n >= n_cols) continue;
                    const size_t at = static_cast<size_t>(m) * n_cols + n;
                    hi[at] = h[mt][nt][q];
                    lo[at] = l[mt][nt][q];
                }
    }
}

template <int BM, int BN, bool FUSED>
int launch_tile(const bf16* c, const bf16* x, float* hi, float* lo, int t_c,
                int t_x, int m_rows, int k_depth, long long n_cols, int w,
                int u_begin, int u_end, cudaStream_t stream) {
    const long long blocks =
        (n_cols + BN - 1) / BN * ((m_rows + BM - 1) / BM);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    static tbt::DeviceCache<> optin;  // the opt-in, once per device
    auto kernel = ozaki_mma_kernel<BM, BN, FUSED>;
    constexpr size_t smem = smem_bytes<BM, BN>();
    const cudaError_t err = tbt::optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    const bool vec_x = n_cols % 8 == 0 && tbt::aligned16(x);
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
        c, x, hi, lo, t_c, t_x, m_rows, k_depth, n_cols, w, u_begin, u_end,
        vec_x);
    return cudaGetLastError();
}

int launch(const void* c, const void* x, void* hi, void* lo, int t_c,
           int t_x, int m_rows, int k_depth, long long n_cols, int w,
           int u_begin, int u_end, cudaStream_t stream) {
    if (m_rows <= 0 || n_cols <= 0) return cudaSuccess;
    const int n_bands = t_c > t_x ? t_c : t_x;
    if (t_c <= 0 || t_x <= 0 || k_depth <= 0 || w <= 0 || u_begin < 0 ||
        u_begin >= u_end || u_end > n_bands || !tbt::aligned16(c))
        return cudaErrorInvalidValue;
    const auto* cb = static_cast<const bf16*>(c);
    const auto* xb = static_cast<const bf16*>(x);
    auto* h = static_cast<float*>(hi);
    auto* l = static_cast<float*>(lo);
    const bool fused = u_begin == 0 && u_end == n_bands;
    if (m_rows <= 64)
        return fused ? launch_tile<64, 128, true>(cb, xb, h, l, t_c, t_x,
                                                  m_rows, k_depth, n_cols, w,
                                                  u_begin, u_end, stream)
                     : launch_tile<64, 128, false>(cb, xb, h, l, t_c, t_x,
                                                   m_rows, k_depth, n_cols, w,
                                                   u_begin, u_end, stream);
    return fused ? launch_tile<128, 64, true>(cb, xb, h, l, t_c, t_x, m_rows,
                                              k_depth, n_cols, w, u_begin,
                                              u_end, stream)
                 : launch_tile<128, 64, false>(cb, xb, h, l, t_c, t_x, m_rows,
                                               k_depth, n_cols, w, u_begin,
                                               u_end, stream);
}

}  // namespace

// The row padding C's slices must carry: c is (T_c, m_rows, k_pad), k_pad =
// k_depth rounded up to a multiple of this, zero past k_depth.
extern "C" int tbt_ozaki_k_pad() { return K_PAD; }

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
