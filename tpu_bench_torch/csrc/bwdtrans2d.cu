// K2 kron_blocked and K3 em_gemm: the GEMMs over the element stream.
//
// K2 replaces the Pallas kernel tpu_bench/kernels/bwdtrans2d.py:kron_blocked
// (_kron_blk_kernel), benchmark05's Pallas(Coales) column from nq=8^3 up,
// stage 1 of Pallas(QP) (tpu_bench/kernels/bwdtrans3d.py:qp_global3d,
// _stage1_kernel3d: w[p] = C12T @ in[p]; bwdtrans2d.py:qp_global in 2D),
// and through views of the same bytes kron_coalesced, kron_wide4 and
// kron_vpu_blocked:
//
//   out[b] (M x N) = C (M x K) @ in[b] (K x N)
//
// for every contiguous element chunk b.
//
// K3 replaces tpu_bench/kernels/bwdtrans2d.py:kron_elem_major
// (_kron_em_kernel, Pallas(Uncoales)) and _one_stage_em (_stage_em_kernel,
// the three stages of Pallas(QP-1D)): the element-major product
//
//   out (E x N) = X (E x K) @ S (K x N),  elements on rows.
//
// K2's products are of two kinds, and one kernel entry runs each on the
// configuration it is given.  The rule (kron_config in
// kernels/bwdtrans2d.py, which passes its choice): C resident when C^T and
// a ring of RING strips of in[b] fit the card's opt-in shared memory at
// some strip width, else dense.
//
// (a) C resident: the skinny products (Pallas(QP) stage 1, 64 x 49 at b05
// nq=8^3 and 8 x 7 at b04 nq=8^2; kron_wide4 and kron_coalesced at b04
// nq=8^2, 64 x 49).  They do 2*M*K FLOP for 4*(K + M) bytes of each element
// column, under 30 FLOP per byte, so the bytes bound them.  The first
// design ran them on a 128 x 128 output tile, so 64 or 8 of its 128 rows
// worked, and read the element stream in scalar loads.  Here a persistent
// block (as many as fit an SM, times the SMs) stages C transposed in
// shared memory once and streams strips of BN element columns (K x BN) of
// in[b] through a ring of RING shared-memory slots filled by 16-byte
// cp.async (one element a copy where rows are not whole 16-byte words),
// walking the strips of every chunk in a grid-stride loop on blockIdx.x
// (no 65535-chunk limit).  All M rows of a strip are computed by 4 x 4
// register micro-tiles spread over the 256 threads, e fastest: one 16-byte
// load of C^T and one of the strip per k feed 16 FMAs, and each thread
// writes 4 consecutive columns of 4 rows (16-byte stores where aligned).
// BN is the narrowest of 64..512 whose micro-tiles fill the block (512 for
// M = 8, 64 for M = 64): within 4% of the fastest strip, and 1.2-11x
// faster than the dense configuration, at b05's Pallas(QP) stage 1 and
// b04's stage 1 and kron_wide4 in f32 and f64
// (benchmarks/kernel_blocks.py).
//
// (b) Dense: C does not fit (b05 nq=8^3: 512 x 343; b04 from nq=14^2 in
// f32 and 12^2 in f64).
// The product does 2*M*K FLOP per column, about 100 FLOP per byte in f32,
// far above the card's FP32 FMA-to-bandwidth ratio, so the operations
// bound it, and a SIMT design cannot get far under cuBLAS.  It runs on
// the tensor cores with mma.sync:
//   - f32: 3xTF32 as in K5 (csrc/qp1d_fused3d.cu): each operand split into
//     big (rounded to TF32) and small (tbt::split_tf32), small*big +
//     big*small + big*big summed by mma.sync.m16n8k8 into a partial sum
//     one BK-deep step long, added to the tile's sum in f32
//     round-to-nearest: the tensor cores' f32 sums truncate, and over the
//     whole depth that bias breaks the 1e-5 held against the FP32 plain
//     version (tests/test_torch_tensorcore.py).  Never plain TF32: the f32
//     columns are held to 5e-4 of each other;
//   - f64: sm_90's mma.sync.m16n8k8 on f64 (DMMA), IEEE FP64 FMA, 1024
//     FMAs an instruction: the H100 runs it at 66.7 TFLOP/s and the
//     A100's m8n8k4 at 33.6 (scripts/dmma_probe.cu).  Each lane's k slots
//     take neighbouring k, so its fragments come in 16-byte loads;
//   - f32: 128 x 128 output tiles, 8 warps of 64 x 32, one block an SM;
//     f64: 128 x 64 tiles, 4 warps of 64 x 32, two blocks an SM.  The C
//     tile (128 x BK) and the in tile (BK x the tile's width) go through a
//     ring of RING slots (three; two in f64) filled by cp.async; rows
//     padded so the fragment loads hit distinct banks.  f64's copies keep
//     one column a thread and step its rows by a stride (copy_tile_f64):
//     the general copy's index arithmetic and the addresses it held
//     across the k loop spilled the f64 body and took as long as its mma;
//   - tile order on a 1D grid, M tiles fastest (MFast): the blocks that
//     share an in[b] tile run together and find it in L2, as C does.
//   This body is one templated GEMM, dense_gemm_kernel, which K3's dense
//   configuration launches too, with its own tile order (NFast below).
//   In f32 it stayed short of cuBLAS at b05 nq=8^3 (PERF.md section 6):
//   the operand splits and fragment loads of mma.sync cost about as many
//   instructions as the mma, and C's 343-wide rows are not whole 16-byte
//   words, so its tiles come in 4-byte copies (8-byte in f64).
// (b') Dense in f32 on wgmma, K2's body wherever in's rows are whole
// 16-byte words on a 16-byte boundary (dense_body in
// kernels/bwdtrans2d.py, which passes its choice; else (b) runs): the
// same 3xTF32 arithmetic and 32-deep partial sums, as wgmma.mma_async
// m64n128k8 products, the only way to the H100's full tensor-core rate.
// A tf32 operand is read from shared memory K-major only, and in[b] is
// not, so a tile is computed transposed, out[b]^T = in[b]^T C^T: A is
// in[b]^T in registers, each value loaded and split once by the one
// thread that feeds it; B is C's big and small halves in shared memory.
// A persistent block an SM of three warp groups: a producer (its
// registers handed to the others by setmaxnreg) whose thread 0 asks the
// TMA for in's BK x (BE + 8) tile (a tensor map; zeros past K and E) and
// whose warps load C's BM x BK tile a row a warp instruction, split each
// value once and store both halves in the descriptors' layout; and two
// consumer groups of 64 elements x 128 points, each holding its partial
// sums and the tile's.  A ring of three stages between them, each signalled
// by mbarriers both ways; the tile leaves transposed through shared
// memory in 16-byte stores along the elements.  C cannot come by TMA
// (rows of 1,372 bytes break its 16-byte stride rule), and is split anew
// in every call.  What bounds it (PERF.md section 7): at b05 nq=8^3 it
// runs at 62% of its units; C's tile, read from L2 and split anew for
// each 128 x 128 tile, takes a sixth of its time, and each consumer group
// waits on its partial sum every stage; back to back the card reaches
// its power cap.  Clusters that share C's halves are later work.
// M, N, K and E edges are masked in both: zero-filled copies, masked
// stores.
//
// bf16 (benchmarks 04 and 05 with --dtype bf16): both configurations store
// bf16 and sum in f32, and each output is rounded to bf16 once, as the JAX
// kernels' _dot (bf16 operands, f32 accumulator) then .astype do.  The
// SIMT configurations widen each value as they load it; the dense body
// runs one mma.sync.m16n8k16 pass (bf16 in, f32 sums) per 16-deep k step
// on fragments loaded by ldmatrix, as K14 loads them: bf16 products are
// exact, so no split.  At b05 nq=8^3 the dense product's least FLOP
// (4.6e10) takes 0.047 ms at the bf16 tensor cores' 989 TFLOP/s, under its
// 0.067 ms of bf16 bytes; a TF32 pass on widened operands (495 TFLOP/s)
// would take 0.093 ms and bind it on the units.  Rows that are not whole
// 16-byte words (K = 343) come in one value a copy, by plain loads
// (tbt::cp_async<2>).
//
// K3's products are of the same two kinds, and one kernel entry runs each
// on the configuration it is given, by one rule (em_config in
// kernels/bwdtrans2d.py, which passes its choice): S resident when S (K x
// N, N padded to 64) and a ring of RING element tiles fit the card's
// opt-in shared memory at some tile height, else dense.
//
// (a) S resident: the skinny products (b04 nq=8^2 kron_elem_major 49 x 64
// and QP-1D stages 49 x 56, 56 x 64; b05 to nq=6^3 in f32; b04 to nq=14^2
// in f32), bound by bytes like K2's.  A persistent block (as many as fit
// an SM, times the SMs) stages S once and walks tiles of BE element rows
// in a grid-stride loop.  An element-major tile is one contiguous span of
// BE*K values (BE a multiple of 32, so each tile starts on a 16-byte
// boundary), so it comes through a ring of RING slots by flat 16-byte
// cp.async, the ragged end of X zero-filled, whatever K is.  Each warp
// computes units of 32 rows x 64 columns: lane = 8 * eg + j, micro-tile
// 8 rows (eg, eg + 4, .., eg + 28) x 8 columns (16-byte pieces at j * 16
// B + a multiple of 128 B).  Per k a thread loads 8 values of X (the four
// row groups of a warp sit K apart: distinct banks in f32 unless K is a
// multiple of 16) and two (f32) or four (f64) 16-byte pieces of S, shared
// by the warp's four row groups, for 64 FMAs; each warp store writes 128
// contiguous bytes of each of four output rows.  A 16-byte load of S
// takes four quarter-warp passes of shared memory whatever the broadcast,
// so 8 rows a thread rather than 4 halve those passes per FMA, and a ring
// of 2 rather than 3 lets two blocks share an SM at b04 nq=8^2 (f32: 127
// registers): 3-10% faster there in f32, 5-7% in f64, 16% at b05 nq=6^3.
// BE is the narrowest of 32..256 whose units fill the block's 8 warps
// (256 at N <= 64), narrowed until S and the ring fit
// (benchmarks/kernel_blocks.py).
//
// (b) Dense: S does not fit (b05 nq=8^3: 343 x 512 and the QP-1D stages
// 343 x 392, 392 x 448, 448 x 512; b04 from nq=16^2 in f32).  K2's dense
// body with A = X (E x K) and B = S, one chunk, and the tile order NFast:
// the N tiles of one element strip are neighbours on the grid, so X, the
// streamed operand (180 MB at b05 f32), is read from HBM once and S (under
// 1 MB) stays in L2.  At K = 343 X's rows are not whole 16-byte words, so
// its tiles come in 4-byte copies; at 392 and 448 in 16-byte ones.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// ---- K2 kron_blocked --------------------------------------------------------

constexpr int KB_THREADS = 256;
constexpr int KB_RING = 3;  // strips (a) or operand tiles (b) in flight

__host__ __device__ constexpr int round_up(int n, int m) {
    return (n + m - 1) / m * m;
}

// (a) C resident: 4 x 4 micro-tiles; strip widths 64..512.
constexpr int KR_TM = 4, KR_TN = 4;

// C^T's values, a whole number of 16-byte words (bf16 with K odd), so the
// ring behind it starts on a 16-byte boundary.
template <typename T>
__host__ __device__ int kron_ct_values(int m_rows, int k_depth) {
    return round_up(k_depth * round_up(m_rows, KR_TM),
                    static_cast<int>(16 / sizeof(T)));
}

template <typename T>
size_t kron_resident_smem(int m_rows, int k_depth, int bn) {
    return sizeof(T) *
           (static_cast<size_t>(kron_ct_values<T>(m_rows, k_depth)) +
            static_cast<size_t>(KB_RING) * k_depth * bn);
}

template <typename T, int BN>
__global__ void __launch_bounds__(KB_THREADS)
    kron_resident_kernel(const T* __restrict__ c, const T* __restrict__ in,
                         T* __restrict__ out, int m_rows, int k_depth,
                         int n_cols, long long n_strips) {
    using A = tbt::Acc<T>;
    constexpr int TX = BN / KR_TN;
    constexpr int V16 = 16 / sizeof(T);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int mp = round_up(m_rows, KR_TM), mgs = mp / KR_TM;
    T* s_ct = reinterpret_cast<T*>(smem_raw);             // (K, mp): C^T
    T* ring = s_ct + kron_ct_values<T>(m_rows, k_depth);  // RING x (K, BN)
    const size_t slot = static_cast<size_t>(k_depth) * BN;
    const int strips = (n_cols + BN - 1) / BN;  // per chunk
    const bool vec_in = n_cols % V16 == 0 && tbt::aligned16(in);
    const bool vec_out =
        (static_cast<long long>(n_cols) * sizeof(T)) % 16 == 0 &&
        tbt::aligned16(out);

    // strip s (chunk s / strips, columns from (s % strips) * BN) into slot
    auto load = [&](long long s, int r) {
        tbt::copy_tile_async<T, BN, KB_THREADS>(
            ring + r * slot, BN, k_depth, in + (s / strips) * k_depth * n_cols,
            n_cols, 0, (s % strips) * BN, k_depth, n_cols, vec_in);
    };
    // the ring's first strips are in flight while C is staged
#pragma unroll
    for (int i = 0; i < KB_RING - 1; ++i) {
        const long long s = blockIdx.x + static_cast<long long>(i) * gridDim.x;
        if (s < n_strips) load(s, i);
        tbt::cp_async_commit();
    }
    for (int t = threadIdx.x; t < k_depth * mp; t += KB_THREADS) {
        const int k = t / mp, m = t % mp;
        s_ct[t] = m < m_rows ? c[m * k_depth + k] : tbt::narrow<T>(0);
    }

    int i = 0;
    for (long long s = blockIdx.x; s < n_strips; s += gridDim.x, ++i) {
        tbt::cp_async_wait<KB_RING - 2>();
        __syncthreads();  // strip i landed; slot (i - 1) % RING is free
        const long long next =
            s + static_cast<long long>(KB_RING - 1) * gridDim.x;
        if (next < n_strips) load(next, (i + KB_RING - 1) % KB_RING);
        tbt::cp_async_commit();

        const T* x = ring + (i % KB_RING) * slot;
        T* y = out + (s / strips) * m_rows * n_cols;
        const int n0 = static_cast<int>(s % strips) * BN;
        for (int q = threadIdx.x; q < mgs * TX; q += KB_THREADS) {
            const int e = (q % TX) * KR_TN, mg = q / TX;
            A acc[KR_TM][KR_TN];
#pragma unroll
            for (int r = 0; r < KR_TM; ++r)
#pragma unroll
                for (int cc = 0; cc < KR_TN; ++cc) acc[r][cc] = A(0);
#pragma unroll 4
            for (int k = 0; k < k_depth; ++k) {
                A cv[KR_TM], xv[KR_TN];
                tbt::load4(s_ct + k * mp + mg * KR_TM, cv);
                tbt::load4(x + k * BN + e, xv);
#pragma unroll
                for (int r = 0; r < KR_TM; ++r)
#pragma unroll
                    for (int cc = 0; cc < KR_TN; ++cc)
                        acc[r][cc] = fma(cv[r], xv[cc], acc[r][cc]);
            }
            const int n = n0 + e;
#pragma unroll
            for (int r = 0; r < KR_TM; ++r) {
                const int m = mg * KR_TM + r;
                if (m >= m_rows) break;
                T* dst = y + static_cast<long long>(m) * n_cols + n;
                if (vec_out && n + KR_TN <= n_cols) {
                    tbt::store4(dst, acc[r]);
                } else {
#pragma unroll
                    for (int cc = 0; cc < KR_TN; ++cc)
                        if (n + cc < n_cols)
                            dst[cc] = tbt::narrow<T>(acc[r][cc]);
                }
            }
        }
    }
}

// ROWS x COLS doubles of a row-major global matrix (row stride ld_g) from
// (r0, c0) into shared memory of row stride ld_s by cp.async of V values,
// zero past n_rows and n_cols, as tbt::copy_tile_async copies them; but a
// thread keeps one column and every STEP-th row, so its source is one
// pointer advanced by a fixed stride a copy and its row test one compare
// (tbt::copy_tile_async's per-copy index arithmetic and addresses held
// across the k loop cost the f64 body the registers it spilled).
template <int ROWS, int COLS, int NTH, int V>
__device__ __forceinline__ void copy_rows_f64(
    double* dst, int ld_s, const double* __restrict__ src, long long ld_g,
    long long r0, long long c0, long long n_rows, long long n_cols) {
    constexpr int PER_ROW = COLS / V, STEP = NTH / PER_ROW;
    static_assert(NTH % PER_ROW == 0 && ROWS % STEP == 0, "whole passes");
    const int r = threadIdx.x / PER_ROW, c = threadIdx.x % PER_ROW * V;
    const long long rows_left = n_rows - r0 - r;
    const bool col = c0 + c < n_cols;
    const double* s = src + (r0 + r) * ld_g + c0 + c;
#pragma unroll
    for (int j = 0; j < ROWS / STEP; ++j) {
        const bool ok = col && j * STEP < rows_left;
        tbt::cp_async<8 * V>(dst + (r + j * STEP) * ld_s + c, ok ? s : src,
                             ok);
        s += STEP * ld_g;
    }
}

// vec: 16-byte copies (rows of whole 16-byte words, c0 and COLS even);
// else one value a copy.
template <int ROWS, int COLS, int NTH>
__device__ __forceinline__ void copy_tile_f64(
    double* dst, int ld_s, const double* __restrict__ src, long long ld_g,
    long long r0, long long c0, long long n_rows, long long n_cols,
    bool vec) {
    if (vec)
        copy_rows_f64<ROWS, COLS, NTH, 2>(dst, ld_s, src, ld_g, r0, c0,
                                          n_rows, n_cols);
    else
        copy_rows_f64<ROWS, COLS, NTH, 1>(dst, ld_s, src, ld_g, r0, c0,
                                          n_rows, n_cols);
}

// (b) Dense on the tensor cores: WM x WN warps, each WMT x WNT mma tiles
// of MMA_M x 8, so a block tile of (WM*WMT*MMA_M) x (WN*WNT*8); BK deep a
// ring slot.  A_PAD and B_PAD make the row strides 4 mod 32 (A) and 8 mod
// 32 (B) banks in f32, so the fragment loads are conflict-free; in bf16
// they make the rows 80 (A) and 272 (B) bytes apart, so the 8 rows of an
// ldmatrix hit 8 distinct 16-byte bank groups.  f64 loads its fragments
// in 16 bytes, a quarter-warp's 8 loads one pass over the 16 bank pairs:
// A rows 8 mod 16 pairs apart (lanes t = 0..3 read pairs 2t of rows g =
// 0, 1) and B rows 2 mod 16 (lanes read pairs 2g of rows 2t + i), both
// conflict-free.
template <typename T>
struct Dense;
template <>
struct Dense<float> {
    static constexpr int BK = 32, MMA_M = 16, A_PAD = 4, B_PAD = 8;
};
template <>
struct Dense<double> {
    static constexpr int BK = 16, MMA_M = 16, A_PAD = 8, B_PAD = 2;
};
template <>
struct Dense<tbt::bf16> {
    static constexpr int BK = 32, MMA_M = 16, A_PAD = 8, B_PAD = 8;
};

// The dense GEMM's ring of operand tiles: KB_RING, but two in f64, whose
// copies have one step's mma to land in (1-2% faster than three at K2's
// and K3's b05 nq=8^3 products, benchmarks/kernel_blocks.py).
template <typename T>
constexpr int dense_ring = sizeof(T) == 8 ? 2 : KB_RING;

template <typename T, int BM, int BN>
constexpr size_t kron_dense_smem() {
    using D = Dense<T>;
    return sizeof(T) * dense_ring<T> *
           (static_cast<size_t>(BM) * (D::BK + D::A_PAD) +
            static_cast<size_t>(D::BK) * (BN + D::B_PAD));
}

// Tile orders of the dense GEMM on a 1D grid: block b's chunk, M tile
// and N tile.  MFast (K2): M tiles fastest, then N tiles, then chunks.
// NFast (K3): N tiles fastest, so the blocks that read one strip of the
// A operand run together.
struct MFast {
    __device__ static void tile(unsigned b, int m_tiles, int n_tiles,
                                int& mt, int& nt) {
        mt = static_cast<int>(b % m_tiles);
        nt = static_cast<int>((b / m_tiles) % n_tiles);
    }
};
struct NFast {
    __device__ static void tile(unsigned b, int m_tiles, int n_tiles,
                                int& mt, int& nt) {
        nt = static_cast<int>(b % n_tiles);
        mt = static_cast<int>((b / n_tiles) % m_tiles);
    }
};

// out[b] (M x N) = c (M x K) @ in[b] (K x N) for every chunk b, all
// row-major: K2's dense configuration (c = C), and K3's (c = X, in = S,
// one chunk).
template <typename T, int WM, int WN, int WMT, int WNT, int MINB,
          typename Order>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
    dense_gemm_kernel(const T* __restrict__ c, const T* __restrict__ in,
                      T* __restrict__ out, int m_rows, int k_depth,
                      int n_cols) {
    using D = Dense<T>;
    constexpr int BK = D::BK, MT = WMT, MMA_M = D::MMA_M, KD_NT = WNT;
    constexpr int KD_BM = WM * WMT * MMA_M, KD_BN = WN * WNT * 8;
    constexpr int NTH = 32 * WM * WN, WTM = WMT * MMA_M, WTN = WNT * 8;
    constexpr int LDA = BK + D::A_PAD, LDB = KD_BN + D::B_PAD;
    constexpr int SLOT = KD_BM * LDA + BK * LDB;
    constexpr int FRAG = MMA_M * 8 / 32;  // accumulators of a lane
    constexpr int RING = dense_ring<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int m_tiles = (m_rows + KD_BM - 1) / KD_BM;
    const int n_tiles = (n_cols + KD_BN - 1) / KD_BN;
    int mt, nt;
    Order::tile(blockIdx.x, m_tiles, n_tiles, mt, nt);
    const int m0 = mt * KD_BM, n0 = nt * KD_BN;
    const long long chunk = blockIdx.x / (static_cast<long long>(m_tiles) *
                                          n_tiles);
    const T* b = in + chunk * k_depth * n_cols;
    T* y = out + chunk * m_rows * n_cols;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = (warp / WN) * WTM, col0 = (warp % WN) * WTN;
    const int ksteps = (k_depth + BK - 1) / BK;
    constexpr int V = 16 / sizeof(T);
    const bool vec_a = k_depth % V == 0 && tbt::aligned16(c);
    const bool vec_b = n_cols % V == 0 && tbt::aligned16(in);

    // bf16 rows of A that are not whole 16-byte words (K = 343) have no
    // cp.async form: such an A tile comes through registers (A_PER
    // values a thread), its loads issued before the step's mma and its
    // stores after them, so their latency overlaps the mma.
    const bool reg_a = sizeof(T) == 2 && !vec_a;
    constexpr int A_PER = sizeof(T) == 2 ? KD_BM * BK / NTH : 1;
    unsigned short a_next[A_PER];
    auto fetch_a = [&](int i) {
#pragma unroll
        for (int j = 0; j < A_PER; ++j) {
            const int q = threadIdx.x + j * NTH, r = q / BK, k = i * BK + q % BK;
            a_next[j] = m0 + r < m_rows && k < k_depth
                            ? reinterpret_cast<const unsigned short*>(
                                  c)[static_cast<long long>(m0 + r) * k_depth +
                                     k]
                            : static_cast<unsigned short>(0);
        }
    };
    auto put_a = [&](int i) {
        unsigned short* a_s =
            reinterpret_cast<unsigned short*>(smem + (i % RING) * SLOT);
#pragma unroll
        for (int j = 0; j < A_PER; ++j) {
            const int q = threadIdx.x + j * NTH;
            a_s[(q / BK) * LDA + q % BK] = a_next[j];
        }
    };
    auto load = [&](int i) {
        T* a_s = smem + (i % RING) * SLOT;
        if constexpr (sizeof(T) == 8) {
            copy_tile_f64<KD_BM, BK, NTH>(a_s, LDA, c, k_depth, m0, i * BK,
                                          m_rows, k_depth, vec_a);
            copy_tile_f64<BK, KD_BN, NTH>(a_s + KD_BM * LDA, LDB, b, n_cols,
                                          i * BK, n0, k_depth, n_cols, vec_b);
        } else {
            if (!reg_a)
                tbt::copy_tile_async<T, BK, NTH>(a_s, LDA, KD_BM, c, k_depth,
                                                 m0, i * BK, m_rows, k_depth,
                                                 vec_a);
            tbt::copy_tile_async<T, KD_BN, NTH>(a_s + KD_BM * LDA, LDB, BK, b,
                                                n_cols, i * BK, n0, k_depth,
                                                n_cols, vec_b);
        }
    };
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) {
        if (i < ksteps) {
            load(i);
            if (reg_a) {
                fetch_a(i);
                put_a(i);
            }
        }
        tbt::cp_async_commit();
    }

    using A = tbt::Acc<T>;
    A acc[MT][KD_NT][FRAG];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < KD_NT; ++nt)
#pragma unroll
            for (int q = 0; q < FRAG; ++q) acc[mt][nt][q] = A(0);

    for (int i = 0; i < ksteps; ++i) {
        tbt::cp_async_wait<RING - 2>();
        __syncthreads();
        const bool more = i + RING - 1 < ksteps;
        if (more) {
            load(i + RING - 1);
            if (reg_a) fetch_a(i + RING - 1);
        }
        tbt::cp_async_commit();
        const T* a_s = smem + (i % RING) * SLOT + row0 * LDA;
        const T* b_s = smem + (i % RING) * SLOT + KD_BM * LDA + col0;
        if constexpr (sizeof(T) == 2) {
            // one m16n8k16 pass a 16-deep step: exact bf16 products, f32
            // sums (A rows from ldmatrix, B columns from its transpose)
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                unsigned af[MT][4], bf[KD_NT][2];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                    tbt::ldmatrix_x4(af[mt], a_s + (mt * 16 + lane % 16) * LDA +
                                                 kk + (lane / 16) * 8);
#pragma unroll
                for (int np = 0; np < KD_NT / 2; ++np) {
                    unsigned r[4];
                    tbt::ldmatrix_x4_trans(
                        r, b_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDB +
                               np * 16 + (lane / 16) * 8);
                    bf[2 * np][0] = r[0];
                    bf[2 * np][1] = r[1];
                    bf[2 * np + 1][0] = r[2];
                    bf[2 * np + 1][1] = r[3];
                }
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < KD_NT; ++nt)
                        tbt::mma_bf16(acc[mt][nt], af[mt], bf[nt]);
            }
        } else if constexpr (sizeof(T) == 4) {
            // one BK-deep step summed alone, then added in round-to-nearest
            float part[MT][KD_NT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < KD_NT; ++nt)
#pragma unroll
                    for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < BK; kk += 8) {
                unsigned ab[MT][4], as[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const float* a = a_s + (mt * 16 + g) * LDA + kk + t;
                    tbt::split_tf32(a[0], ab[mt][0], as[mt][0]);
                    tbt::split_tf32(a[8 * LDA], ab[mt][1], as[mt][1]);
                    tbt::split_tf32(a[4], ab[mt][2], as[mt][2]);
                    tbt::split_tf32(a[8 * LDA + 4], ab[mt][3], as[mt][3]);
                }
#pragma unroll
                for (int nt = 0; nt < KD_NT; ++nt) {
                    const float* bp = b_s + (kk + t) * LDB + nt * 8 + g;
                    unsigned bb[2], bs[2];
                    tbt::split_tf32(bp[0], bb[0], bs[0]);
                    tbt::split_tf32(bp[4 * LDB], bb[1], bs[1]);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        tbt::mma_tf32(part[mt][nt], as[mt], bb);
                        tbt::mma_tf32(part[mt][nt], ab[mt], bs);
                        tbt::mma_tf32(part[mt][nt], ab[mt], bb);
                    }
                }
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < KD_NT; ++nt)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        acc[mt][nt][q] += part[mt][nt][q];
        } else {
            // sm_90's m16n8k8: lane 4g + t's k slots t and t + 4 take k 2t
            // and 2t + 1 of the 8 (the same sum, its terms in another
            // order), so a row's two values are one 16-byte load; n slot g
            // of tiles 2p and 2p + 1 takes columns 16p + 2g and + 1, so a
            // k's two values of B are one 16-byte load too
            static_assert(KD_NT % 2 == 0, "B loads pair the n tiles");
#pragma unroll
            for (int kk = 0; kk < BK; kk += 8) {
                double bf[KD_NT][2];
#pragma unroll
                for (int np = 0; np < KD_NT / 2; ++np)
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const double2 v = *reinterpret_cast<const double2*>(
                            b_s + (kk + 2 * t + r) * LDB + np * 16 + 2 * g);
                        bf[2 * np][r] = v.x;
                        bf[2 * np + 1][r] = v.y;
                    }
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const double* a = a_s + (mt * 16 + g) * LDA + kk + 2 * t;
                    const double2 lo = *reinterpret_cast<const double2*>(a);
                    const double2 hi =
                        *reinterpret_cast<const double2*>(a + 8 * LDA);
                    const double af[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
                    for (int nt = 0; nt < KD_NT; ++nt)
                        tbt::mma_f64_16x8x8(acc[mt][nt], af, bf[nt]);
                }
            }
        }
        if (reg_a && more) put_a(i + RING - 1);
    }

    const bool pairs = n_cols % 2 == 0 && tbt::aligned16(out);
    if constexpr (sizeof(T) == 8) {
        // tiles 2p + q hold columns 16p + 4t + 2r + q of row g + 8h in
        // acc[mt][2p + q][2h + r]: four neighbouring columns a lane
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int np = 0; np < KD_NT / 2; ++np)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int m = m0 + row0 + mt * 16 + g + 8 * h;
                    const int n = n0 + col0 + np * 16 + 4 * t;
                    if (m >= m_rows) continue;
                    T* dst = y + static_cast<long long>(m) * n_cols + n;
                    const double v[4] = {acc[mt][2 * np][2 * h],
                                         acc[mt][2 * np + 1][2 * h],
                                         acc[mt][2 * np][2 * h + 1],
                                         acc[mt][2 * np + 1][2 * h + 1]};
#pragma unroll
                    for (int c = 0; c < 4; c += 2) {
                        if (n + c >= n_cols) break;
                        if (pairs) {
                            *reinterpret_cast<double2*>(dst + c) =
                                make_double2(v[c], v[c + 1]);
                        } else {
                            dst[c] = v[c];
                            if (n + c + 1 < n_cols) dst[c + 1] = v[c + 1];
                        }
                    }
                }
    } else {
        // fragment value q sits at row g + 8*(q/2), column 2t + q%2 of its
        // tile
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < KD_NT; ++nt)
#pragma unroll
                for (int h = 0; h < FRAG / 2; ++h) {
                    const int m = m0 + row0 + mt * MMA_M + g + 8 * h;
                    const int n = n0 + col0 + nt * 8 + 2 * t;
                    if (m >= m_rows || n >= n_cols) continue;
                    T* dst = y + static_cast<long long>(m) * n_cols + n;
                    const A v0 = acc[mt][nt][2 * h],
                            v1 = acc[mt][nt][2 * h + 1];
                    if (pairs) {
                        if constexpr (sizeof(T) == 2)
                            *reinterpret_cast<unsigned*>(dst) =
                                tbt::pack_bf16(v0, v1);
                        else
                            *reinterpret_cast<float2*>(dst) =
                                make_float2(v0, v1);
                    } else {
                        dst[0] = tbt::narrow<T>(v0);
                        if (n + 1 < n_cols) dst[1] = tbt::narrow<T>(v1);
                    }
                }
    }
}

// The shared-memory opt-in and the occupancy at each size are asked of the
// runtime once per device (tbt::DeviceCache), not at every launch.
template <typename T, int BN>
int launch_resident(const T* c, const T* in, T* out, int m_rows, int k_depth,
                    int n_cols, int n_chunks, cudaStream_t stream) {
    static tbt::DeviceCache<> optin, waves;
    const size_t smem = kron_resident_smem<T>(m_rows, k_depth, BN);
    auto kernel = kron_resident_kernel<T, BN>;
    const cudaError_t err = tbt::optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    const long long full = tbt::wave_blocks(waves, kernel, KB_THREADS, smem);
    if (full < 0) return static_cast<int>(-full);
    if (full == 0) return cudaErrorInvalidConfiguration;
    const long long strips =
        static_cast<long long>(n_chunks) * ((n_cols + BN - 1) / BN);
    const unsigned blocks =
        static_cast<unsigned>(strips < full ? strips : full);
    kernel<<<blocks, KB_THREADS, smem, stream>>>(c, in, out, m_rows, k_depth,
                                                 n_cols, strips);
    return cudaGetLastError();
}

template <typename T, int WM, int WN, int WMT, int WNT, int MINB,
          typename Order>
int launch_dense(const T* c, const T* in, T* out, int m_rows, int k_depth,
                 int n_cols, int n_chunks, cudaStream_t stream) {
    constexpr int BM = WM * WMT * Dense<T>::MMA_M, BN = WN * WNT * 8;
    constexpr size_t smem = kron_dense_smem<T, BM, BN>();
    static tbt::DeviceCache<> optin;
    auto kernel = dense_gemm_kernel<T, WM, WN, WMT, WNT, MINB, Order>;
    const cudaError_t err = tbt::optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    const long long tiles = static_cast<long long>(n_chunks) *
                            ((m_rows + BM - 1) / BM) *
                            ((n_cols + BN - 1) / BN);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<unsigned>(tiles), 32 * WM * WN, smem, stream>>>(
        c, in, out, m_rows, k_depth, n_cols);
    return cudaGetLastError();
}

// f64's dense tile: WM x WN warps of WMT x WNT m16n8k8 tiles, MINB blocks
// an SM (launch_dense_tiles; kernels/bwdtrans2d.py DENSE_F64 mirrors it).
struct DenseF64 {
    static constexpr int WM = 2, WN = 2, WMT = 4, WNT = 4, MINB = 2;
};

// The dense GEMM's tile shapes.  f32: 128 x 128 tiles of 8 warps of 64 x
// 32, one block an SM (237 registers); f64: 128 x 64 tiles of 4 warps of
// 64 x 32, two blocks an SM (m16n8k8, BK 16, a ring of two).  The fastest
// of the tile shapes tried on the H100, in f64 at K2's and K3's five b05
// nq=8^3 products alike (benchmarks/kernel_blocks.py; PERF.md section 6):
// 128 x 128 or 256 x 64 tiles of 8 warps, one block an SM, were 10-25%
// slower; 32 x 32 warp tiles and m16n8k16 spilled.  bf16: f32's tiles,
// one block an SM (under the 128 registers of two it spilled 96 bytes).
template <typename T, typename Order>
int launch_dense_tiles(const T* c, const T* in, T* out, int m_rows,
                       int k_depth, int n_cols, int n_chunks,
                       cudaStream_t stream) {
    if constexpr (sizeof(T) == 2)
        return launch_dense<T, 2, 4, 4, 4, 1, Order>(
            c, in, out, m_rows, k_depth, n_cols, n_chunks, stream);
    else if constexpr (sizeof(T) == 4)
        return launch_dense<T, 2, 4, 4, 4, 1, Order>(
            c, in, out, m_rows, k_depth, n_cols, n_chunks, stream);
    else
        return launch_dense<T, DenseF64::WM, DenseF64::WN, DenseF64::WMT,
                            DenseF64::WNT, DenseF64::MINB, Order>(
            c, in, out, m_rows, k_depth, n_cols, n_chunks, stream);
}

// (b') K2's f32 dense body on wgmma (the note at the top): a tile is BE
// elements (columns of in[b]) by BM points (rows of C), BK deep a stage
// of a ring of RING.  Warp group 2 produces, groups 0 and 1 consume 64
// elements each of every stage.
struct WgF32 {
    static constexpr int BE = 128, BM = 128, BK = 32, RING = 3;
    static constexpr int THREADS = 384;
    // in's tile as the TMA box writes it: BK rows of LDI elements, the
    // tile's BE and 8 more, so the rows lie 8 mod 32 banks apart and lanes
    // (g, t) of a fragment load (row t, column g) read banks 8t + g
    static constexpr int LDI = BE + 8;
    // a consumer group's staging, point rows of its 64 elements 4 mod 32
    // banks apart: lanes (g, t) write row 2t, column g, banks 8t + g
    static constexpr int LDO = BE / 2 + 4;
    // C's halves: core matrices of 8 points x 4 k (128 bytes), point group
    // pg of k group kg at kg * LBO + pg * SBO bytes; LBO is 16 bytes past
    // the group's BM * 16, so a warp's 4-byte stores of one point's 32 k
    // (lane = k) fall in 32 distinct banks
    static constexpr unsigned SBO = 128, LBO = BM * 16 + 16;
    static constexpr int HALF = BK / 4 * LBO / 4;      // floats
    static constexpr int STAGE = 2 * HALF + BK * LDI;  // floats
    static constexpr int STAGING = BM * LDO;           // floats a group
};

constexpr size_t wgmma_smem() {
    using W = WgF32;
    return sizeof(float) * (W::RING * W::STAGE + 2 * W::STAGING) +
           2 * W::RING * sizeof(unsigned long long);
}

// out[b] = c @ in[b] for every chunk b (f32; in by the tensor map in_map,
// its rows n_cols values; out 16-byte aligned, n_cols a multiple of 4),
// persistent blocks over the tiles in Order.
template <typename Order>
__global__ void __launch_bounds__(WgF32::THREADS, 1)
    dense_gemm_kernel_wgmma(const __grid_constant__ CUtensorMap in_map,
                            const float* __restrict__ c,
                            float* __restrict__ out, int m_rows, int k_depth,
                            int n_cols, int n_chunks) {
    using W = WgF32;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* smem = reinterpret_cast<float*>(smem_raw);
    auto* full = reinterpret_cast<unsigned long long*>(
        smem + W::RING * W::STAGE + 2 * W::STAGING);
    auto* empty = full + W::RING;
    const int m_tiles = (m_rows + W::BM - 1) / W::BM;
    const int e_tiles = (n_cols + W::BE - 1) / W::BE;
    const long long tiles =
        static_cast<long long>(n_chunks) * m_tiles * e_tiles;
    const int ksteps = (k_depth + W::BK - 1) / W::BK;
    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < W::RING; ++s) {
            // the producer's 128 threads and its byte count; the consumers'
            // 8 warps
            tbt::mbar_init(&full[s], 128 + 1);
            tbt::mbar_init(&empty[s], 8);
        }
        tbt::mbar_init_fence();
    }
    __syncthreads();

    if (wg == 2) {
        // The producer: thread 0 asks the TMA for in's tile (past K and
        // n_cols it fills zeros); warp w splits C's points 32w .. 32w + 31,
        // lane k of each, so a warp's load is one row's 128 contiguous
        // bytes and its 4-byte stores fall in 32 distinct banks.  C's
        // values are loaded before the stage is free, so their latency
        // hides behind the wait.
        tbt::setmaxnreg_dec<96>();
        const int p = threadIdx.x - 256, lane = p % 32, pw = p / 32;
        // lane's place in a half: k group lane / 4, slot lane % 4 of its
        // warp's first point
        const int put = (lane / 4) * (W::LBO / 4) + lane % 4 + pw * 32 * 4;
        long long i = 0;  // the block's stages so far
        for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            int mt, et;
            Order::tile(static_cast<unsigned>(tile), m_tiles, e_tiles, mt, et);
            const int chunk = static_cast<int>(
                tile / (static_cast<long long>(m_tiles) * e_tiles));
            const int m0 = mt * W::BM + pw * 32;
            const float* cw = c + static_cast<long long>(m0) * k_depth + lane;
            for (int s = 0; s < ksteps; ++s, ++i) {
                const int k0 = s * W::BK;
                const bool kin = k0 + lane < k_depth;
                // one pointer stepped a row: the loads in flight hold their
                // values, not 32 addresses
                const float* q = cw + k0;
                float v[32];
#pragma unroll
                for (int r = 0; r < 32; ++r) {
                    v[r] = kin && m0 + r < m_rows ? *q : 0.0f;
                    q += k_depth;
                }
                const int slot = static_cast<int>(i % W::RING);
                tbt::mbar_wait(&empty[slot],
                               static_cast<unsigned>((i / W::RING) & 1) ^ 1);
                float* st = smem + slot * W::STAGE;
                if (p == 0) {
                    tbt::mbar_expect_tx(&full[slot],
                                        sizeof(float) * W::BK * W::LDI);
                    tbt::tma_load_3d(st + 2 * W::HALF, &in_map, et * W::BE,
                                     k0, chunk, &full[slot]);
                }
                unsigned* half = reinterpret_cast<unsigned*>(st) + put;
#pragma unroll
                for (int r = 0; r < 32; ++r) {
                    unsigned big, small;
                    tbt::split_tf32(v[r], big, small);
                    half[r * 4] = big;
                    half[W::HALF + r * 4] = small;
                }
                tbt::fence_async_shared();
                tbt::mbar_arrive(&full[slot]);
            }
        }
    } else {
        tbt::setmaxnreg_inc<200>();
        const int ct = threadIdx.x % 128, q = ct / 32, lane = ct % 32;
        const int g = lane / 4, t = lane % 4;
        float* stg = smem + W::RING * W::STAGE + wg * W::STAGING;
        float acc[64], part[64];
        long long i = 0;
        for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            int mt, et;
            Order::tile(static_cast<unsigned>(tile), m_tiles, e_tiles, mt, et);
            const long long chunk = tile / (static_cast<long long>(m_tiles) *
                                            e_tiles);
#pragma unroll
            for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
            for (int s = 0; s < ksteps; ++s, ++i) {
                const int slot = static_cast<int>(i % W::RING);
                tbt::mbar_wait(&full[slot],
                               static_cast<unsigned>((i / W::RING) & 1));
                const float* st = smem + slot * W::STAGE;
                // A: lane (g, t)'s elements 16q + g (+ 8) of the group's,
                // k t (+ 4) of each 8-deep slice, each split once
                const float* xa =
                    st + 2 * W::HALF + t * W::LDI + wg * 64 + 16 * q + g;
                unsigned ab[W::BK / 8][4], as[W::BK / 8][4];
#pragma unroll
                for (int kk = 0; kk < W::BK / 8; ++kk) {
                    const float* x = xa + 8 * kk * W::LDI;
                    tbt::split_tf32(x[0], ab[kk][0], as[kk][0]);
                    tbt::split_tf32(x[8], ab[kk][1], as[kk][1]);
                    tbt::split_tf32(x[4 * W::LDI], ab[kk][2], as[kk][2]);
                    tbt::split_tf32(x[4 * W::LDI + 8], ab[kk][3], as[kk][3]);
                }
                const unsigned long long big =
                    tbt::wgmma_desc(st, W::LBO, W::SBO);
                const unsigned long long small =
                    tbt::wgmma_desc(st + W::HALF, W::LBO, W::SBO);
                // one BK-deep step summed alone (scale-d 0 first), then
                // added in round-to-nearest
#pragma unroll
                for (int kk = 0; kk < W::BK / 8; ++kk)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        tbt::reg_fence(ab[kk][j]);
                        tbt::reg_fence(as[kk][j]);
                    }
#pragma unroll
                for (int j = 0; j < 64; ++j) tbt::reg_fence(part[j]);
                tbt::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < W::BK / 8; ++kk) {
                    // the slice's two k groups: 2 * LBO bytes on
                    const unsigned long long off = (2 * kk * W::LBO) >> 4;
                    if (kk == 0)
                        tbt::wgmma_tf32_m64n128<0>(part, as[kk], big + off);
                    else
                        tbt::wgmma_tf32_m64n128<1>(part, as[kk], big + off);
                    tbt::wgmma_tf32_m64n128<1>(part, ab[kk], small + off);
                    tbt::wgmma_tf32_m64n128<1>(part, ab[kk], big + off);
                }
                tbt::wgmma_commit();
                tbt::wgmma_wait<0>();
#pragma unroll
                for (int j = 0; j < 64; ++j) tbt::reg_fence(part[j]);
                __syncwarp();
                if (lane == 0) tbt::mbar_arrive(&empty[slot]);
#pragma unroll
                for (int j = 0; j < 64; ++j) acc[j] += part[j];
            }
            // acc[4j + 2h + r] is element 16q + g + 8h, point 8j + 2t + r:
            // transposed through the staging, out by 16-byte stores along
            // the elements
            tbt::named_sync(1 + wg, 128);
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        stg[(8 * j + 2 * t + r) * W::LDO + 16 * q + g +
                            8 * h] = acc[4 * j + 2 * h + r];
            tbt::named_sync(1 + wg, 128);
            const int e = et * W::BE + wg * 64;
            float* y = out + chunk * m_rows * n_cols;
#pragma unroll 4
            for (int u = ct; u < W::BM * 16; u += 128) {
                const int pt = u / 16, v = (u % 16) * 4;
                const int m = mt * W::BM + pt;
                if (m < m_rows && e + v < n_cols) {
                    const float4 w =
                        *reinterpret_cast<const float4*>(stg + pt * W::LDO +
                                                         v);
                    __stcs(reinterpret_cast<float4*>(
                               y + static_cast<long long>(m) * n_cols + e +
                               v),
                           w);
                }
            }
        }
    }
}

// cuTensorMapEncodeTiled from the driver, looked up once (no link to
// libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
    static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                    cudaEnableDefault,
                                    &found) != cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            fn = nullptr;
        return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }();
    return encode;
}

template <typename Order>
int launch_dense_wgmma(const float* c, const float* in, float* out,
                       int m_rows, int k_depth, int n_cols, int n_chunks,
                       cudaStream_t stream) {
    using W = WgF32;
    if (n_cols % 4 != 0 || !tbt::aligned16(in) || !tbt::aligned16(out))
        return cudaErrorInvalidValue;
    // in as (n_chunks, K, n_cols), n_cols fastest; a box is one stage's
    // tile, BK rows of LDI values
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    CUtensorMap in_map;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n_cols),
                                static_cast<cuuint64_t>(k_depth),
                                static_cast<cuuint64_t>(n_chunks)};
    const cuuint64_t strides[2] = {
        sizeof(float) * static_cast<cuuint64_t>(n_cols),
        sizeof(float) * static_cast<cuuint64_t>(n_cols) * k_depth};
    const cuuint32_t box[3] = {W::LDI, W::BK, 1}, steps[3] = {1, 1, 1};
    if (encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
               const_cast<float*>(in), dims, strides, box, steps,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    constexpr size_t smem = wgmma_smem();
    static tbt::DeviceCache<> optin, waves;
    auto kernel = dense_gemm_kernel_wgmma<Order>;
    const cudaError_t err = tbt::optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    const long long full = tbt::wave_blocks(waves, kernel, W::THREADS, smem);
    if (full < 0) return static_cast<int>(-full);
    if (full == 0) return cudaErrorInvalidConfiguration;
    const long long tiles = static_cast<long long>(n_chunks) *
                            ((m_rows + W::BM - 1) / W::BM) *
                            ((n_cols + W::BE - 1) / W::BE);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<unsigned>(tiles < full ? tiles : full), W::THREADS,
             smem, stream>>>(in_map, c, out, m_rows, k_depth, n_cols,
                             n_chunks);
    return cudaGetLastError();
}

// strip 0: the dense configuration, on the mma.sync body (wgmma 0) or,
// f32 only, the wgmma body (wgmma 1); 64, 128, 256 or 512: C resident with
// that strip width; any other value is refused.
template <typename T>
int launch_kron_blocked(const T* c, const T* in, T* out, int m_rows,
                        int k_depth, int n_cols, int n_chunks, int strip,
                        int wgmma, cudaStream_t stream) {
    if (m_rows <= 0 || n_cols <= 0 || n_chunks <= 0) return cudaSuccess;
    if (k_depth <= 0 || (wgmma && strip != 0)) return cudaErrorInvalidValue;
    switch (strip) {
        case 0:
            if (wgmma) {
                if constexpr (sizeof(T) == 4)
                    return launch_dense_wgmma<MFast>(c, in, out, m_rows,
                                                     k_depth, n_cols,
                                                     n_chunks, stream);
                else
                    return cudaErrorInvalidValue;
            }
            return launch_dense_tiles<T, MFast>(c, in, out, m_rows, k_depth,
                                                n_cols, n_chunks, stream);
        case 64:
            return launch_resident<T, 64>(c, in, out, m_rows, k_depth, n_cols,
                                          n_chunks, stream);
        case 128:
            return launch_resident<T, 128>(c, in, out, m_rows, k_depth,
                                           n_cols, n_chunks, stream);
        case 256:
            return launch_resident<T, 256>(c, in, out, m_rows, k_depth,
                                           n_cols, n_chunks, stream);
        case 512:
            return launch_resident<T, 512>(c, in, out, m_rows, k_depth,
                                           n_cols, n_chunks, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// ---- K3 em_gemm -------------------------------------------------------------

// (a) S resident: 8 warps; a warp's unit is EM_ROWS x EM_COLS outputs, a
// thread's micro-tile EM_TE rows x EM_TN columns; tile heights 32..256.
constexpr int EM_THREADS = 256;
constexpr int EM_WARPS = EM_THREADS / 32;
constexpr int EM_RING = 2;
constexpr int EM_TE = 8, EM_TN = 8;
constexpr int EM_ROWS = 4 * EM_TE, EM_COLS = 8 * EM_TN;

template <typename T>
size_t em_resident_smem(int k_depth, int n_cols, int be) {
    return sizeof(T) *
           (static_cast<size_t>(k_depth) * round_up(n_cols, EM_COLS) +
            static_cast<size_t>(EM_RING) * be * k_depth);
}

template <typename T, int BE>
__global__ void __launch_bounds__(EM_THREADS)
    em_resident_kernel(const T* __restrict__ x, const T* __restrict__ s,
                       T* __restrict__ out, int e_rows, int k_depth,
                       int n_cols) {
    using A = tbt::Acc<T>;
    constexpr int V = 16 / sizeof(T);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int np = round_up(n_cols, EM_COLS), chunks = np / EM_COLS;
    T* s_s = reinterpret_cast<T*>(smem_raw);            // (K, np): S
    T* ring = s_s + static_cast<size_t>(k_depth) * np;  // RING x (BE, K)
    const int slot = BE * k_depth;
    const long long tiles = (static_cast<long long>(e_rows) + BE - 1) / BE;
    const long long total = static_cast<long long>(e_rows) * k_depth;
    // BE * K * sizeof(T) is a multiple of 16: every tile of an aligned X
    // starts on a 16-byte boundary
    const bool vec_x = tbt::aligned16(x);
    const bool vec_out =
        (static_cast<long long>(n_cols) * sizeof(T)) % 16 == 0 &&
        tbt::aligned16(out);

    // tile t (rows t*BE ..) into slot r, as one flat span
    auto load = [&](long long t, int r) {
        T* dst = ring + r * slot;
        const long long first = t * slot;
        const long long avail = total - first;  // values left in X
        if (vec_x) {
            for (int q = threadIdx.x; q < slot / V; q += EM_THREADS) {
                const long long left =
                    (avail - static_cast<long long>(q) * V) *
                    static_cast<long long>(sizeof(T));
                const int bytes =
                    left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
                tbt::cp_async16_bytes(dst + q * V,
                                      bytes ? x + first + q * V : x, bytes);
            }
        } else {
            for (int q = threadIdx.x; q < slot; q += EM_THREADS) {
                const bool ok = q < avail;
                tbt::cp_async<sizeof(T)>(dst + q, ok ? x + first + q : x, ok);
            }
        }
    };
    // the ring's first tiles are in flight while S is staged
#pragma unroll
    for (int i = 0; i < EM_RING - 1; ++i) {
        const long long t = blockIdx.x + static_cast<long long>(i) * gridDim.x;
        if (t < tiles) load(t, i);
        tbt::cp_async_commit();
    }
    for (int q = threadIdx.x; q < k_depth * np; q += EM_THREADS) {
        const int k = q / np, n = q % np;
        s_s[q] = n < n_cols ? s[static_cast<size_t>(k) * n_cols + n]
                            : tbt::narrow<T>(0);
    }

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int j = lane % 8, eg = lane / 8;
    int i = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        tbt::cp_async_wait<EM_RING - 2>();
        __syncthreads();  // tile i landed; slot (i - 1) % RING is free
        const long long next =
            t + static_cast<long long>(EM_RING - 1) * gridDim.x;
        if (next < tiles) load(next, (i + EM_RING - 1) % EM_RING);
        tbt::cp_async_commit();

        const T* xt = ring + (i % EM_RING) * slot;
        for (int u = warp; u < (BE / EM_ROWS) * chunks; u += EM_WARPS) {
            // rows r0 + 4r of the tile, columns c0 + p * 8V + (0 .. V-1)
            const int r0 = (u / chunks) * EM_ROWS + eg;
            const int c0 = (u % chunks) * EM_COLS + j * V;
            const T* xr = xt + r0 * k_depth;
            const T* sc = s_s + c0;
            A acc[EM_TE][EM_TN];
#pragma unroll
            for (int r = 0; r < EM_TE; ++r)
#pragma unroll
                for (int c = 0; c < EM_TN; ++c) acc[r][c] = A(0);
#pragma unroll 4
            for (int k = 0; k < k_depth; ++k) {
                A xv[EM_TE], sv[EM_TN];
#pragma unroll
                for (int r = 0; r < EM_TE; ++r)
                    xv[r] = tbt::widen(xr[4 * r * k_depth + k]);
#pragma unroll
                for (int p = 0; p < EM_TN / V; ++p)
                    tbt::load16(sc + k * np + p * 8 * V, sv + p * V);
#pragma unroll
                for (int r = 0; r < EM_TE; ++r)
#pragma unroll
                    for (int c = 0; c < EM_TN; ++c)
                        acc[r][c] = fma(xv[r], sv[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < EM_TE; ++r) {
                const long long e = t * BE + r0 + 4 * r;
                if (e >= e_rows) break;
                T* dst = out + e * n_cols;
#pragma unroll
                for (int p = 0; p < EM_TN / V; ++p) {
                    const int n = c0 + p * 8 * V;
                    if (vec_out && n + V <= n_cols) {
                        tbt::store16(dst + n, acc[r] + p * V);
                    } else {
#pragma unroll
                        for (int v = 0; v < V; ++v)
                            if (n + v < n_cols)
                                dst[n + v] = tbt::narrow<T>(acc[r][p * V + v]);
                    }
                }
            }
        }
    }
}

template <typename T, int BE>
int launch_em_resident(const T* x, const T* s, T* out, int e_rows,
                       int k_depth, int n_cols, cudaStream_t stream) {
    static tbt::DeviceCache<> optin, waves;
    const size_t smem = em_resident_smem<T>(k_depth, n_cols, BE);
    auto kernel = em_resident_kernel<T, BE>;
    const cudaError_t err = tbt::optin_smem(optin, kernel);
    if (err != cudaSuccess) return err;
    const long long full = tbt::wave_blocks(waves, kernel, EM_THREADS, smem);
    if (full < 0) return static_cast<int>(-full);
    if (full == 0) return cudaErrorInvalidConfiguration;
    const long long tiles = (static_cast<long long>(e_rows) + BE - 1) / BE;
    kernel<<<static_cast<unsigned>(tiles < full ? tiles : full), EM_THREADS,
             smem, stream>>>(x, s, out, e_rows, k_depth, n_cols);
    return cudaGetLastError();
}

// tile 0: the dense configuration; 32, 64, 128 or 256: S resident with
// that tile height; any other value is refused.
template <typename T>
int launch_em_gemm(const T* x, const T* s, T* out, int e_rows, int k_depth,
                   int n_cols, int tile, cudaStream_t stream) {
    if (e_rows <= 0 || n_cols <= 0) return cudaSuccess;
    if (k_depth < 0) return cudaErrorInvalidValue;
    switch (tile) {
        case 0:
            return launch_dense_tiles<T, NFast>(x, s, out, e_rows, k_depth,
                                                n_cols, 1, stream);
        case 32:
            return launch_em_resident<T, 32>(x, s, out, e_rows, k_depth,
                                             n_cols, stream);
        case 64:
            return launch_em_resident<T, 64>(x, s, out, e_rows, k_depth,
                                             n_cols, stream);
        case 128:
            return launch_em_resident<T, 128>(x, s, out, e_rows, k_depth,
                                              n_cols, stream);
        case 256:
            return launch_em_resident<T, 256>(x, s, out, e_rows, k_depth,
                                              n_cols, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// K2's C-resident configuration's shared memory for an M x K operator of
// itemsize-byte values at strip width bn.
extern "C" long long tbt_kron_resident_smem(int itemsize, int m_rows,
                                            int k_depth, int bn) {
    switch (itemsize) {
        case 2:
            return static_cast<long long>(
                kron_resident_smem<tbt::bf16>(m_rows, k_depth, bn));
        case 4:
            return static_cast<long long>(
                kron_resident_smem<float>(m_rows, k_depth, bn));
        default:
            return static_cast<long long>(
                kron_resident_smem<double>(m_rows, k_depth, bn));
    }
}

extern "C" int tbt_kron_blocked_f32(const void* c, const void* in, void* out,
                                    int m_rows, int k_depth, int n_cols,
                                    int n_chunks, int strip, int wgmma,
                                    void* stream) {
    return launch_kron_blocked(
        static_cast<const float*>(c), static_cast<const float*>(in),
        static_cast<float*>(out), m_rows, k_depth, n_cols, n_chunks, strip,
        wgmma, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_kron_blocked_f64(const void* c, const void* in, void* out,
                                    int m_rows, int k_depth, int n_cols,
                                    int n_chunks, int strip, int wgmma,
                                    void* stream) {
    return launch_kron_blocked(
        static_cast<const double*>(c), static_cast<const double*>(in),
        static_cast<double*>(out), m_rows, k_depth, n_cols, n_chunks, strip,
        wgmma, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_kron_blocked_bf16(const void* c, const void* in,
                                     void* out, int m_rows, int k_depth,
                                     int n_cols, int n_chunks, int strip,
                                     int wgmma, void* stream) {
    return launch_kron_blocked(
        static_cast<const tbt::bf16*>(c), static_cast<const tbt::bf16*>(in),
        static_cast<tbt::bf16*>(out), m_rows, k_depth, n_cols, n_chunks,
        strip, wgmma, static_cast<cudaStream_t>(stream));
}

// The f64 dense configuration's shared memory of a block (both orders).
extern "C" long long tbt_dense_f64_smem() {
    using F = DenseF64;
    return static_cast<long long>(
        kron_dense_smem<double, F::WM * F::WMT * Dense<double>::MMA_M,
                        F::WN * F::WNT * 8>());
}

// The f32 wgmma body's shared memory of a block.
extern "C" long long tbt_dense_wgmma_smem() {
    return static_cast<long long>(wgmma_smem());
}

// K3's S-resident configuration's shared memory for an S of K x N
// itemsize-byte values at tile height be.
extern "C" long long tbt_em_resident_smem(int itemsize, int k_depth,
                                          int n_cols, int be) {
    switch (itemsize) {
        case 2:
            return static_cast<long long>(
                em_resident_smem<tbt::bf16>(k_depth, n_cols, be));
        case 4:
            return static_cast<long long>(
                em_resident_smem<float>(k_depth, n_cols, be));
        default:
            return static_cast<long long>(
                em_resident_smem<double>(k_depth, n_cols, be));
    }
}

extern "C" int tbt_em_gemm_f32(const void* x, const void* s, void* out,
                               int e_rows, int k_depth, int n_cols, int tile,
                               void* stream) {
    return launch_em_gemm(static_cast<const float*>(x),
                          static_cast<const float*>(s),
                          static_cast<float*>(out), e_rows, k_depth, n_cols,
                          tile, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_em_gemm_f64(const void* x, const void* s, void* out,
                               int e_rows, int k_depth, int n_cols, int tile,
                               void* stream) {
    return launch_em_gemm(static_cast<const double*>(x),
                          static_cast<const double*>(s),
                          static_cast<double*>(out), e_rows, k_depth, n_cols,
                          tile, static_cast<cudaStream_t>(stream));
}

extern "C" int tbt_em_gemm_bf16(const void* x, const void* s, void* out,
                                int e_rows, int k_depth, int n_cols, int tile,
                                void* stream) {
    return launch_em_gemm(static_cast<const tbt::bf16*>(x),
                          static_cast<const tbt::bf16*>(s),
                          static_cast<tbt::bf16*>(out), e_rows, k_depth,
                          n_cols, tile, static_cast<cudaStream_t>(stream));
}
