// Helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tbt {

// Four consecutive values from 16-byte aligned shared memory in 16-byte
// loads: one for float, two for double.
__device__ __forceinline__ void load4(const float* p, float* r) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double* r) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    r[0] = a.x;
    r[1] = a.y;
    r[2] = b.x;
    r[3] = b.y;
}

// Four consecutive values to 16-byte aligned (shared or global) memory in
// 16-byte stores.
__device__ __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// The 16-byte vector of a type: four floats or two doubles.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
    using type = float4;
    static constexpr int width = 4;
};
template <>
struct Vec16<double> {
    using type = double2;
    static constexpr int width = 2;
};

// One 16-byte vector (Vec16<T>::width values) from or to 16-byte aligned
// memory.
__device__ __forceinline__ void load16(const float* p, float* r) {
    load4(p, r);
}

__device__ __forceinline__ void load16(const double* p, double* r) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    r[0] = a.x;
    r[1] = a.y;
}

__device__ __forceinline__ void store16(float* p, const float* v) {
    store4(p, v);
}

__device__ __forceinline__ void store16(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// W consecutive values (one 16-byte vector: W = 16 / sizeof(T); or W = 1,
// one value) from global memory by a plain load.
__device__ __forceinline__ void load_w(const float* p, float (&r)[4]) {
    load4(p, r);
}

__device__ __forceinline__ void load_w(const double* p, double (&r)[2]) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    r[0] = q.x;
    r[1] = q.y;
}

template <typename T>
__device__ __forceinline__ void load_w(const T* p, T (&r)[1]) {
    r[0] = *p;
}

// The same W values to global memory that nothing reads again, with the
// streaming hint (st.global.cs: evict first), so they do not push out of
// L2 the lines that are read again.
__device__ __forceinline__ void store_cs(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store_cs(double* p, const double (&v)[2]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

template <typename T>
__device__ __forceinline__ void store_cs(T* p, const T (&v)[1]) {
    __stcs(p, v[0]);
}

// Elements of p[0:n] before the first 16-byte boundary at or after p: the
// scalar head of a vector loop (0 when p is aligned).  Tensors are aligned
// to their element size, so the count is exact.
template <typename T>
__host__ __device__ __forceinline__ long long head_elems(const T* p,
                                                         long long n) {
    const unsigned mis = reinterpret_cast<uintptr_t>(p) & 15u;
    const long long h = mis ? (16 - mis) / sizeof(T) : 0;
    return h < n ? h : n;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// f applied lane by lane to one or two 16-byte vectors.
template <typename F>
__device__ __forceinline__ float4 map_lanes(F f, float4 a, float4 b) {
    return make_float4(f(a.x, b.x), f(a.y, b.y), f(a.z, b.z), f(a.w, b.w));
}

template <typename F>
__device__ __forceinline__ double2 map_lanes(F f, double2 a, double2 b) {
    return make_double2(f(a.x, b.x), f(a.y, b.y));
}

// Sum over the lanes of f(lane, c).
template <typename F>
__device__ __forceinline__ float fold_lanes(F f, float4 a, float c) {
    return (f(a.x, c) + f(a.y, c)) + (f(a.z, c) + f(a.w, c));
}

template <typename F>
__device__ __forceinline__ double fold_lanes(F f, double2 a, double c) {
    return f(a.x, c) + f(a.y, c);
}

// acc + the lane-wise dot product of a and b.
__device__ __forceinline__ float dot_lanes(float4 a, float4 b, float acc) {
    acc = fma(a.x, b.x, acc);
    acc = fma(a.y, b.y, acc);
    acc = fma(a.z, b.z, acc);
    return fma(a.w, b.w, acc);
}

__device__ __forceinline__ double dot_lanes(double2 a, double2 b,
                                            double acc) {
    acc = fma(a.x, b.x, acc);
    return fma(a.y, b.y, acc);
}

// acc[v] += lane v of a times c.
__device__ __forceinline__ void fma_lanes(float4 a, float c, float* acc) {
    acc[0] = fma(a.x, c, acc[0]);
    acc[1] = fma(a.y, c, acc[1]);
    acc[2] = fma(a.z, c, acc[2]);
    acc[3] = fma(a.w, c, acc[3]);
}

__device__ __forceinline__ void fma_lanes(double2 a, double c, double* acc) {
    acc[0] = fma(a.x, c, acc[0]);
    acc[1] = fma(a.y, c, acc[1]);
}

// Sum of v over the 32 lanes of a warp, in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, offset);
    return v;
}

// ---- Asynchronous copies and tensor-core fragments (sm_80 and later) ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8 or 16) from global src to shared dst without passing through
// registers; with valid false nothing is read and dst is zero-filled.  src
// must be a readable address even then (the caller passes a base pointer).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
    const int src_bytes = valid ? BYTES : 0;
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src), "n"(BYTES), "r"(src_bytes));
}

// The first `bytes` (0..16) of 16 bytes from global src to shared dst, the
// rest zero-filled: the ragged end of a flat span.  Both 16-byte aligned.
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src,
                                                 int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// rows x COLS values of a row-major global matrix (row stride ld_g), from
// (r0, c0), into shared memory of row stride ld_s by cp.async, the NTH
// threads of a block taking every NTH-th copy; zero past n_rows and
// n_cols.  vec: 16-byte copies, for rows of whole 16-byte words with c0 and
// COLS multiples of a word (so a word is wholly in or out); else one value
// a copy.
template <typename T, int COLS, int NTH>
__device__ __forceinline__ void copy_tile_async(
    T* dst, int ld_s, int rows, const T* __restrict__ src, long long ld_g,
    long long r0, long long c0, long long n_rows, long long n_cols,
    bool vec) {
    constexpr int V = 16 / sizeof(T);
    if (vec) {
        for (int q = threadIdx.x; q < rows * (COLS / V); q += NTH) {
            const int r = q / (COLS / V), c = (q % (COLS / V)) * V;
            const bool ok = r0 + r < n_rows && c0 + c < n_cols;
            cp_async<16>(dst + r * ld_s + c,
                         ok ? src + (r0 + r) * ld_g + c0 + c : src, ok);
        }
    } else {
        for (int q = threadIdx.x; q < rows * COLS; q += NTH) {
            const int r = q / COLS, c = q % COLS;
            const bool ok = r0 + r < n_rows && c0 + c < n_cols;
            cp_async<sizeof(T)>(dst + r * ld_s + c,
                                ok ? src + (r0 + r) * ld_g + c0 + c : src,
                                ok);
        }
    }
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lanes 8j..8j+7 give the row
// addresses of matrix j, and register j receives row lane/4, columns
// 2*(lane%4) and +1 of it (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) @ b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a = big + small for 3xTF32: big is a rounded to TF32 (10 stored mantissa
// bits) to nearest, ties away, by adding half of the 13 dropped bits' range
// and clearing them; small = a - big exactly, whose low 13 bits the tensor
// cores ignore, which truncates it to TF32.  Two integer operations and a
// subtraction: on the H100 a split by cvt.rna.tf32.f32 cost more than the
// mma it feeds.  A NaN in a stays a NaN in small.
__device__ __forceinline__ void split_tf32(float a, unsigned& big,
                                           unsigned& small) {
    big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(a - __uint_as_float(big));
}

// d (16x8 f32) += a (16x8 tf32, row) @ b (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (8x8 f64) += a (8x4 f64, row) @ b (4x8 f64, col): IEEE FP64 FMA on the
// tensor cores (DMMA).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
        "{%3}, {%0, %1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a), "d"(b));
}

}  // namespace tbt
